// K2: fused high-frequency artifact stem for sm_90a.
//
// Replaces: lipsync_tpu/ops/pallas/hf_stem.py::hf_stem_fused (kernel body
// built by _make_kernel): relu(BN_eval(Conv3d 3->32, k 3x3x3, stride
// (1,2,2), zero pad 1, applied to the per-frame 3x3 pad-1 Laplacian of the
// clip, a full 3->3 channel mix) + b1), with BN and b1 folded into one
// scale and shift per channel.
//
// What bounds it on an H100: at B=16 windows of 32x96x96x3 it moves ~208 MB
// in fp32 (104 MB in bf16), most of it the store of the 32-channel output,
// and does ~7 GFLOP, nearly all of it conv1. On the tensor cores (TF32) the
// operations take a fraction of the bytes' time, so it is bound by bytes:
// the Laplacian never touches device memory, every input frame is read once
// per spatial tile (plus a thin halo) and the output is written once.
//
// Design. A block owns one clip, one 16x16 tile of output pixels and a run
// of consecutive output frames (the wrapper picks the run length so that
// the grid fills the card). It walks the run's input frames forward:
//   1. the frame's 35x35x3 input patch is copied into shared memory as
//      16-byte cp.async chunks of whole pixel rows (the three channels are
//      contiguous), into a double buffer: frame t+1 loads while frame t
//      computes;
//   2. its 3->3 Laplacian at the 33x33 positions that the stride-2 taps
//      read is computed once (fp32 FMA) into a ring of three Laplacian
//      frames, zero outside the frame and for frames outside [0, T)
//      (conv1's zero padding applies to the Laplacian);
//   3. conv1 of the output frame whose three inputs are in the ring is an
//      implicit GEMM on the tensor cores: M = 16 pixels of one output row,
//      N = 32 channels, K = 3 frames x 32 (27 taps + 5 zero rows), with
//      mma.sync m16n8k8 TF32. A fragments are read straight from the ring
//      (stored in even/odd column phases, so the stride-2 taps are unit
//      stride; the row and plane pitches keep the reads nearly free of bank
//      conflicts); B is w1, split into TF32 hi and lo parts and placed in
//      fragment order in shared memory by the block's prologue (the order
//      of ops/kernels/hf_stem.py::pack_w1), resident for the whole block.
//      The 3xTF32 split (a_lo*b_hi + a_hi*b_lo + a_hi*b_hi) keeps fp32
//      accuracy. Each input frame's taps accumulate in fresh registers
//      that are then added in fp32, which keeps the tensor core's
//      accumulation chains short;
//   4. scale, shift and ReLU in registers; each warp stages its output row
//      in shared memory and stores it as contiguous 16-byte runs in the
//      input dtype.
// 8 warps, two output rows each (one after the other); ~108 KB of shared
// memory and <= 128 registers, so two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 3;        // input channels
constexpr int kCo = 32;      // conv1 output channels
constexpr int kTileO = 16;   // output tile edge
constexpr int kLap = 2 * kTileO + 1;   // 33 Laplacian positions per edge
constexpr int kIn = kLap + 2;          // 35 input positions per edge
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kLapPhase = 17;     // even columns 0..32 -> 0..16, odd -> 17..32
constexpr int kLapRow = 40;       // floats per Laplacian row
constexpr int kLapPlane = 1336;   // floats per Laplacian channel
constexpr int kLapSlot = kC * kLapPlane;
constexpr int kTaps = 27;         // (dx, dy, ci) of one input frame
constexpr int kKSteps = 12;       // K = 3 x 32 in steps of 8
constexpr int kPackFloats = kKSteps * 4 * 32 * 4;
constexpr int kStageRow = 36;     // floats per staged output pixel
constexpr int kStageWarp = kTileO * kStageRow;

// Two input buffers (raw rows of the input dtype, at most 35 x 448 bytes);
// the one the Laplacian has just read doubles as the output stage.
constexpr int kBufFloats = kWarps * kStageWarp;  // 4608 >= 35 * 448 / 4
constexpr int kRingOff = 0;
constexpr int kBufOff = kRingOff + 3 * kLapSlot;
constexpr int kPackOff = kBufOff + 2 * kBufFloats;
constexpr int kWlapOff = kPackOff + kPackFloats;
constexpr int kScaleOff = kWlapOff + kTaps * 4;
constexpr int kSmemFloats = kScaleOff + 2 * kCo;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kBufOff % 4 == 0 && kPackOff % 4 == 0 && kWlapOff % 4 == 0,
              "16-byte aligned regions");
static_assert(kIn * 448 <= kBufFloats * 4, "input rows fit a buffer");
static_assert(kPackFloats % (4 * kThreads) == 0, "whole packing rounds");

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Bits = uint32_t;
  static constexpr int kVec = 4;  // elements per 16 bytes
  __device__ static float get(const Bits* p) { return __uint_as_float(*p); }
  // 4 outputs -> one 16-byte store
  __device__ static void store(float* dst, const float* s) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(s);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float get(const Bits* p) {
    return __uint_as_float(static_cast<uint32_t>(*p) << 16);
  }
  __device__ static void store(__nv_bfloat16* dst, const float* s) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
hf_stem_kernel(const T* __restrict__ x,            // (B, T, H, W, 3)
               const float* __restrict__ wlap,     // (co, ci, 3, 3)
               const float* __restrict__ w1,       // (co, ci, 3, 3, 3)
               const float* __restrict__ scale,    // (32,)
               const float* __restrict__ shift,    // (32,)
               T* __restrict__ out,                // (B, T, Ho, Wo, 32)
               int n_frames, int h, int w, int ho, int wo, int tiles_x,
               int run, int runs, int vec) {
  using E = Elem<T>;
  using Bits = typename E::Bits;
  constexpr int kVec = E::kVec;
  // 16-byte chunks per staged row: the patch's 105 elements plus up to
  // kVec - 1 before it, from the aligned chunk that holds its first one.
  constexpr int kChunks = (kVec - 1 + kIn * kC + kVec - 1) / kVec;
  constexpr int kRowE = kChunks * kVec;  // elements per staged row
  constexpr int kItems = kIn * kChunks;

  extern __shared__ __align__(16) float smem[];
  float* ring = smem + kRingOff;    // [slot][ci][33][kLapRow] (phased cols)
  const float4* pack = reinterpret_cast<const float4*>(smem + kPackOff);
  const float4* wlap4 = reinterpret_cast<const float4*>(smem + kWlapOff);
  const float* scs = smem + kScaleOff;
  const float* shs = scs + kCo;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int clip = blockIdx.y / runs;
  const int t0 = (blockIdx.y % runs) * run;
  const int n_out = min(run, n_frames - t0);
  const int oy0 = (blockIdx.x / tiles_x) * kTileO;
  const int ox0 = (blockIdx.x % tiles_x) * kTileO;

  // Input patch position (r, c) is frame position (2*oy0-2+r, 2*ox0-2+c).
  // A staged row starts at the 16-byte chunk that holds the patch's first
  // element; patch element e of a row sits at `shift_in + e`.
  const int rowlen = w * kC;
  const int start = (2 * ox0 - 2) * kC;
  const int shift_in = ((start % kVec) + kVec) % kVec;
  const int s0 = start - shift_in;
  const int row0 = 2 * oy0 - 2;
  const size_t frame_elems = static_cast<size_t>(h) * rowlen;
  const Bits* xc = reinterpret_cast<const Bits*>(x) +
                   static_cast<size_t>(clip) * n_frames * frame_elems;
  auto buffer = [&](int l) {
    return reinterpret_cast<Bits*>(smem + kBufOff + (l & 1) * kBufFloats);
  };

  // Stage input frame f (valid) into buffer l & 1: 16-byte cp.async chunks
  // (zero-filled outside the frame) where rows allow it, else plain loads.
  auto stage_frame = [&](int f, int l) {
    const Bits* xf = xc + static_cast<size_t>(f) * frame_elems;
    Bits* dst = buffer(l);
    for (int it = tid; it < kItems; it += kThreads) {
      const int r = it / kChunks, q = it % kChunks;
      const int fr = row0 + r;
      const int e0 = s0 + q * kVec;
      Bits* d = dst + r * kRowE + q * kVec;
      const bool row_ok = fr >= 0 && fr < h;
      const Bits* rp = xf + static_cast<size_t>(row_ok ? fr : 0) * rowlen;
      if (vec) {
        const bool ok = row_ok && e0 >= 0 && e0 + kVec <= rowlen;
        cp_async16(d, ok ? rp + e0 : xf, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int e = e0 + i;
          d[i] = (row_ok && e >= 0 && e < rowlen) ? rp[e] : Bits(0);
        }
      }
    }
    asm volatile("cp.async.commit_group;");
  };

  // Per thread: offsets of the taps it feeds into A, k = 8j + tig (+4).
  // Tap order within a frame: k = (dx*3 + dy)*3 + ci; k >= 27 multiplies a
  // zero row of the packed w1 and points at tap 24 so that it stays finite.
  int koff[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int k = 8 * j + tig + 4 * hh;
      if (k >= kTaps) k = 24;
      const int dx = k / 9, dy = (k / 3) % 3, ci = k % 3;
      koff[j][hh] = ci * kLapPlane + dy * kLapRow + (dx & 1) * kLapPhase +
                    (dx >> 1);
    }
  }

  const int lr0 = 2 * oy0 - 1, lc0 = 2 * ox0 - 1;
  const int n_in = n_out + 2;
  if (t0 - 1 >= 0) stage_frame(t0 - 1, 0);

  // The prologue runs while the first frame loads; the loop's first
  // barrier publishes it.
  {
    // w1 as the (96, 32) GEMM operand: row k = dt*32 + (dx*3 + dy)*3 + ci
    // (rows 27-31 of each frame zero), split into TF32 hi and lo parts.
    // Entry [ks][nt][lane] holds hi[k0][n], hi[k0+4][n], lo[k0][n],
    // lo[k0+4][n] for k0 = 8*ks + tig, n = 8*nt + g, lane = 4*g + tig.
    auto w1_at = [&](int k, int n) {
      const int dt = k >> 5, kk = k & 31;
      if (kk >= kTaps) return 0.f;
      const int dx = kk / 9, dy = (kk / 3) % 3, ci = kk % 3;
      return w1[(n * kC + ci) * 27 + dt * 9 + dy * 3 + dx];
    };
    float4* p = reinterpret_cast<float4*>(smem + kPackOff);
#pragma unroll
    for (int r = 0; r < kPackFloats / 4 / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int ks = i >> 7, nt = (i >> 5) & 3, ln = i & 31;
      const int k0 = 8 * ks + (ln & 3), n = 8 * nt + (ln >> 2);
      const float v0 = w1_at(k0, n), v1 = w1_at(k0 + 4, n);
      const float h0 = __uint_as_float(to_tf32(v0));
      const float h1 = __uint_as_float(to_tf32(v1));
      p[i] = make_float4(h0, h1, __uint_as_float(to_tf32(v0 - h0)),
                         __uint_as_float(to_tf32(v1 - h1)));
    }
    // Laplacian tap (dy, dx, ci) -> its three output channels.
    float* wl = smem + kWlapOff;
    if (tid < kTaps) {
      const int dy = tid / 9, dx = (tid / 3) % 3, ci = tid % 3;
#pragma unroll
      for (int co = 0; co < kC; ++co) {
        wl[4 * tid + co] = wlap[((co * kC + ci) * 3 + dy) * 3 + dx];
      }
      wl[4 * tid + 3] = 0.f;
    }
    if (tid < kCo) {
      smem[kScaleOff + tid] = scale[tid];
      smem[kScaleOff + kCo + tid] = shift[tid];
    }
  }

  for (int l = 0; l < n_in; ++l) {
    const int f = t0 - 1 + l;
    const bool frame_ok = f >= 0 && f < n_frames;
    asm volatile("cp.async.wait_all;" ::: "memory");
    // Frame f has landed; the previous output stage and ring reads are done.
    __syncthreads();
    if (l + 1 < n_in && f + 1 < n_frames) stage_frame(f + 1, l + 1);

    const Bits* in = buffer(l);
    float* slot = ring + (l % 3) * kLapSlot;
    for (int p = tid; p < kLap * kLap; p += kThreads) {
      // An opaque zero keeps the 27 weight loads inside the loop: hoisted,
      // they would hold 81 registers through it.
      int zero;
      asm volatile("mov.b32 %0, 0;" : "=r"(zero));
      const float4* wl = wlap4 + zero;
      const int i = p / kLap, j = p % kLap;
      const int r = lr0 + i, q = lc0 + j;
      float l0 = 0.f, l1 = 0.f, l2 = 0.f;
      if (frame_ok && r >= 0 && r < h && q >= 0 && q < w) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const Bits* src = in + (i + dy) * kRowE + shift_in + (j + dx) * kC;
#pragma unroll
            for (int ci = 0; ci < kC; ++ci) {
              const float v = E::get(src + ci);
              const float4 wv = wl[(dy * 3 + dx) * kC + ci];
              l0 = fmaf(v, wv.x, l0);
              l1 = fmaf(v, wv.y, l1);
              l2 = fmaf(v, wv.z, l2);
            }
          }
        }
      }
      const int o = i * kLapRow + (j & 1) * kLapPhase + (j >> 1);
      slot[o] = l0;
      slot[kLapPlane + o] = l1;
      slot[2 * kLapPlane + o] = l2;
    }
    __syncthreads();
    if (l < 2) continue;

    // conv1 of output frame f - 1 from ring slots (l-2, l-1, l) % 3, one
    // output row (M tile) of the warp at a time, then its epilogue through
    // the warp's stage in the buffer the Laplacian has read (pixel p,
    // channel c at stage[p * kStageRow + c]).
    float* stage = reinterpret_cast<float*>(buffer(l)) + warp * kStageWarp;
    const int n_x = min(kTileO, wo - ox0);
    const size_t bt = static_cast<size_t>(clip) * n_frames + (f - 1);
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1  // unrolled, the frames' loads would spill
      for (int dt = 0; dt < 3; ++dt) {
        const float* am = ring + ((l - 2 + dt) % 3) * kLapSlot +
                          (4 * warp + 2 * m) * kLapRow + g;
        float part[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a[4] = {am[koff[j][0]], am[koff[j][0] + 8],
                              am[koff[j][1]], am[koff[j][1] + 8]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[e] = to_tf32(a[e]);
            alo[e] = to_tf32(a[e] - __uint_as_float(ahi[e]));
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float4 bq = pack[((dt * 4 + j) * 4 + n) * 32 + lane];
            const uint32_t bh0 = __float_as_uint(bq.x);
            const uint32_t bh1 = __float_as_uint(bq.y);
            mma_tf32(part[n], alo, bh0, bh1);
            mma_tf32(part[n], ahi, __float_as_uint(bq.z),
                     __float_as_uint(bq.w));
            mma_tf32(part[n], ahi, bh0, bh1);
          }
        }
        // Each input frame's taps are summed apart and added in fp32: the
        // tensor cores' accumulation chains stay 12 products long.
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }

#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = 8 * n + 2 * tig;
        const float sc0 = scs[c], sc1 = scs[c + 1];
        const float sh0 = shs[c], sh1 = shs[c + 1];
        *reinterpret_cast<float2*>(stage + g * kStageRow + c) = make_float2(
            fmaxf(fmaf(acc[n][0], sc0, sh0), 0.f),
            fmaxf(fmaf(acc[n][1], sc1, sh1), 0.f));
        *reinterpret_cast<float2*>(stage + (g + 8) * kStageRow + c) =
            make_float2(fmaxf(fmaf(acc[n][2], sc0, sh0), 0.f),
                        fmaxf(fmaf(acc[n][3], sc1, sh1), 0.f));
      }
      __syncwarp();
      const int oy = oy0 + 2 * warp + m;
      if (oy < ho) {
        T* orow = out + ((bt * ho + oy) * wo + ox0) * kCo;
        for (int e = lane * kVec; e < n_x * kCo; e += 32 * kVec) {
          E::store(orow + e, stage + (e / kCo) * kStageRow + e % kCo);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch(const void* x, const float* wlap, const float* w1,
           const float* scale, const float* shift, void* out, int batch,
           int n_frames, int h, int w, int ho, int wo, int run,
           cudaStream_t stream) {
  auto kernel = hf_stem_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (wo + kTileO - 1) / kTileO;
  const int tiles_y = (ho + kTileO - 1) / kTileO;
  const int runs = (n_frames + run - 1) / run;
  const int vec = (w * kC) % Elem<T>::kVec == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(tiles_x * tiles_y, batch * runs);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), wlap, w1, scale, shift, static_cast<T*>(out), n_frames, h, w, ho, wo, tiles_x,
      run, runs, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, n_frames, h, w, 3) channels-last, fp32 (dtype 0) or bf16
// (dtype 1); wlap: (3, 3, 3, 3) Conv2d weight (OIHW); w1: (32, 3, 3, 3, 3)
// Conv3d weight (OITHW); scale, shift: (32,) folded BN; out: (batch,
// n_frames, ho, wo, 32) in the dtype of x, 16-byte aligned; run: output
// frames per block. Weights are fp32. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for an unknown dtype or run < 1.
extern "C" int lipsync_hf_stem(const void* x, int dtype, const float* wlap,
                               const float* w1, const float* scale,
                               const float* shift, void* out, int batch,
                               int n_frames, int h, int w, int ho, int wo,
                               int run, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (run < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch<float>(x, wlap, w1, scale, shift, out, batch, n_frames, h,
                         w, ho, wo, run, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, wlap, w1, scale, shift, out, batch,
                                 n_frames, h, w, ho, wo, run, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the dtype's kernel that fit on one SM at once, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on error.
extern "C" int lipsync_hf_stem_blocks_per_sm(int dtype) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto query = [&](auto kernel) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kThreads, kSmemBytes);
    }
  };
  if (dtype == 0) query(hf_stem_kernel<float>);
  if (dtype == 1) query(hf_stem_kernel<__nv_bfloat16>);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
