// K6: an fp32-accurate 3-D convolution on the TF32 tensor cores for sm_90a,
// with eval BatchNorm, the residual and ReLU in its epilogue.
//
// Replaces: no TPU kernel. The JAX package leaves the visual encoder's fp32
// 3x3x3 convolutions to XLA (lipsync_tpu/models/layers.py::ConvBNAct inside
// ResidualBlockND); the port ran them on cuDNN's fp32 implicit GEMM, which
// with TF32 off (the served configuration's fp32) takes the SIMT lanes
// (67 TFLOP/s) at about half their rate. K6 runs them on the tensor cores
// with the 3xTF32 split, a = a_hi + a_lo with each half a TF32 value
// (cvt.rna), a * b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi in fp32 sums: fp32's
// accuracy at an effective 495 / 3 TFLOP/s. ops/kernels/conv3d_tf32x3.py
// says when the model takes it.
//
// What bounds it on an H100: at the bulk group of 256 windows visual
// layer1's 3x3x3 64 -> 64 convolution is M = 256 x 32 x 24 x 24 = 4.72 M
// output positions, N = 64, K = 27 x 64 = 1728: 1.04 TFLOP of fp32 work,
// 3.1 TFLOP on the TF32 tensor cores (6.3 ms at 495 TFLOP/s), against 1.2
// GB in and out (0.7 ms at 3.35 TB/s). The operands reach shared memory
// from L2 by a gather: each of the 27 taps fetches its own copy of A's
// rows, so a tile of 128 x 64 outputs pulls 0.9 MB of A and 0.9 MB of B
// (hi and lo) through L2 for 14 M multiply-adds, and L2's bandwidth is the
// second wall. The design keeps the tensor cores fed from a deep ring:
//
//   - The GEMM: M = output positions of the channels-last output, N =
//     C_out in tiles of 64, K = taps x C_in ordered (kt, kh, kw, c), c
//     fastest, in steps of 32 channels of one tap (128 bytes a row).
//   - A persistent block (one per SM, 384 threads) walks tiles of 128
//     output rows by 64 channels. Warpgroup 0 is the producer: each of
//     its threads issues 16-byte cp.async copies of A (straight from the
//     NDHWC activations, zero-filled outside the input: the convolution's
//     padding) and of B (hi and lo, packed once per module by the wrapper)
//     into a ring of stages, 128-byte-swizzled and K-major (chunk j of row
//     r at r * 128 + ((j ^ (r & 7)) << 4)), and arrives on the stage's
//     "full" mbarrier when its copies land (cp.async.mbarrier.arrive).
//     The producer runs ahead across tile boundaries, so one tile's
//     epilogue overlaps the next tile's loads.
//   - Warpgroups 1 and 2 are consumers, 64 rows of the tile each. A
//     consumer waits on a stage's full barrier, reads its A fragments with
//     16-byte shared loads, splits each value into TF32 hi and lo once, and
//     issues wgmma.mma_async m64n64k8 .tf32 with A from registers and B
//     (hi, lo) from shared memory: three products a k8 step. The K order
//     inside each 32-wide step is permuted (the wrapper's `k_order`) so
//     that a thread's eight A values of a step are two 16-byte loads. A
//     stage is issued as two commit groups with their own A registers, so
//     the second half's loads and splits run while the first multiplies;
//     the two consumers run apart, each multiplying while the other adds
//     or waits. A stage goes back to the producer (the "empty" mbarrier)
//     once its products have completed.
//   - The tensor cores round each wgmma's sum toward zero, so one chain
//     over K = 1728 drifts by ~1e-5 of the result, ten times cuDNN's fp32
//     error (the card test holds both). So each stage's four hi x B_hi
//     products run as their own chain, added into the fp32 sums with one
//     FADD per accumulator, and the small products (lo x B_hi, hi x B_lo,
//     2^-11 of the result) run in a chain of their own over the whole K,
//     added at the end: a third of cuDNN's error at the 3x3x3
//     convolutions.
//   - The epilogue: y = acc * scale[c] + shift[c] (eval BatchNorm, its
//     scale and shift computed by the wrapper; BatchNorm is not folded into
//     the weights, so the products keep the configuration's rounding), plus
//     the residual read from the channels-last input of the block, then
//     ReLU where asked; written channels-last in fp32.
//
// C_in must be a multiple of 32 and C_out of 64; kernels of at most 255
// taps an axis and at most 512 K steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;             // output channels per tile
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kRow = 128;           // bytes of one row of a stage: 32 fp32
constexpr int kAlign = 1024;        // a swizzle atom: 8 rows x 128 bytes
constexpr int kRingBytes = 196608;  // the ring of stages
constexpr int kMaxSteps = 512;      // K steps in the tap table
constexpr int kBBytes = kBN * kRow; // one of B's halves (hi, lo) in a stage

constexpr int kBM = 128;            // output rows per tile: 2 x m64
constexpr int kStage = kBM * kRow + 2 * kBBytes;  // A, B hi, B lo: 32 KB
constexpr int kStages = kRingBytes / kStage;
constexpr int kSmemBytes =
    kAlign + kStages * kStage + 16 * kStages + 8 * kMaxSteps;

struct Geometry {
  int n, d, h, w, c;   // input, channels last
  int kd, kh, kw;      // kernel taps
  int sd, sh, sw;      // strides
  int pd, ph, pw;      // zero padding
  int od, oh, ow;      // output extent
  int cout;            // output channels
  int steps;           // kd * kh * kw * c / 32
  int ntiles;          // cout / 64
  long long k;         // 32 * steps
  long long m;         // n * od * oh * ow
  long long tiles;     // ceil(m / BM) * ntiles
};

// out: (m, cout) channels-last fp32; scale, shift: cout floats; residual:
// (m, cout) fp32 or null; relu: 0 or 1.
struct Epilogue {
  float* out;
  const float* scale;
  const float* shift;
  const float* residual;
  int relu;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of `bar` with the given parity to complete. A wait
// that never ends (a fault of the pipeline) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 26)) __trap();
  }
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart; the start address advances 32 bytes (2 units) per k8.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

__device__ __forceinline__ void fence_acc(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d (64 x 64 fp32, 32 registers a thread) = (scale_d ? d : 0) + A (64 x 8
// tf32, the m16n8k8 A fragment of each warp's 16 rows: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) * B (64 x 8)^T, B K-major
// in shared memory described by db.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// One consumer thread's A values of half `h` of a stage (physical channels
// 8 tig + 4 h .. + 3 of its rows r and r + 8), split into TF32 hi and lo
// fragments for the two k8 steps 2 h and 2 h + 1.
__device__ __forceinline__ void load_split(const uint8_t* a_rows,
                                           uint32_t chunk,
                                           uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4]) {
  const float4 u = *reinterpret_cast<const float4*>(a_rows + chunk);
  const float4 v = *reinterpret_cast<const float4*>(a_rows + 8 * kRow + chunk);
  const float f[2][4] = {{u.x, v.x, u.y, v.y}, {u.z, v.z, u.w, v.w}};
#pragma unroll
  for (int kl = 0; kl < 2; ++kl) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[kl][e] = to_tf32(f[kl][e]);
      lo[kl][e] = to_tf32(f[kl][e] - __uint_as_float(hi[kl][e]));
    }
  }
}

// The three products of k8 steps 2 h and 2 h + 1: the two small ones
// (lo x B_hi, hi x B_lo) into `small`, hi x B_hi into `big` (its chain
// restarts where `first`).
__device__ __forceinline__ void issue_half(float* small, float* big, int h,
                                           const uint32_t (&hi)[2][4],
                                           const uint32_t (&lo)[2][4],
                                           uint64_t dbh, uint64_t dbl,
                                           int first) {
#pragma unroll
  for (int kl = 0; kl < 2; ++kl) {
    const int kk = 2 * h + kl;
    wgmma_tf32(small, lo[kl], dbh + 2 * kk, 1);
    wgmma_tf32(small, hi[kl], dbl + 2 * kk, 1);
    wgmma_tf32(big, hi[kl], dbh + 2 * kk, first && kl == 0 ? 0 : 1);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3d_tf32x3_kernel(const float* __restrict__ x,    // (n, d, h, w, c)
                     const float* __restrict__ whi,  // (cout, k) packed
                     const float* __restrict__ wlo,  // (cout, k) packed
                     const Epilogue ep, const Geometry g) {
  constexpr int BM = kBM, S = kStages;
  extern __shared__ __align__(16) uint8_t dyn[];
  const uint32_t raw = smem_u32(dyn);
  const uint32_t pad = ((raw + kAlign - 1) & ~(kAlign - 1u)) - raw;
  uint8_t* ring = dyn + pad;
  const uint32_t sring = raw + pad;
  const uint32_t sfull = sring + S * kStage;  // S full barriers, then empty
  const uint32_t sempty = sfull + 8 * S;
  int2* table = reinterpret_cast<int2*>(ring + S * kStage + 16 * S);

  const int tid = threadIdx.x;
  // K step q: its offset from an output row's input corner (tap and the
  // first of its 32 channels) and its tap (td, th, tw) packed.
  const int cblocks = g.c / 32;
  for (int q = tid; q < g.steps; q += kThreads) {
    const int tap = q / cblocks, c0 = 32 * (q - tap * cblocks);
    const int tw = tap % g.kw, th = (tap / g.kw) % g.kh,
              td = tap / (g.kw * g.kh);
    table[q] = make_int2(((td * g.h + th) * g.w + tw) * g.c + c0,
                         td | (th << 8) | (tw << 16));
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(sfull + 8 * s, 128);  // every producer thread's copies
      mbar_init(sempty + 8 * s, 8);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ── producer ───────────────────────────────────────────────────────
    // This thread copies 16-byte chunk j of A rows rr + 16 p (p < BM / 16)
    // and of B rows rr + 16 p (p < 4), hi and lo, of every stage.
    const int j = tid & 7, rr = tid >> 3;
    const uint32_t swz = static_cast<uint32_t>((j ^ (rr & 7)) << 4);
    uint32_t it = 0;
    for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      const long long m0 = tile / g.ntiles * BM;
      const int n0 = static_cast<int>(tile % g.ntiles) * kBN;
      long long base[BM / 16];
      unsigned cd[BM / 16], ch[BM / 16], cw[BM / 16];
#pragma unroll
      for (int p = 0; p < BM / 16; ++p) {
        const long long m = m0 + rr + 16 * p;
        int an = 0, id0 = -(1 << 30), ih0 = 0, iw0 = 0;
        if (m < g.m) {
          long long q = m;
          const int ow = static_cast<int>(q % g.ow);
          q /= g.ow;
          const int oh = static_cast<int>(q % g.oh);
          q /= g.oh;
          const int od = static_cast<int>(q % g.od);
          an = static_cast<int>(q / g.od);
          id0 = od * g.sd - g.pd;
          ih0 = oh * g.sh - g.ph;
          iw0 = ow * g.sw - g.pw;
        }
        // A corner coordinate below 0 wraps to a large unsigned value.
        cd[p] = id0;
        ch[p] = ih0;
        cw[p] = iw0;
        base[p] = (((static_cast<long long>(an) * g.d + id0) * g.h + ih0) *
                       g.w + iw0) * g.c + 4 * j;
      }
      const float* bh = whi + (n0 + rr) * g.k + 4 * j;
      const float* bl = wlo + (n0 + rr) * g.k + 4 * j;
      for (int step = 0; step < g.steps; ++step, ++it) {
        const uint32_t slot = it % S, round = it / S;
        mbar_wait(sempty + 8 * slot, (round & 1) ^ 1);
        const int2 e = table[step];
        const unsigned td = e.y & 0xff, th = (e.y >> 8) & 0xff,
                       tw = (e.y >> 16) & 0xff;
        const uint32_t st = sring + slot * kStage;
#pragma unroll
        for (int p = 0; p < BM / 16; ++p) {
          const bool ok = cd[p] + td < static_cast<unsigned>(g.d) &&
                          ch[p] + th < static_cast<unsigned>(g.h) &&
                          cw[p] + tw < static_cast<unsigned>(g.w);
          cp_async16(st + (rr + 16 * p) * kRow + swz,
                     ok ? x + base[p] + e.x : x, ok ? 16 : 0);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const long long off = 16 * p * g.k + 32 * step;
          cp_async16(st + BM * kRow + (rr + 16 * p) * kRow + swz, bh + off,
                     16);
          cp_async16(st + BM * kRow + kBBytes + (rr + 16 * p) * kRow + swz,
                     bl + off, 16);
        }
        mbar_arrive_copies(sfull + 8 * slot);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // ── consumers ────────────────────────────────────────────────────────
  const int cwg = (tid >> 7) - 1;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  // Row 16 warp + grp of this warpgroup's 64 (and row 8 below it); its
  // chunk for half h of a stage is 2 tig + h, swizzled by the row (r & 7
  // == grp).
  const int row0 = cwg * 64 + warp * 16 + grp;
  const uint32_t chunk0 = static_cast<uint32_t>(((2 * tig) ^ grp) << 4);
  const uint32_t chunk1 = static_cast<uint32_t>(((2 * tig + 1) ^ grp) << 4);
  // acc: the fp32 sums; big: one stage's chain of hi x B_hi products;
  // small: the tile's chain of small products.
  float acc[32], big[32], small[32];
  uint32_t hi0[2][4], lo0[2][4], hi1[2][4], lo1[2][4];
  uint32_t it = 0;
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const long long m0 = tile / g.ntiles * BM;
    const int n0 = static_cast<int>(tile % g.ntiles) * kBN;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = small[i] = 0.f;
    for (int step = 0; step < g.steps; ++step, ++it) {
      const uint32_t slot = it % S, round = it / S;
      mbar_wait(sfull + 8 * slot, round & 1);
      // The copies landed through the generic proxy; wgmma reads B
      // through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint8_t* a_rows = ring + slot * kStage + row0 * kRow;
      const uint32_t sb = sring + slot * kStage + BM * kRow;
      const uint64_t dbh = smem_desc(sb), dbl = smem_desc(sb + kBBytes);
      load_split(a_rows, chunk0, hi0, lo0);
      wgmma_fence();
      issue_half(small, big, 0, hi0, lo0, dbh, dbl, 1);
      wgmma_commit();
      // The second half's loads and splits run while the first multiplies.
      load_split(a_rows, chunk1, hi1, lo1);
      wgmma_fence();
      issue_half(small, big, 1, hi1, lo1, dbh, dbl, 0);
      wgmma_commit();
      // The stage's chain of hi x B_hi products (four tensor-core sums)
      // joins the fp32 sums, and the stage goes back to the producer.
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_acc(big[i]);
        acc[i] += big[i];
      }
      if (lane == 0) mbar_arrive(sempty + 8 * slot);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_acc(small[i]);
      acc[i] += small[i];
    }

    // Accumulator 4 i + 2 hh + e: row 16 warp + grp + 8 hh of this
    // warpgroup's rows, column 8 i + 2 tig + e of the tile.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = m0 + row0 + 8 * hh;
      if (m >= g.m) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n0 + 8 * i + 2 * tig;
        const long long idx = m * g.cout + col;
        const float2 sc = *reinterpret_cast<const float2*>(ep.scale + col);
        const float2 sh = *reinterpret_cast<const float2*>(ep.shift + col);
        float y0 = fmaf(acc[4 * i + 2 * hh], sc.x, sh.x);
        float y1 = fmaf(acc[4 * i + 2 * hh + 1], sc.y, sh.y);
        if (ep.residual != nullptr) {
          const float2 r = *reinterpret_cast<const float2*>(ep.residual + idx);
          y0 += r.x;
          y1 += r.y;
        }
        if (ep.relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<float2*>(ep.out + idx) = make_float2(y0, y1);
      }
    }
  }
}

int launch(const float* x, const float* whi, const float* wlo,
           const Epilogue& ep, Geometry g, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           conv3d_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           kSmemBytes)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv3d_tf32x3_kernel, kThreads, kSmemBytes)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.tiles = (g.m + kBM - 1) / kBM * g.ntiles;
  // Persistent: as many blocks as fit on the card, each walking tiles.
  const long long cap = static_cast<long long>(per_sm) * sms;
  const dim3 grid(static_cast<unsigned>(cap < g.tiles ? cap : g.tiles));
  conv3d_tf32x3_kernel<<<grid, kThreads, kSmemBytes, s>>>(x, whi, wlo, ep,
                                                          g);
  return static_cast<int>(cudaGetLastError());
}

int out_extent(int n, int k, int s, int p) { return (n + 2 * p - k) / s + 1; }

}  // namespace

// y = act(scale * conv3d(x, w) + shift [+ residual]) over channels-last
// fp32 x (n, d, h, w, c); w packed by the wrapper as whi, wlo (cout, k);
// out (m, cout) fp32. Returns the CUDA error of the launch (0 on success).
extern "C" int lipsync_conv3d_tf32x3(
    const void* x, const void* whi, const void* wlo, const void* scale,
    const void* shift, const void* residual, void* out, int relu, int n,
    int d, int h, int w, int c, int cout, int kd, int kh, int kw, int sd,
    int sh, int sw, int pd, int ph, int pw, void* stream) {
  if (c % 32 != 0 || cout % kBN != 0 || kd < 1 || kh < 1 || kw < 1 ||
      kd > 255 || kh > 255 || kw > 255 || sd < 1 || sh < 1 || sw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{};
  g.n = n;
  g.d = d;
  g.h = h;
  g.w = w;
  g.c = c;
  g.kd = kd;
  g.kh = kh;
  g.kw = kw;
  g.sd = sd;
  g.sh = sh;
  g.sw = sw;
  g.pd = pd;
  g.ph = ph;
  g.pw = pw;
  g.od = out_extent(d, kd, sd, pd);
  g.oh = out_extent(h, kh, sh, ph);
  g.ow = out_extent(w, kw, sw, pw);
  g.cout = cout;
  g.steps = kd * kh * kw * (c / 32);
  g.ntiles = cout / kBN;
  g.k = 32LL * g.steps;
  g.m = static_cast<long long>(n) * g.od * g.oh * g.ow;
  if (g.steps > kMaxSteps || g.od < 1 || g.oh < 1 || g.ow < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Epilogue ep{static_cast<float*>(out),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(shift),
                    static_cast<const float*>(residual), relu};
  return launch(static_cast<const float*>(x), static_cast<const float*>(whi),
                static_cast<const float*>(wlo), ep, g,
                static_cast<cudaStream_t>(stream));
}
