// K3: int8 x int8 -> int32 implicit-GEMM convolution for sm_90a.
//
// Replaces: the XLA convolution inside lipsync_tpu/models/layers.py::
// Int8Conv (lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32), which the JAX package's quantized serving
// lowering runs for every encoder convolution. It is not a Pallas kernel;
// PyTorch has no CUDA convolution that accumulates int8 in int32, so the
// port writes one. 2-d convolutions run as 3-d ones with one frame.
//
// What bounds it on an H100: at the served bucket of 16 windows, visual
// layer1's 3x3x3 64->64 convolution is M = 16 x 32 x 24 x 24 = 294,912
// output voxels, N = 64 channels, K = 27 x 64 = 1728: 33 G multiply-adds,
// 33 us at the 1,979 TOP/s of the int8 tensor cores, against 19 MB of int8
// input and 75 MB of int32 output, 28 us at 3.35 TB/s. The two are close;
// the int32 output is most of the bytes.
//
// Design (simple first; made fast in later work). The GEMM is M = output
// voxels (rows of the channels-last output), N = C_out, K = taps x C_in,
// with the weights zero-padded by the wrapper to a multiple of 32 along K.
// A block owns a 128 x 64 output tile; 8 warps, each a 32 x 32 sub-tile of
// 2 x 4 mma.sync.m16n8k32 s8 x s8 -> s32 products per K step of 32. No
// im2col in device memory: each K step gathers its A tile (128 voxels x 32
// taps-and-channels) straight from the NDHWC activations, zero outside the
// input (the convolution's zero padding), into shared memory, with a
// two-stage double buffer:
//   - C_in % 32 == 0 (every encoder convolution but the two stems): one K
//     step lies in one tap, so a row is 32 contiguous input bytes: two
//     16-byte cp.async per row, zero-filled out of bounds;
//   - otherwise (C_in = 1 or 3, the stems): each thread gathers its 16
//     bytes one element at a time and stores them.
// The B tile (64 output channels x 32 K) is two 16-byte cp.async per row.
// Rows are staged 48 bytes apart, so the 32-bit fragment loads of a warp
// hit 32 distinct banks. The epilogue stores the int32 accumulators as
// 8-byte pairs. The arithmetic is exact: |acc| <= 127^2 x K < 2^31 for
// every K the encoders have (at most 6912).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output voxels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K per step
constexpr int kThreads = 256;
constexpr int kRow = 48;      // bytes per staged row: 32 used + 16 pad
constexpr int kStage = (kBM + kBN) * kRow;

struct Geometry {
  int n, d, h, w, c;     // input, NDHWC
  int kd, kh, kw;        // kernel taps
  int sd, sh, sw;        // strides
  int pd, ph, pw;        // zero padding
  int od, oh, ow;        // output extent
  int cout;              // output channels
  int k;                 // kd * kh * kw * c
  int kp;                // k rounded up to a multiple of 32
  long long m;           // n * od * oh * ow
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x,    // (n, d, h, w, c)
                 const int8_t* __restrict__ wt,   // (cout, kp), K-major
                 int32_t* __restrict__ out,       // (m, cout)
                 const Geometry g) {
  __shared__ __align__(16) uint8_t smem[2][kStage];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;   // 4 x 2 warps
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: row ar of the tile, bytes [16 * half, 16 * half + 16) of
  // each K step. Its output voxel's input corner, decoded once.
  const int ar = tid >> 1, half = tid & 1;
  const long long am = m0 + ar;
  const bool row_ok = am < g.m;
  int an = 0, id0 = 0, ih0 = 0, iw0 = 0;
  if (row_ok) {
    long long q = am;
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
  const int8_t* xn =
      x + static_cast<long long>(an) * g.d * g.h * g.w * g.c;

  // Input byte of K index k for this row, 0 outside the input or past K.
  auto gather = [&](int k) -> uint32_t {
    if (!row_ok || k >= g.k) return 0u;
    const int tap = k / g.c, ci = k - tap * g.c;
    const int tw = tap % g.kw, th = (tap / g.kw) % g.kh,
              td = tap / (g.kw * g.kh);
    const int id = id0 + td, ih = ih0 + th, iw = iw0 + tw;
    if (id < 0 || id >= g.d || ih < 0 || ih >= g.h || iw < 0 || iw >= g.w)
      return 0u;
    return static_cast<uint8_t>(
        xn[((static_cast<long long>(id) * g.h + ih) * g.w + iw) * g.c + ci]);
  };

  auto load_stage = [&](int stage, int k0) {
    uint8_t* as = smem[stage];
    uint8_t* adst = as + ar * kRow + 16 * half;
    if (kVec) {
      // c % 32 == 0: the step's 32 K indices are one tap's channels.
      const int tap = k0 / g.c, ci = k0 - tap * g.c + 16 * half;
      const int tw = tap % g.kw, th = (tap / g.kw) % g.kh,
                td = tap / (g.kw * g.kh);
      const int id = id0 + td, ih = ih0 + th, iw = iw0 + tw;
      const bool ok = row_ok && id >= 0 && id < g.d && ih >= 0 &&
                      ih < g.h && iw >= 0 && iw < g.w;
      const int8_t* src =
          ok ? xn + ((static_cast<long long>(id) * g.h + ih) * g.w + iw) *
                        g.c + ci
             : x;
      cp_async16(adst, src, ok ? 16 : 0);
    } else {
      uint32_t v[4];
      const int kb = k0 + 16 * half;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = gather(kb + 4 * j) | (gather(kb + 4 * j + 1) << 8) |
               (gather(kb + 4 * j + 2) << 16) | (gather(kb + 4 * j + 3) << 24);
      }
      *reinterpret_cast<uint4*>(adst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (tid < 2 * kBN) {  // B: row tid / 2 of the tile, 16 bytes each
      const int bn = n0 + (tid >> 1);
      uint8_t* bdst = as + kBM * kRow + (tid >> 1) * kRow + 16 * half;
      const bool ok = bn < g.cout;
      const int8_t* src =
          ok ? wt + static_cast<long long>(bn) * g.kp + k0 + 16 * half : wt;
      cp_async16(bdst, src, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;");
  };

  int32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = g.kp / kBK;
  load_stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage((s + 1) & 1, (s + 1) * kBK);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const uint8_t* as = smem[s & 1];
    const uint8_t* bs = as + kBM * kRow;
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint8_t* p = as + (wm * 32 + mi * 16 + grp) * kRow + 4 * tig;
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * kRow);
      a[mi][2] = lds32(p + 16);
      a[mi][3] = lds32(p + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* p = bs + (wn * 32 + ni * 8 + grp) * kRow + 4 * tig;
      b[ni][0] = lds32(p);
      b[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    // This stage is read; the next iteration's load may overwrite it.
    __syncthreads();
  }

  // Accumulator (mi, ni): rows grp and grp + 8 of the 16-row tile, columns
  // 2 * tig and 2 * tig + 1 of the 8-column tile. cout % 8 == 0.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * tig;
      if (col >= g.cout) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = m0 + wm * 32 + mi * 16 + grp + 8 * hh;
        if (row < g.m) {
          *reinterpret_cast<int2*>(out + row * g.cout + col) =
              make_int2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
        }
      }
    }
  }
}

}  // namespace

// x: (n, d, h, w, c) int8, channels-last; wt: (cout, kp) int8, row o the
// kernel's taps in (kd, kh, kw, c) order, zero from k = kd*kh*kw*c to kp;
// out: (n, od, oh, ow, cout) int32. kp % 32 == 0, cout % 8 == 0; vec != 0
// needs c % 32 == 0 and x 16-byte aligned. Returns cudaGetLastError() of
// the launch, or cudaErrorInvalidValue for a geometry it does not take.
extern "C" int lipsync_int8_conv(const void* x, const void* wt, void* out,
                                 int n, int d, int h, int w, int c, int kd,
                                 int kh, int kw, int sd, int sh, int sw,
                                 int pd, int ph, int pw, int od, int oh,
                                 int ow, int cout, int kp, int vec,
                                 void* stream) {
  Geometry g{n, d, h, w, c, kd, kh, kw, sd, sh, sw, pd, ph, pw, od, oh, ow,
             cout, kd * kh * kw * c, kp,
             static_cast<long long>(n) * od * oh * ow};
  if (g.m <= 0 || cout <= 0 || cout % 8 != 0 || kp % kBK != 0 ||
      kp < g.k || (vec && c % kBK != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks_m = (g.m + kBM - 1) / kBM;
  if (blocks_m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_m), (cout + kBN - 1) / kBN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  int32_t* op = static_cast<int32_t*>(out);
  if (vec) {
    int8_conv_kernel<true><<<grid, kThreads, 0, s>>>(xp, wp, op, g);
  } else {
    int8_conv_kernel<false><<<grid, kThreads, 0, s>>>(xp, wp, op, g);
  }
  return static_cast<int>(cudaGetLastError());
}
