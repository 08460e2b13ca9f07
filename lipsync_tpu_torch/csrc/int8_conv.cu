// K3: int8 x int8 -> int32 implicit-GEMM convolution for sm_90a, with a
// dequantizing epilogue.
//
// Replaces: the XLA convolution inside lipsync_tpu/models/layers.py::
// Int8Conv (lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32) and the dequantize after it, which the JAX
// package's quantized serving lowering runs for every encoder convolution.
// It is not a Pallas kernel; PyTorch has no CUDA convolution that
// accumulates int8 in int32, so the port writes one. 2-d convolutions run
// as 3-d ones with one frame.
//
// What bounds it on an H100: at the served bucket of 16 windows, visual
// layer1's 3x3x3 64->64 convolution is M = 16 x 32 x 24 x 24 = 294,912
// output voxels, N = 64 channels, K = 27 x 64 = 1728: 33 G multiply-adds,
// 33 us at the 1,979 TOP/s of the int8 tensor cores, against 19 MB of int8
// input and 75 MB of int32 output (38 MB in bf16), 28 us (17 us) at 3.35
// TB/s. The output is most of the bytes, so the epilogue writes the
// dequantized result in the caller's dtype, float(acc) * scale[c] (+
// bias[c]), with no int32 round trip through device memory: __int2float_rn,
// __fmul_rn, __fadd_rn (never an FMA) and __float2bfloat16_rn, bit-equal to
// torch's y.float() * scale + bias then .to(dtype). An int32 output stays
// for the exact checks. What holds the wgmma loop below that bound (about
// a quarter of it at layer1, a third on the 128- and 256-channel 3x3x3
// convolutions; chip_smoke.py phase 4b) is the A gather: each of the 27
// taps fetches its own copy of the input rows, so a block of 128 x 64
// outputs at layer1 pulls 229 KB of A and 115 KB of B through L2 for 14 M
// multiply-adds. Reusing the input rows across taps (a halo tile in shared
// memory) is the way past it.
//
// The GEMM is M = output voxels (rows of the channels-last output), N =
// C_out, K = taps x C_in, with the weights zero-padded by the wrapper along
// K. No im2col in device memory: each K step gathers its A tile straight
// from the NDHWC activations, zero outside the input (the convolution's
// zero padding). Two main loops; the geometry picks one:
//
//   - C_in % 32 == 0 (every encoder convolution but the two stems): wgmma.
//     A block owns 128 output voxels x BN channels (BN = 128 when C_out %
//     128 == 0, else 64) and walks K in stages of 128 bytes (K padded to
//     128). 16 bytes of a row never straddle two taps, so the A tile is
//     one 16-byte cp.async per chunk (zero-filled out of bounds), from a
//     per-block table of each K chunk's tap offset; B (weights, (cout, kp)
//     K-major) is 16-byte cp.async too. Both land 128-byte-swizzled and
//     K-major (chunk j of row r at r * 128 + ((j ^ (r & 7)) << 4), the
//     layout of TMA's SWIZZLE_128B), in a ring of 4 stages. Each of the two
//     warpgroups issues four wgmma.mma_async m64nBNk32 s8 x s8 -> s32 per
//     stage from shared-memory descriptors (the start address advances 32
//     bytes per k32 inside the 128-byte row), commits them as one group
//     and waits for the previous group only: one stage of products stays
//     in flight while two more stages land. One __syncthreads per stage
//     both publishes the landed stage and frees the slot that the last
//     completed group read.
//   - otherwise (C_in = 1 or 3, the stems): mma.sync. A block owns a 128 x
//     64 output tile; 8 warps, each a 32 x 32 sub-tile of 2 x 4
//     mma.sync.m16n8k32 products per K step of 32 (K padded to 32), on a
//     two-stage double buffer. Each thread gathers its 16 bytes one input
//     value at a time; B is two 16-byte cp.async per row. Rows are staged
//     48 bytes apart, so the 32-bit fragment loads of a warp hit 32
//     distinct banks.
//
// The arithmetic is exact: |acc| <= 127^2 x K < 2^31 for every K the
// encoders have (at most 6912).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum OutKind { kOutInt32 = 0, kOutFloat = 1, kOutBf16 = 2 };

struct Geometry {
  int n, d, h, w, c;     // input, NDHWC
  int kd, kh, kw;        // kernel taps
  int sd, sh, sw;        // strides
  int pd, ph, pw;        // zero padding
  int od, oh, ow;        // output extent
  int cout;              // output channels
  int k;                 // kd * kh * kw * c
  int kp;                // k rounded up to the main loop's K step
  long long m;           // n * od * oh * ow
};

// Where the result goes: out is (m, cout) channels-last, int32, float or
// bf16; scale (cout floats) and bias (cout floats or null) are read for
// the float kinds only.
struct Epilogue {
  void* out;
  const float* scale;
  const float* bias;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Columns col, col + 1 of output row `row` from the accumulators a, b.
template <int kOut>
__device__ __forceinline__ void store_pair(const Epilogue& ep, long long idx,
                                           int col, int32_t a, int32_t b) {
  if constexpr (kOut == kOutInt32) {
    *reinterpret_cast<int2*>(static_cast<int32_t*>(ep.out) + idx) =
        make_int2(a, b);
    return;
  }
  const float2 s = *reinterpret_cast<const float2*>(ep.scale + col);
  float fa = __fmul_rn(__int2float_rn(a), s.x);
  float fb = __fmul_rn(__int2float_rn(b), s.y);
  if (ep.bias != nullptr) {
    const float2 bi = *reinterpret_cast<const float2*>(ep.bias + col);
    fa = __fadd_rn(fa, bi.x);
    fb = __fadd_rn(fb, bi.y);
  }
  if constexpr (kOut == kOutFloat) {
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
        make_float2(fa, fb);
  } else {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(fa);
    v.y = __float2bfloat16_rn(fb);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(ep.out) +
                                       idx) = v;
  }
}

// Output voxel m's input corner: batch index and (d, h, w) of tap 0.
__device__ __forceinline__ void corner(const Geometry& g, long long m,
                                       int& an, int& id0, int& ih0,
                                       int& iw0) {
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

// ── the stems: mma.sync, one input value at a time ──────────────────────

constexpr int kBM = 128;      // output voxels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K per step
constexpr int kThreads = 256;
constexpr int kRow = 48;      // bytes per staged row: 32 used + 16 pad
constexpr int kStage = (kBM + kBN) * kRow;

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

template <int kOut>
__global__ void __launch_bounds__(kThreads)
int8_conv_mma_kernel(const int8_t* __restrict__ x,    // (n, d, h, w, c)
                     const int8_t* __restrict__ wt,   // (cout, kp), K-major
                     const Epilogue ep, const Geometry g) {
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
  if (row_ok) corner(g, am, an, id0, ih0, iw0);
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
    uint32_t v[4];
    const int kb = k0 + 16 * half;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = gather(kb + 4 * j) | (gather(kb + 4 * j + 1) << 8) |
             (gather(kb + 4 * j + 2) << 16) | (gather(kb + 4 * j + 3) << 24);
    }
    *reinterpret_cast<uint4*>(adst) = make_uint4(v[0], v[1], v[2], v[3]);
    if (tid < 2 * kBN) {  // B: row tid / 2 of the tile, 16 bytes each
      const int bn = n0 + (tid >> 1);
      uint8_t* bdst = as + kBM * kRow + (tid >> 1) * kRow + 16 * half;
      const bool ok = bn < g.cout;
      const int8_t* src =
          ok ? wt + static_cast<long long>(bn) * g.kp + k0 + 16 * half : wt;
      cp_async16(smem_u32(bdst), src, ok ? 16 : 0);
    }
    cp_async_commit();
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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
          store_pair<kOut>(ep, row * g.cout + col, col,
                           acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
        }
      }
    }
  }
}

// ── C_in % 32 == 0: wgmma over a swizzled cp.async ring ─────────────────

constexpr int kWgBM = 128;      // output voxels per block: 2 warpgroups x 64
constexpr int kWgBK = 128;      // K bytes per stage: one swizzled row
constexpr int kWgStages = 4;
constexpr int kMaxChunks = 512; // 16-byte K chunks in the tap table
constexpr int kAlign = 1024;    // a swizzle atom: 8 rows x 128 bytes

template <int BN>
constexpr int wg_smem_bytes() {
  return kAlign + kWgStages * (kWgBM + BN) * kWgBK + kMaxChunks * 8;
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (stride byte offset); the leading byte offset is unused
// for a swizzled K-major operand whose k32 slice lies inside one row.
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

// The compiler may not move reads or writes of r across this point.
__device__ __forceinline__ void fence_reg(int32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (64 x 64 s32, 32 registers a thread) += A (64 x 32) * B (64 x 32)^T,
// both K-major in shared memory, described by da and db.
__device__ __forceinline__ void wgmma_n64(int32_t* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 s32, 64 registers a thread) += A (64 x 32) * B (128 x 32)^T,
// both K-major in shared memory, described by da and db.
__device__ __forceinline__ void wgmma_n128(int32_t* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int32_t* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n64(d, da, db);
  }
}

template <int BN, int kOut>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_wgmma_kernel(const int8_t* __restrict__ x,    // (n, d, h, w, c)
                       const int8_t* __restrict__ wt,   // (cout, kp)
                       const Epilogue ep, const Geometry g) {
  extern __shared__ uint8_t dyn[];
  constexpr int kABytes = kWgBM * kWgBK;
  constexpr int kStageBytes = (kWgBM + BN) * kWgBK;
  const uint32_t raw = smem_u32(dyn);
  const uint32_t sbase = (raw + kAlign - 1) & ~(kAlign - 1u);
  int2* table = reinterpret_cast<int2*>(dyn + (sbase - raw) +
                                        kWgStages * kStageBytes);

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kWgBM;
  const int n0 = blockIdx.y * BN;

  // K chunk q (16 bytes, one tap's channels): its offset from an output
  // voxel's input corner, and its tap (td, th, tw) packed; -1 past K.
  for (int q = tid; q < g.kp / 16; q += kThreads) {
    const int k = 16 * q;
    int2 e = make_int2(0, -1);
    if (k < g.k) {
      const int tap = k / g.c, ci = k - tap * g.c;
      const int tw = tap % g.kw, th = (tap / g.kw) % g.kh,
                td = tap / (g.kw * g.kh);
      e = make_int2(((td * g.h + th) * g.w + tw) * g.c + ci,
                    td | (th << 8) | (tw << 16));
    }
    table[q] = e;
  }

  // This thread loads chunk j of rows r0 + 32 p (p < 4) of the A tile and
  // of rows r0 + 32 p (p < BN / 32) of the B tile: a warp covers four
  // 128-byte rows per copy. Each A row's input corner, decoded once; a row
  // past M gets a corner that no tap brings inside the input.
  const int j = tid & 7, r0 = tid >> 3;
  const uint32_t swz = static_cast<uint32_t>((j ^ (r0 & 7)) << 4);
  long long base[4];
  unsigned cd[4], ch[4], cw[4];  // the corner, wrapped to unsigned
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long m = m0 + r0 + 32 * p;
    int an = 0, id0 = -(1 << 30), ih0 = 0, iw0 = 0;
    if (m < g.m) corner(g, m, an, id0, ih0, iw0);
    cd[p] = id0;
    ch[p] = ih0;
    cw[p] = iw0;
    base[p] = (((static_cast<long long>(an) * g.d + id0) * g.h + ih0) * g.w +
               iw0) * g.c;
  }

  auto load_stage = [&](int slot, int step) {
    const int2 e = table[step * (kWgBK / 16) + j];
    const unsigned td = e.y & 0xff, th = (e.y >> 8) & 0xff,
                   tw = (e.y >> 16) & 0xff;
    const uint32_t st = sbase + slot * kStageBytes;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // A corner coordinate below 0 wraps to a large unsigned value.
      const bool ok = e.y >= 0 && cd[p] + td < static_cast<unsigned>(g.d) &&
                      ch[p] + th < static_cast<unsigned>(g.h) &&
                      cw[p] + tw < static_cast<unsigned>(g.w);
      cp_async16(st + (r0 + 32 * p) * kWgBK + swz, ok ? x + base[p] + e.x : x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
      const int n = n0 + r0 + 32 * p;
      const bool ok = n < g.cout;
      cp_async16(st + kABytes + (r0 + 32 * p) * kWgBK + swz,
                 ok ? wt + static_cast<long long>(n) * g.kp + step * kWgBK +
                          16 * j
                    : wt,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int steps = g.kp / kWgBK;
  const int wg = tid >> 7;
  __syncthreads();  // the tap table
#pragma unroll
  for (int s = 0; s < kWgStages - 2; ++s) {
    if (s < steps) {
      load_stage(s, s);
    } else {
      cp_async_commit();
    }
  }
  for (int step = 0; step < steps; ++step) {
    // Stage `step` has landed for this thread; the fence orders its
    // copies before the async proxy's reads, and the barrier makes them
    // everyone's. Past the barrier every warpgroup has also waited for
    // the products of stage step - 2, so that slot is free.
    cp_async_wait<kWgStages - 3>();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int next = step + kWgStages - 2;
    if (next < steps) {
      load_stage(next % kWgStages, next);
    } else {
      cp_async_commit();
    }
    const uint32_t st = sbase + (step % kWgStages) * kStageBytes;
    const uint64_t da = smem_desc(st + wg * 64 * kWgBK);
    const uint64_t db = smem_desc(st + kABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk) {
      wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

  // Accumulator 4 i + 2 hh + e: row 16 * warp + grp + 8 * hh of the
  // warpgroup's 64, column 8 i + 2 tig + e.
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const long long row0 = m0 + wg * 64 + warp * 16 + grp;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * tig;
    if (col >= g.cout) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = row0 + 8 * hh;
      if (row < g.m) {
        store_pair<kOut>(ep, row * g.cout + col, col, acc[4 * i + 2 * hh],
                         acc[4 * i + 2 * hh + 1]);
      }
    }
  }
}

template <int kOut>
int launch(const int8_t* x, const int8_t* wt, const Epilogue& ep,
           const Geometry& g, int path, cudaStream_t s) {
  if (path == 0) {
    const dim3 grid(static_cast<unsigned>((g.m + kBM - 1) / kBM),
                    (g.cout + kBN - 1) / kBN);
    int8_conv_mma_kernel<kOut><<<grid, kThreads, 0, s>>>(x, wt, ep, g);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid128(static_cast<unsigned>((g.m + kWgBM - 1) / kWgBM),
                     g.cout / 128);
  const dim3 grid64(static_cast<unsigned>((g.m + kWgBM - 1) / kWgBM),
                    (g.cout + 63) / 64);
  cudaError_t err;
  if (g.cout % 128 == 0) {
    auto* kern = int8_conv_wgmma_kernel<128, kOut>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wg_smem_bytes<128>());
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid128, kThreads, wg_smem_bytes<128>(), s>>>(x, wt, ep, g);
  } else {
    auto* kern = int8_conv_wgmma_kernel<64, kOut>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wg_smem_bytes<64>());
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid64, kThreads, wg_smem_bytes<64>(), s>>>(x, wt, ep, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, d, h, w, c) int8, channels-last; wt: (cout, kp) int8, row o the
// kernel's taps in (kd, kh, kw, c) order, zero from k = kd*kh*kw*c to kp;
// out: (n, od, oh, ow, cout) channels-last, int32 (out_kind 0: the exact
// sums) or float(acc) * scale[o] (+ bias[o] when bias is not null) as fp32
// (1) or bf16 (2). path 1, the wgmma main loop: c % 32 == 0, kp % 128 ==
// 0, kp <= 8192, taps per axis < 256, x 16-byte aligned. path 0, the
// mma.sync gather: kp % 32 == 0. cout % 8 == 0 on both. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// geometry it does not take.
extern "C" int lipsync_int8_conv(const void* x, const void* wt, void* out,
                                 const void* scale, const void* bias,
                                 int out_kind, int n, int d, int h, int w,
                                 int c, int kd, int kh, int kw, int sd,
                                 int sh, int sw, int pd, int ph, int pw,
                                 int od, int oh, int ow, int cout, int kp,
                                 int path, void* stream) {
  Geometry g{n, d, h, w, c, kd, kh, kw, sd, sh, sw, pd, ph, pw, od, oh, ow,
             cout, kd * kh * kw * c, kp,
             static_cast<long long>(n) * od * oh * ow};
  const bool wgmma_ok =
      c % 32 == 0 && kp % kWgBK == 0 && kp <= 16 * kMaxChunks &&
      kd < 256 && kh < 256 && kw < 256 &&
      static_cast<long long>(kd) * h * w * c < (1LL << 31) &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (g.m <= 0 || cout <= 0 || cout % 8 != 0 || kp < g.k ||
      (path == 0 && kp % kBK != 0) || (path == 1 && !wgmma_ok) ||
      (path != 0 && path != 1) || out_kind < 0 || out_kind > 2 ||
      (out_kind != kOutInt32 && scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((g.m + kBM - 1) / kBM > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const Epilogue ep{out, static_cast<const float*>(scale),
                    static_cast<const float*>(bias)};
  switch (out_kind) {
    case kOutInt32:
      return launch<kOutInt32>(xp, wp, ep, g, path, s);
    case kOutFloat:
      return launch<kOutFloat>(xp, wp, ep, g, path, s);
    default:
      return launch<kOutBf16>(xp, wp, ep, g, path, s);
  }
}
