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
// convolutions: PERF.md's kernel table; tests/test_torch_kernels_card.py
// holds K3 at these geometries) is the A gather: each of the 27
// taps fetches its own copy of the input rows, so a block of 128 x 64
// outputs at layer1 pulls 229 KB of A and 115 KB of B through L2 for 14 M
// multiply-adds. Reusing the input rows across taps (a halo tile in shared
// memory) is the way past it. The visual stem (3 -> 64, 3x7x7, s(1,2,2))
// at 16 windows is M = 1,179,648 voxels, K = 441: 14 MB of input and 302
// MB of int32 output (0.094 ms at 3.35 TB/s) against 67 G operations
// (0.034 ms at 1,979 TOP/s): its output bounds it.
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
//   - otherwise (C_in = 1 or 3 at the stems, any other C_in too): wgmma
//     over a halo tile. A persistent block walks tiles of tr output rows
//     x tw output columns of one frame (tr * tw <= 192 GEMM rows, 2 or 3
//     warpgroups; 4 x 48 at the visual stem, 2 x 64 at the audio one).
//     The input rows a tile reads (kd frames x hr rows, each one
//     contiguous run of NDHWC bytes) land by 16-byte cp.async in a
//     staging slot while the previous tile computes; one pass widens them
//     into the halo, each voxel's channels zero-padded to a multiple of 4
//     as 32-bit words (cw per voxel), voxels outside the input zero (the
//     convolution's padding), so the MMA loop tests no bound. The weights
//     are packed the same way by the wrapper, (cout, taps x 4 cw bytes),
//     zero in the padded channels and past K: the sums are unchanged. B
//     stays resident in shared memory for the block's life, 128-byte-
//     swizzled and K-major as in the loop above; A comes from registers:
//     K word q of GEMM row r is halo word base(r) + offset(q), one 32-bit
//     shared load from a per-row base and a per-word offset table (no
//     division in the loop), in the m16n8k32 A fragment of each warp's 16
//     rows. wgmma.mma_async m64n64k32 s8 x s8 -> s32, up to four k32
//     steps a group, only the steps K needs. At the visual stem (K = 147
//     words) the output is 95% of the bytes: the epilogue is the loop
//     above's.
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

// ── C_in % 32 == 0: wgmma over a swizzled cp.async ring ─────────────────

constexpr int kThreads = 256;
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

// ── every other C_in (the stems): wgmma over a halo tile ───────────────

constexpr int kHaloBN = 64;        // output channels per block
constexpr int kBBlock = kHaloBN * kWgBK;  // one 128-byte K block of B
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kRowOut = -0x40000000;  // a staged row outside the input

// The halo loop's tile and the shared-memory regions it needs, as
// ops/kernels/int8_conv.py::halo_plan chooses and sizes them.
struct Halo {
  int cw;            // 32-bit words per input voxel: channels padded to 4
  int kblocks;       // K in blocks of 32 words (128 bytes)
  int ksteps;        // k32 steps that K needs: ceil(words / 8)
  int tr, tw;        // output rows x output columns per tile
  int hr, hc;        // the tile's input rows and columns (its halo)
  int rs;            // bytes per staged input row
  int nhb, nwb;      // tiles along oh and along ow
  int tiles;         // n * od * nhb * nwb, below 2^30
  int halo_bytes;    // 4 * kd * hr * hc * cw, rounded up to 16
  int stage_bytes;   // kd * hr * rs, one of two slots
  int rows_bytes;    // 4 * kd * hr, rounded up to 16: one slot's row table
  long long total;   // bytes of x
};

__host__ __device__ __forceinline__ int halo_smem_bytes(const Halo& hp) {
  return kAlign + hp.kblocks * kBBlock + 2 * hp.halo_bytes +
         2 * hp.stage_bytes + 2 * hp.rows_bytes + hp.kblocks * 32 * 4;
}

// d (64 x 64 s32) += A (64 x 32, four 32-bit registers a thread, the
// m16n8k32 A fragment of each warp's 16 rows) * B (64 x 32)^T, B K-major
// in shared memory described by db.
__device__ __forceinline__ void wgmma_n64_rs(int32_t* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One halo word for a voxel of C <= 4 channels at shared address src: the
// funnel shift of the two aligned words around its bytes, the bytes past
// C masked off (mask).
__device__ __forceinline__ uint32_t voxel_word(const uint8_t* src,
                                               uint32_t mask) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(p & ~uintptr_t{3});
  return __funnelshift_r(a[0], a[1], 8 * static_cast<int>(p & 3)) & mask;
}

// kWG warpgroups, each 64 rows of the tile's kWG * 64 GEMM rows (output
// voxels) by all 64 columns of output channels n0 .. n0 + 63. A block is
// persistent: it walks tiles blockIdx.x, + gridDim.x, ..., and stages the
// next tile's input rows while it widens, multiplies and stores this one.
template <int kWG, int kOut>
__global__ void __launch_bounds__(kWG * 128, 2)
int8_conv_halo_kernel(const int8_t* __restrict__ x,    // (n, d, h, w, c)
                      const int8_t* __restrict__ wt,   // (cout, kp) packed
                      const int* __restrict__ table,   // word -> halo offset
                      const Epilogue ep, const Geometry g, const Halo hp) {
  constexpr int kThr = kWG * 128;
  extern __shared__ uint8_t dyn[];
  const uint32_t raw = smem_u32(dyn);
  const uint32_t pad = ((raw + kAlign - 1) & ~(kAlign - 1u)) - raw;
  const uint32_t sb = raw + pad;  // B: kblocks x (64 rows x 128 bytes)
  uint32_t* halo =  // two buffers of halo_bytes
      reinterpret_cast<uint32_t*>(dyn + pad + hp.kblocks * kBBlock);
  uint8_t* stage = reinterpret_cast<uint8_t*>(halo) + 2 * hp.halo_bytes;
  const int hwords = hp.halo_bytes / 4;
  // Per slot, each staged row's byte offset of input column 0 from the
  // slot, or kRowOut for a row outside the input.
  int* rowtab = reinterpret_cast<int*>(stage + 2 * hp.stage_bytes);
  int* tab = rowtab + 2 * (hp.rows_bytes / 4);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kHaloBN;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  // B, resident for the block's life: row r, 16-byte chunk q (block q / 8)
  // at block * 8192 + r * 128 + ((q % 8) ^ (r % 8)) * 16, rows past C_out
  // zero-filled. The table of each K word's offset in the halo.
  const int chunks = hp.kblocks * 8;
  for (int i = tid; i < kHaloBN * chunks; i += kThr) {
    const int r = i / chunks, q = i - r * chunks;
    const bool ok = n0 + r < g.cout;
    cp_async16(sb + (q >> 3) * kBBlock + r * kWgBK +
                   (((q & 7) ^ (r & 7)) << 4),
               ok ? wt + static_cast<long long>(n0 + r) * g.kp + 16 * q : wt,
               ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < hp.kblocks * 32; i += kThr) tab[i] = table[i];

  // This thread's two GEMM rows (grp and grp + 8 of its warp's 16): their
  // place in the tile and the halo word of their tap 0. A row past the
  // tile reads word 0 and stores nothing.
  int rbase[2], rr[2], rc[2];
  bool rok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * 64 + warp * 16 + grp + 8 * hh;
    rok[hh] = r < hp.tr * hp.tw;
    rr[hh] = rok[hh] ? r / hp.tw : 0;
    rc[hh] = rok[hh] ? r - rr[hh] * hp.tw : 0;
    rbase[hh] = (rr[hh] * g.sh * hp.hc + rc[hh] * g.sw) * hp.cw;
  }

  struct Tile {
    int n, od, oh0, ow0, id0, ih0, iw0, cs, ce;
  };
  // Tile t's batch item, frame and first output row and column (int
  // arithmetic: the launcher keeps the tile count below 2^30).
  auto decode = [&](int t) {
    Tile tl;
    int q = t / hp.nwb;
    tl.ow0 = (t - q * hp.nwb) * hp.tw;
    t = q;
    q = t / hp.nhb;
    tl.oh0 = (t - q * hp.nhb) * hp.tr;
    tl.n = q / g.od;
    tl.od = q - tl.n * g.od;
    tl.id0 = tl.od * g.sd - g.pd;
    tl.ih0 = tl.oh0 * g.sh - g.ph;
    tl.iw0 = tl.ow0 * g.sw - g.pw;
    tl.cs = max(tl.iw0, 0);  // the input columns inside the halo
    tl.ce = min(tl.iw0 + hp.hc, g.w);
    return tl;
  };

  // The tile's input rows, as raw bytes: row (f, r) of the halo is one
  // contiguous run of x, copied as the 16-byte-aligned chunks that cover
  // it (the last one of x cut at its end) into slot row f * hr + r. One
  // warp a row, its lanes over the chunks.
  auto load_raw = [&](const Tile& tl, int slot) {
    uint8_t* dst = stage + slot * hp.stage_bytes;
    int* rt = rowtab + slot * (hp.rows_bytes / 4);
    const int rows = g.kd * hp.hr;
    for (int row = tid >> 5; row < rows; row += kThr / 32) {
      const int f = row / hp.hr, r = row - f * hp.hr;
      const int id = tl.id0 + f, ih = tl.ih0 + r;
      if (static_cast<unsigned>(id) >= static_cast<unsigned>(g.d) ||
          static_cast<unsigned>(ih) >= static_cast<unsigned>(g.h) ||
          tl.cs >= tl.ce) {
        if (lane == 0) rt[row] = kRowOut;
        continue;
      }
      const long long g0 =
          ((static_cast<long long>(tl.n) * g.d + id) * g.h + ih) *
          static_cast<long long>(g.w) * g.c;
      const long long a = g0 + static_cast<long long>(tl.cs) * g.c;
      const long long a0 = a & ~15LL;
      const long long a1 =
          (g0 + static_cast<long long>(tl.ce) * g.c + 15) & ~15LL;
      if (lane == 0) {
        rt[row] = row * hp.rs + static_cast<int>(a - a0) - tl.cs * g.c;
      }
      for (long long ch = a0 + 16 * lane; ch < a1; ch += 16 * 32) {
        const long long left = hp.total - ch;
        cp_async16(smem_u32(dst + row * hp.rs + (ch - a0)), x + ch,
                   left < 16 ? static_cast<int>(left) : 16);
      }
    }
    cp_async_commit();
  };

  // The staged rows widened to the halo: voxel (f, r, col), halo index
  // i = (f * hr + r) * hc + col, as cw words of 4 channels each, channels
  // past C and voxels outside the input zero (the convolution's padding).
  // A flat index, (row, col) stepped by the block's width without a
  // division; for C <= 4 one word is one funnel shift (voxel_word).
  const int total = g.kd * hp.hr * hp.hc;
  const uint32_t cmask = g.c >= 4 ? 0xffffffffu : (1u << (8 * g.c)) - 1;
  auto widen = [&](const Tile& tl, int slot, uint32_t* out) {
    const uint8_t* sbase = stage + slot * hp.stage_bytes;
    const int* rt = rowtab + slot * (hp.rows_bytes / 4);
    const int drow = kThr / hp.hc, dcol = kThr - drow * hp.hc;
    int row = tid / hp.hc, col = tid - row * hp.hc;
    for (int i = tid; i < total; i += kThr) {
      const int off = rt[row];
      const int iw = tl.iw0 + col;
      const bool in = off != kRowOut &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(g.w);
      const uint8_t* src = sbase + (in ? off + iw * g.c : 0);
      if (hp.cw == 1) {
        out[i] = in ? voxel_word(src, cmask) : 0u;
      } else {
        for (int q = 0; q < hp.cw; ++q) {
          uint32_t v = 0;
          if (in) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (4 * q + b < g.c) {
                v |= static_cast<uint32_t>(src[4 * q + b]) << (8 * b);
              }
            }
          }
          out[i * hp.cw + q] = v;
        }
      }
      col += dcol;
      row += drow;
      while (col >= hp.hc) {
        col -= hp.hc;
        ++row;
      }
    }
  };

  // This block's tiles: blockIdx.x + i * gridDim.x for i < count.
  const int t0 = blockIdx.x, tstep = gridDim.x;
  const int count = t0 < hp.tiles ? (hp.tiles - 1 - t0) / tstep + 1 : 0;
  // Two tiles' rows in flight from the start, tile 0 widened; then each
  // tile's one barrier both publishes the next tile's landed rows and
  // frees what the previous tile read.
  for (int i = 0; i < 2; ++i) {
    if (i < count) {
      load_raw(decode(t0 + i * tstep), i);
    } else {
      cp_async_commit();
    }
  }
  cp_async_wait<1>();  // B and tile 0's rows
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (count > 0) widen(decode(t0), 0, halo);
  for (int i = 0; i < count; ++i) {
    const int t = t0 + i * tstep, b = i & 1;
    // Tile i + 1's rows have landed; past the barrier every thread has
    // widened tile i into halo buffer b and multiplied tile i - 1 out of
    // buffer b ^ 1, and read staging slot b (tile i's rows).
    cp_async_wait<0>();
    __syncthreads();
    if (i + 2 < count) {
      load_raw(decode(t + 2 * tstep), b);
    } else {
      cp_async_commit();
    }
    if (i + 1 < count) {
      widen(decode(t + tstep), b ^ 1, halo + (b ^ 1) * hwords);
    }
    const uint32_t* hb = halo + b * hwords;

    int32_t acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0;
    for (int kb = 0; kb < hp.kblocks; ++kb) {
      // Up to four k32 steps (those K needs): words 8 s + tig and
      // 8 s + 4 + tig of rows grp and grp + 8, each one 32-bit shared load.
      const int steps = min(4, hp.ksteps - 4 * kb);
      uint32_t a[4][4] = {};
      const int* tk = tab + kb * 32 + tig;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < steps) {
          const int o0 = tk[8 * s], o1 = tk[8 * s + 4];
          a[s][0] = hb[rbase[0] + o0];
          a[s][1] = hb[rbase[1] + o0];
          a[s][2] = hb[rbase[0] + o1];
          a[s][3] = hb[rbase[1] + o1];
        }
      }
      const uint64_t db = smem_desc(sb + kb * kBBlock);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < steps) wgmma_n64_rs(acc, a[s], db + 2 * s);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) fence_reg(acc[j]);

    // Accumulator 4 j + 2 hh + e: row grp + 8 hh of the warp's 16, column
    // 8 j + 2 tig + e.
    const Tile tl = decode(t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int oh = tl.oh0 + rr[hh], ow = tl.ow0 + rc[hh];
      if (!rok[hh] || oh >= g.oh || ow >= g.ow) continue;
      const long long m =
          ((static_cast<long long>(tl.n) * g.od + tl.od) * g.oh + oh) *
              g.ow + ow;
#pragma unroll
      for (int j = 0; j < kHaloBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tig;
        if (col < g.cout) {
          store_pair<kOut>(ep, m * g.cout + col, col, acc[4 * j + 2 * hh],
                           acc[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int kWG, int kOut>
int launch_halo(const int8_t* x, const int8_t* wt, const int* table,
                const Epilogue& ep, const Geometry& g, const Halo& hp,
                cudaStream_t s) {
  auto* kern = int8_conv_halo_kernel<kWG, kOut>;
  const int smem = halo_smem_bytes(hp);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kWG * 128, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Persistent: as many blocks as fit on the card, each walking tiles.
  const int gy = (g.cout + kHaloBN - 1) / kHaloBN;
  const long long cap = static_cast<long long>(per_sm) * sms / gy;
  const dim3 grid(static_cast<unsigned>(
                      cap < 1 ? 1 : (cap < hp.tiles ? cap : hp.tiles)),
                  gy);
  kern<<<grid, kWG * 128, smem, s>>>(x, wt, table, ep, g, hp);
  return static_cast<int>(cudaGetLastError());
}

template <int kOut>
int launch(const int8_t* x, const int8_t* wt, const int* table,
           const Epilogue& ep, const Geometry& g, const Halo& hp, int path,
           cudaStream_t s) {
  if (path == 0) {
    return hp.tr * hp.tw > 128
               ? launch_halo<3, kOut>(x, wt, table, ep, g, hp, s)
               : launch_halo<2, kOut>(x, wt, table, ep, g, hp, s);
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

// x: (n, d, h, w, c) int8, channels-last, 16-byte aligned; out: (n, od,
// oh, ow, cout) channels-last, int32 (out_kind 0: the exact sums) or
// float(acc) * scale[o] (+ bias[o] when bias is not null) as fp32 (1) or
// bf16 (2); cout % 8 == 0. path 1, the wgmma main loop: c % 32 == 0; wt
// (cout, kp), row o the kernel's taps in (kd, kh, kw, c) order, zero from
// k = kd*kh*kw*c to kp; kp % 128 == 0, kp <= 8192, taps per axis < 256.
// path 0, the halo loop (any c): wt (cout, kp), row o the taps in (kd, kh,
// kw) order with c padded to a multiple of 4 by zeros, zero past that to
// kp = 128 * ceil(taps * ceil(c / 4) / 32); tiles of tr output rows x tw
// output columns (tr * tw <= 192); table (kp / 4 ints) each K word's
// offset in the halo, ((td * hr + th) * hc + tw) * cw + word, 0 past K.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// a geometry it does not take.
extern "C" int lipsync_int8_conv(const void* x, const void* wt, void* out,
                                 const void* scale, const void* bias,
                                 int out_kind, int n, int d, int h, int w,
                                 int c, int kd, int kh, int kw, int sd,
                                 int sh, int sw, int pd, int ph, int pw,
                                 int od, int oh, int ow, int cout, int kp,
                                 int path, int tr, int tw, const void* table,
                                 void* stream) {
  Geometry g{n, d, h, w, c, kd, kh, kw, sd, sh, sw, pd, ph, pw, od, oh, ow,
             cout, kd * kh * kw * c, kp,
             static_cast<long long>(n) * od * oh * ow};
  const bool wgmma_ok =
      c % 32 == 0 && kp % kWgBK == 0 && kp <= 16 * kMaxChunks &&
      kd < 256 && kh < 256 && kw < 256 &&
      static_cast<long long>(kd) * h * w * c < (1LL << 31) &&
      (g.m + kWgBM - 1) / kWgBM <= 0x7fffffffLL;
  Halo hp{};
  bool halo_ok = false;
  if (path == 0 && c > 0 && tr > 0 && tw > 0 && tr * tw <= 192 &&
      table != nullptr) {
    hp.cw = (c + 3) / 4;
    hp.kblocks = (kd * kh * kw * hp.cw + 31) / 32;
    hp.ksteps = (kd * kh * kw * hp.cw + 7) / 8;
    hp.tr = tr;
    hp.tw = tw;
    hp.hr = (tr - 1) * sh + kh;
    hp.hc = (tw - 1) * sw + kw;
    hp.rs = 16 * ((hp.hc * c + 31) / 16);
    hp.nhb = (oh + tr - 1) / tr;
    hp.nwb = (ow + tw - 1) / tw;
    const long long tiles = static_cast<long long>(n) * od * hp.nhb * hp.nwb;
    hp.tiles = static_cast<int>(tiles);
    const long long words =
        static_cast<long long>(kd) * hp.hr * hp.hc * hp.cw;
    const long long smem =
        kAlign + static_cast<long long>(hp.kblocks) * (kBBlock + 128) +
        2 * 16 * ((4 * words + 15) / 16) + 2LL * kd * hp.hr * hp.rs +
        2 * 16 * ((4LL * kd * hp.hr + 15) / 16);
    if (smem <= kSmemMax && kp == 128 * hp.kblocks && tiles < (1LL << 30)) {
      hp.halo_bytes = static_cast<int>(16 * ((4 * words + 15) / 16));
      hp.stage_bytes = kd * hp.hr * hp.rs;
      hp.rows_bytes = 16 * ((4 * kd * hp.hr + 15) / 16);
      hp.total = static_cast<long long>(n) * d * h * w * c;
      halo_ok = true;
    }
  }
  if (g.m <= 0 || cout <= 0 || cout % 8 != 0 || kp < g.k ||
      (path == 0 && !halo_ok) || (path == 1 && !wgmma_ok) ||
      (path != 0 && path != 1) || out_kind < 0 || out_kind > 2 ||
      (out_kind != kOutInt32 && scale == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const int* tp = static_cast<const int*>(table);
  const Epilogue ep{out, static_cast<const float*>(scale),
                    static_cast<const float*>(bias)};
  switch (out_kind) {
    case kOutInt32:
      return launch<kOutInt32>(xp, wp, tp, ep, g, hp, path, s);
    case kOutFloat:
      return launch<kOutFloat>(xp, wp, tp, ep, g, hp, path, s);
    default:
      return launch<kOutBf16>(xp, wp, tp, ep, g, hp, path, s);
  }
}
