// K5: the 3D stem of AV-HuBERT and of Auto-AVSR in one launch for sm_90a:
// Conv3d 1 -> 64, k(5, 7, 7), s(1, 2, 2), p(2, 3, 3), no bias; eval
// BatchNorm; PReLU (AV-HuBERT) or Swish (Auto-AVSR), one instantiation
// each; max-pool (1, 3, 3) / (1, 2, 2) / (0, 1, 1). bf16 in, bf16 out.
//
// Replaces: no TPU kernel. AV-HuBERT exists only in the port
// (models/avhubert.py::ResEncoder.frontend3D). cuDNN has no tensor-core
// kernel it picks for one input channel and 245 taps, so the module chain
// runs the convolution as an fp32 SIMT implicit GEMM (with bf16 <-> fp32
// conversions around it), then BatchNorm, PReLU and the pool as three
// passes over its 2 GB output a group of 256 windows, the pool also
// writing int64 indices that eval never reads.
//
// What bounds it on an H100: a conv output position is 2 x 245 x 64 =
// 31,360 operations, against 8 bytes of bf16 input (four pixels a
// position at stride 2) and 32 bytes of pooled bf16 output (64 channels a
// quarter of the positions): 784 operations a byte, well above the 295 at
// which the bf16 tensor cores, and not the memory, are the limit. At the
// main path's group (256 x 32 frames of 88 x 88, 15.86 M positions) that
// is 497 GFLOP, 0.50 ms at 989 TFLOP/s, against 127 MB in and 508 MB out,
// 0.19 ms at 3.35 TB/s. So the design keeps every intermediate on the SM
// and feeds the tensor cores from shared memory:
//
//   - Main loop: wgmma.mma_async m64n64k16 bf16 x bf16 -> fp32, A from
//     registers, B (the weights) resident in shared memory for the
//     block's life, 128-byte-swizzled and K-major (packed once per call by
//     the wrapper in that byte order: ops/kernels/av_stem.py::pack_weights).
//     wgmma and not mma.sync: one instruction covers 64 x 64 x 16 for the
//     four warps of a warpgroup, so no warp loads B fragments, and the
//     gathers below are the only shared-memory reads of the loop.
//   - K: the 35 tap rows (dt, dy), 8 taps a row: tap dx' = dx + 1, with
//     dx' = 0 a zero weight, so K = 280, padded to 288 (18 k16 steps, the
//     last half zero). A K step holds two tap rows, and thread tig's A
//     pairs are taps dx' = 2 tig, 2 tig + 1 of each: two neighbouring
//     pixels of one input row, one aligned 32-bit shared load at a
//     compile-time offset from a per-row base. 245 taps padded to 256
//     would save 11% of the products but straddle rows and halves of
//     words, and cost a table lookup and a shift per pair.
//   - A persistent block (two per SM) walks tiles of 5 x 11 pooled
//     outputs of one frame. A tile's conv outputs are 11 x 23 positions
//     (253 GEMM rows, four m64 tiles: two per warpgroup, one each where
//     the rows the pool reads fit in two), the pool's one-row and
//     one-column halo recomputed rather than exchanged between blocks.
//     Its input, 5 frames x 27 rows x 52 columns with the zero padding at
//     every edge, lands in a shared halo by 4-byte cp.async while the
//     previous tile computes.
//   - Epilogue, in registers: the fp32 sum rounded to bf16; the eval
//     BatchNorm in fp32 by the formula of PyTorch's kernel for a
//     contiguous input, gamma * (x - mean) * invstd + beta with invstd =
//     rsqrt(var + eps), rounded to bf16; PReLU with the bf16 slope,
//     x > 0 ? x : bf16(slope * x), or Swish, bf16(x / (1 + exp(-x))) in
//     fp32 as PyTorch's silu computes it (in a pass of its own over the
//     shared tile, where its exp and division hold none of the epilogue's
//     accumulators). Each activation is applied at every conv
//     position before the 3 x 3 max: Swish is not monotonic, so it may
//     not follow the pool. The results go to a shared tile (-inf
//     at positions outside the frame), then all 256 threads take the 3 x
//     3 max over bf16 pairs (NaN wins, as in PyTorch's pool) and write the
//     pooled (B, T, 64, Hp, Wp) output: the (B * T, 64, Hp, Wp) frames that
//     the ResNet trunk reads, so the trunk's copy of them goes too.
//
// So the kernel rounds where the module chain rounds, and differs from it
// only in the order of the convolution's fp32 sum (and, of a +0 and a -0
// tied for a pool's max, in keeping the +0 where PyTorch keeps the first).
// On an H100 it takes 2.1-2.2 ms a group against the chain's 42.8 ms and
// its bound's 0.50: 23% of the bound. With a phase cut out at a time it
// takes 1.17 ms without the wgmma loop, 1.69 without BatchNorm and PReLU,
// 1.68 without the pool and 1.88 without the staging: the phases of a
// block run one after another and two blocks an SM do not hide them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;              // output channels
constexpr int kFrames = 5;          // temporal taps
constexpr int kTapRows = 35;        // (dt, dy): 5 x 7
constexpr int kTapW = 7;            // taps along a row
constexpr int kSteps = 18;          // k16 steps over K = 288
constexpr int kKBlocks = 5;         // 64 K elements (128 bytes) each
constexpr int kBBlock = kC * 128;   // bytes of one K block of B
constexpr int kP = 5, kQ = 11;      // pooled rows x columns of a tile
constexpr int kCR = 2 * kP + 1;     // conv rows of a tile (one halo row)
constexpr int kCC = 2 * kQ + 1;     // conv columns (one halo column)
constexpr int kPos = kCR * kCC;     // 253 GEMM rows
constexpr int kWG = 2;              // warpgroups, two m64 tiles each
constexpr int kThreads = 128 * kWG;
constexpr int kHR = 4 * kP + 7;     // halo rows a frame
constexpr int kHW = 2 * kQ + 4;     // 32-bit words a halo row holds data in
// Words a halo row: 2 x 29 = 26 (mod 32), so the 8 positions of a
// fragment's rows, across a wrap to the next conv row, hit distinct banks.
constexpr int kRW = 29;
constexpr int kPlane = kHR * kRW;
// Words of one halo buffer, rounded up to 16 bytes.
constexpr int kHalo = (kFrames * kPlane + 3) / 4 * 4;
// Words between channel pairs of the conv tile: 264 = 8 (mod 32), so the
// epilogue's stores (8 positions x 4 channel pairs a warp) are conflict
// free.
constexpr int kOS = 264;
constexpr int kAlign = 1024;        // a 128-byte swizzle atom is 1 KB
constexpr uint32_t kNegInf2 = 0xff80ff80u;  // a pair of bf16 -inf
constexpr int kGroup = 2;           // k16 steps gathered per wgmma group

constexpr int kSmemBytes = kAlign + kKBlocks * kBBlock + 2 * kHalo * 4 +
                           (kC / 2) * kOS * 4 + kC * 5 * 4;

struct Geom {
  int b, t, h, w;       // input (B, T, H, W), one channel
  int ho, wo, hp, wp;   // conv and pooled extents
  int nty, ntx;         // tiles along hp and wp
  int tiles;            // b * t * nty * ntx
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// K-major, 128-byte swizzle, 8-row groups 1024 bytes apart; the leading
// byte offset is unused while a k16 slice (32 bytes) lies inside a row.
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

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// The compiler may not move reads or writes of r across this point.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x 64 fp32, 32 registers a thread) += A (64 x 16 bf16: four 32-bit
// registers a thread, the m16n8k16 A fragment of each warp's 16 rows) *
// B (64 x 16)^T, B K-major in shared memory described by db.
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Halo word offset of tap row r (dt = r / 7, dy = r % 7).
__host__ __device__ constexpr int row_offset(int r) {
  return (r / kTapW) * kPlane + (r % kTapW) * kRW;
}

struct Tile {
  int bt;        // frame index b * T + t
  int t;         // its frame within the clip
  int py0, px0;  // first pooled row and column
};

__device__ __forceinline__ Tile decode(const Geom& g, int tile) {
  Tile tl;
  int q = tile / g.ntx;
  tl.px0 = (tile - q * g.ntx) * kQ;
  const int r = q / g.nty;
  tl.py0 = (q - r * g.nty) * kP;
  tl.bt = r;
  tl.t = r % g.t;
  return tl;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Swish of a bf16 value in fp32, by the formula of PyTorch's silu kernel
// (x / (1 + exp(-x)), full-precision expf and division).
__device__ __forceinline__ float swish(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// Swish of a pair of bf16 values (one word, as the conv tile holds them),
// each in fp32 and rounded to bf16.
__device__ __forceinline__ uint32_t swish2(uint32_t z) {
  return bits(__floats2bfloat162_rn(swish(__uint_as_float(z << 16)),
                                    swish(__uint_as_float(z & 0xffff0000u))));
}

// Two channels' conv sums (c, c + 1) through BatchNorm and, with PReLU, the
// activation, as the module chain rounds them: the sums to bf16, BatchNorm
// in fp32 (p = {gamma, mean, invstd, beta} of each channel) to bf16, then
// x > 0 ? x : slope * x in bf16 (the exact product rounded once). With
// kSwish the BatchNorm's pair alone: Swish follows over the shared tile
// (swish2), where its exp and division hold none of the accumulators'
// registers. Returns the pair as one word, channel c in the low half.
template <bool kSwish>
__device__ __forceinline__ uint32_t bn_act(float acc0, float acc1,
                                           const float4& p0,
                                           const float4& p1,
                                           __nv_bfloat162 slope) {
  const uint32_t y = bits(__floats2bfloat162_rn(acc0, acc1));
  const float y0 = __uint_as_float(y << 16);
  const float y1 = __uint_as_float(y & 0xffff0000u);
  const __nv_bfloat162 z = __floats2bfloat162_rn(
      __fmaf_rn(__fmul_rn(p0.x, __fsub_rn(y0, p0.y)), p0.z, p0.w),
      __fmaf_rn(__fmul_rn(p1.x, __fsub_rn(y1, p1.y)), p1.z, p1.w));
  if constexpr (kSwish) {
    return bits(z);
  } else {
    const uint32_t pos = __hgt2_mask(z, __float2bfloat162_rn(0.0f));
    return (bits(z) & pos) | (bits(__hmul2(slope, z)) & ~pos);
  }
}

// The tile's input: frame f (t + f - 2), halo row r (input row 4 py0 - 5
// + r), halo word c (input columns 4 px0 - 6 + 2 c and the next) into
// word (f * kHR + r) * kRW + c of the buffer; zero outside the clip.
// Thread tid < 9 kHW copies word c = tid % kHW of rows r0 + 9 q of every
// frame (r0 = tid / kHW), so the loop holds no division. With kAligned (W
// even, x 4-byte aligned) every word is one 4-byte cp.async; otherwise two
// 2-byte loads and one store.
constexpr int kRowStep = 9;
static_assert(kHR % kRowStep == 0 && kHW * kRowStep <= kThreads,
              "the halo's rows split evenly among the staging threads");

template <bool kAligned>
__device__ __forceinline__ void load_halo(const __nv_bfloat16* x,
                                          const Geom& g, const Tile& tl,
                                          uint32_t* buf, int tid) {
  if (tid >= kHW * kRowStep) return;
  const int r0 = tid / kHW, c = tid - r0 * kHW;
  const int iy0 = 4 * tl.py0 - 5 + r0, ix = 4 * tl.px0 - 6 + 2 * c;
  const long long frame = static_cast<long long>(g.h) * g.w;
  const long long base =
      (static_cast<long long>(tl.bt - 2) * g.h + iy0) * g.w + ix;
  const bool lo_ok = static_cast<unsigned>(ix) < static_cast<unsigned>(g.w);
  const bool hi_ok =
      static_cast<unsigned>(ix + 1) < static_cast<unsigned>(g.w);
  uint32_t* dst = buf + r0 * kRW + c;
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    const bool f_ok =
        static_cast<unsigned>(tl.t + f - 2) < static_cast<unsigned>(g.t);
#pragma unroll
    for (int q = 0; q < kHR / kRowStep; ++q) {
      const bool row_ok =
          f_ok && static_cast<unsigned>(iy0 + kRowStep * q) <
                      static_cast<unsigned>(g.h);
      const long long off = base + f * frame + kRowStep * q * g.w;
      uint32_t* d = dst + (f * kHR + kRowStep * q) * kRW;
      if constexpr (kAligned) {
        const bool ok = row_ok && lo_ok;
        cp_async4(smem_u32(d), ok ? x + off : x, ok ? 4 : 0);
      } else {
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
        uint32_t v = 0;
        if (row_ok && lo_ok) v = xs[off];
        if (row_ok && hi_ok) v |= static_cast<uint32_t>(xs[off + 1]) << 16;
        *d = v;
      }
    }
  }
}

// acc[u] = the conv sums of GEMM rows rb[u] (m64 tile wg + 2 u of the
// tile) for u < kTiles, over all of K: each group of kGroup k16 steps
// gathers its A fragments from the halo hb (one 32-bit load a pair of
// taps), then issues their wgmma and waits for them. (Gathering a step
// ahead of the wgmma in flight measured no faster, and spilled.)
template <int kTiles>
__device__ __forceinline__ void conv_tiles(float (&acc)[2][32],
                                           const uint32_t* hb,
                                           const int (&rb)[2][2],
                                           uint32_t sb) {
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[u][e] = 0.0f;
  }
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kGroup) {
    // K step ks: tap rows 2 ks (k 0-7) and 2 ks + 1 (k 8-15; row 35, past
    // K, has zero weights and reads row 34).
    uint32_t a[kGroup][kTiles][4];
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const int o0 = row_offset(2 * (s0 + s));
      const int o1 = row_offset(min(2 * (s0 + s) + 1, kTapRows - 1));
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        a[s][u][0] = hb[rb[u][0] + o0];
        a[s][u][1] = hb[rb[u][1] + o0];
        a[s][u][2] = hb[rb[u][0] + o1];
        a[s][u][3] = hb[rb[u][1] + o1];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const int ks = s0 + s;
      const uint64_t db = smem_desc(sb + (ks >> 2) * kBBlock) + 2 * (ks & 3);
#pragma unroll
      for (int u = 0; u < kTiles; ++u) wgmma_bf16(acc[u], a[s][u], db);
    }
    wgmma_commit();
    wgmma_wait_all();
  }
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
#pragma unroll
    for (int e = 0; e < 32; ++e) fence_reg(acc[u][e]);
  }
}

template <bool kAligned, bool kSwish>
__global__ void __launch_bounds__(kThreads, 2)
av_stem_kernel(const __nv_bfloat16* __restrict__ x,   // (B, T, H, W)
               const __nv_bfloat16* __restrict__ wpk, // B's shared image
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ mean, const float* __restrict__ var,
               const __nv_bfloat16* __restrict__ slope,  // PReLU only
               float eps,
               __nv_bfloat16* __restrict__ out,        // (B, T, 64, Hp, Wp)
               const Geom g) {
  extern __shared__ uint8_t dyn[];
  const uint32_t raw = smem_u32(dyn);
  const uint32_t pad = ((raw + kAlign - 1) & ~(kAlign - 1u)) - raw;
  const uint32_t sb = raw + pad;  // B: kKBlocks x (64 rows x 128 bytes)
  uint32_t* halo = reinterpret_cast<uint32_t*>(dyn + pad + kKBlocks * kBBlock);
  uint32_t* conv = halo + 2 * kHalo;  // (32 channel pairs) x kOS words
  float4* prm = reinterpret_cast<float4*>(conv + (kC / 2) * kOS);
  __nv_bfloat162* slp = reinterpret_cast<__nv_bfloat162*>(prm + kC);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  // B, resident for the block's life: the wrapper's image, copied as is.
  for (int i = tid; i < kKBlocks * kBBlock / 16; i += kThreads) {
    cp_async16(sb + 16 * i, reinterpret_cast<const uint8_t*>(wpk) + 16 * i);
  }
  cp_async_commit();
  if (tid < kC) {
    prm[tid] = make_float4(gamma[tid], mean[tid], rsqrtf(var[tid] + eps),
                           beta[tid]);
  }
  if (!kSwish && tid < kC / 2) {
    slp[tid] = reinterpret_cast<const __nv_bfloat162*>(slope)[tid];
  }

  // This thread's four GEMM rows (grp and grp + 8 of its warp's 16, in
  // m64 tiles wg and wg + 2): the halo word of tap row 0, pair tig. A row
  // past the tile reads position 0 and stores nothing.
  int rb[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = 64 * (wg + 2 * u) + 16 * warp + grp + 8 * hh;
      const int p = m < kPos ? m : 0;
      const int i = p / kCC, j = p - i * kCC;
      rb[u][hh] = 2 * i * kRW + j + tig;
    }
  }

  const int t0 = blockIdx.x, tstep = gridDim.x;
  const int count = t0 < g.tiles ? (g.tiles - 1 - t0) / tstep + 1 : 0;
  if (count > 0) load_halo<kAligned>(x, g, decode(g, t0), halo, tid);
  cp_async_commit();
  cp_async_wait_all();  // B
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  for (int it = 0; it < count; ++it) {
    const int buf = it & 1;
    const Tile tl = decode(g, t0 + it * tstep);
    // The tile's halo has landed; past the barrier every thread has also
    // pooled the previous tile and multiplied out of the other buffer.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < count) {
      load_halo<kAligned>(x, g, decode(g, t0 + (it + 1) * tstep),
                          halo + (buf ^ 1) * kHalo, tid);
    }
    cp_async_commit();

    // Conv positions the pool reads: rows 0 .. 2 P' of the 11 for the
    // tile's P' pooled rows. One m64 tile a warpgroup where they fit in
    // two (the last row of tiles at Hp = 22), else two. The choice is the
    // block's alone, so every warp of a warpgroup issues the same wgmma.
    const int need = (2 * min(kP, g.hp - tl.py0) + 1) * kCC;
    const int nt = need > 128 ? 2 : 1;
    float acc[2][32];
    if (nt == 2) {
      conv_tiles<2>(acc, halo + buf * kHalo, rb, sb);
    } else {
      conv_tiles<1>(acc, halo + buf * kHalo, rb, sb);
    }

    // Accumulator 4 j + 2 hh + e: row grp + 8 hh of the warp's 16,
    // channel 8 j + 2 tig + e; stored as word (4 j + tig) * kOS + row. A
    // position outside the frame (the halo row or column at its edges)
    // stores -inf, which the pool's max never keeps.
    int row[2][2];
    bool inside[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * (wg + 2 * u) + 16 * warp + grp + 8 * hh;
        const int i = m / kCC, j = m - i * kCC;
        row[u][hh] = u < nt && m < kPos ? m : -1;
        inside[u][hh] = static_cast<unsigned>(2 * tl.py0 - 1 + i) <
                            static_cast<unsigned>(g.ho) &&
                        static_cast<unsigned>(2 * tl.px0 - 1 + j) <
                            static_cast<unsigned>(g.wo);
      }
    }
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float4 p0 = prm[c], p1 = prm[c + 1];
      const __nv_bfloat162 sl =
          kSwish ? __float2bfloat162_rn(0.0f) : slp[c / 2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (row[u][hh] < 0) continue;
          const uint32_t v = bn_act<kSwish>(
              acc[u][4 * j + 2 * hh], acc[u][4 * j + 2 * hh + 1], p0, p1, sl);
          conv[(4 * j + tig) * kOS + row[u][hh]] =
              inside[u][hh] ? v : kNegInf2;
        }
      }
    }
    __syncthreads();
    if constexpr (kSwish) {
      // Swish over the conv positions the pool reads (a word of -inf,
      // outside the frame, stays -inf for the pool), before the max: Swish
      // is not monotonic, so it may not follow the pool. Thread tid takes
      // position tid of each channel pair in turn, one word at a time:
      // strided over the whole tile or unrolled, the pass spilled at 128
      // registers a thread.
      if (tid < need) {
        uint32_t* w = conv + tid;
#pragma unroll 1
        for (int cp = 0; cp < kC / 2; ++cp, w += kOS) {
          const uint32_t z = *w;
          if (z != kNegInf2) *w = swish2(z);
        }
      }
      __syncthreads();
    }

    // The pool: thread tid % 64 takes pooled position (a, b) of the tile,
    // and channel pairs tid / 64 + 4 k: the max of its nine conv positions
    // as bf16 pairs (NaN wins; of +0 and -0 it keeps +0 where PyTorch keeps
    // the first, an equal value), one bf16 to each channel's plane.
    const int pp = tid & 63, a = pp / kQ, b = pp - a * kQ;
    const int py = tl.py0 + a, px = tl.px0 + b;
    if (pp < kP * kQ && py < g.hp && px < g.wp) {
      const long long plane = static_cast<long long>(g.hp) * g.wp;
      __nv_bfloat16* o = out + static_cast<long long>(tl.bt) * kC * plane +
                         static_cast<long long>(py) * g.wp + px;
      const uint32_t* src = conv + (2 * a) * kCC + 2 * b;
#pragma unroll
      for (int k = 0; k < kC / 2 / 4; ++k) {
        const int cp = (tid >> 6) + 4 * k;
        const uint32_t* q = src + cp * kOS;
        __nv_bfloat162 mx = __hmax2_nan(
            __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(q),
                        *reinterpret_cast<const __nv_bfloat162*>(q + 1)),
            *reinterpret_cast<const __nv_bfloat162*>(q + 2));
#pragma unroll
        for (int di = 1; di < 3; ++di) {
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            mx = __hmax2_nan(mx, *reinterpret_cast<const __nv_bfloat162*>(
                                     q + di * kCC + dj));
          }
        }
        o[(2 * cp) * plane] = mx.x;
        o[(2 * cp + 1) * plane] = mx.y;
      }
    }
  }
  cp_async_wait_all();
}

template <bool kAligned, bool kSwish>
int blocks_per_sm_of(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      av_stem_kernel<kAligned, kSwish>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, av_stem_kernel<kAligned, kSwish>, kThreads, kSmemBytes);
  return static_cast<int>(err);
}

int blocks_per_sm_of(bool aligned, bool swish, int* per_sm) {
  if (swish) {
    return aligned ? blocks_per_sm_of<true, true>(per_sm)
                   : blocks_per_sm_of<false, true>(per_sm);
  }
  return aligned ? blocks_per_sm_of<true, false>(per_sm)
                 : blocks_per_sm_of<false, false>(per_sm);
}

template <bool kSwish>
void launch(bool aligned, dim3 grid, cudaStream_t s,
            const __nv_bfloat16* x, const __nv_bfloat16* wpk,
            const float* gamma, const float* beta, const float* mean,
            const float* var, const __nv_bfloat16* slope, float eps,
            __nv_bfloat16* out, const Geom& g) {
  if (aligned) {
    av_stem_kernel<true, kSwish><<<grid, kThreads, kSmemBytes, s>>>(
        x, wpk, gamma, beta, mean, var, slope, eps, out, g);
  } else {
    av_stem_kernel<false, kSwish><<<grid, kThreads, kSmemBytes, s>>>(
        x, wpk, gamma, beta, mean, var, slope, eps, out, g);
  }
}

}  // namespace

// x: (B, T, H, W) bf16, contiguous (the (B, 1, T, H, W) stem input); wpk:
// the weights as ops/kernels/av_stem.py::pack_weights lays them out
// (kKBlocks * 64 * 64 bf16, 16-byte aligned); gamma, beta, mean, var: the
// BatchNorm's 64 fp32 weight, bias, running mean and running variance;
// slope: the PReLU's 64 bf16 slopes (4-byte aligned), unread (and may be
// null) when swish != 0, which takes Swish in PReLU's place; out: (B, T,
// 64, Hp, Wp) bf16, contiguous, Hp = (Ho - 1) / 2 + 1 with Ho = (H - 1) /
// 2 + 1 (and so for W). Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a geometry it does not take.
extern "C" int lipsync_av_stem(const void* x, const void* wpk,
                               const void* gamma, const void* beta,
                               const void* mean, const void* var,
                               const void* slope, float eps, void* out, int b,
                               int t, int h, int w, int swish, void* stream) {
  if (b < 1 || t < 1 || h < 1 || w < 1 ||
      reinterpret_cast<uintptr_t>(wpk) % 16 != 0 ||
      (swish == 0 && (slope == nullptr ||
                      reinterpret_cast<uintptr_t>(slope) % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom g{};
  g.b = b;
  g.t = t;
  g.h = h;
  g.w = w;
  g.ho = (h - 1) / 2 + 1;
  g.wo = (w - 1) / 2 + 1;
  g.hp = (g.ho - 1) / 2 + 1;
  g.wp = (g.wo - 1) / 2 + 1;
  g.nty = (g.hp + kP - 1) / kP;
  g.ntx = (g.wp + kQ - 1) / kQ;
  const long long tiles = static_cast<long long>(b) * t * g.nty * g.ntx;
  if (tiles >= (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  const bool aligned = w % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int occ = blocks_per_sm_of(aligned, swish != 0, &per_sm);
  if (occ != 0) return occ;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Persistent: as many blocks as fit on the card, each walking tiles.
  const long long cap = static_cast<long long>(per_sm) * sms;
  const dim3 grid(static_cast<unsigned>(cap < tiles ? cap : tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(wpk);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  const auto* mp = static_cast<const float*>(mean);
  const auto* vp = static_cast<const float*>(var);
  const auto* sp = static_cast<const __nv_bfloat16*>(slope);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (swish != 0) {
    launch<true>(aligned, grid, s, xp, wp, gp, bp, mp, vp, sp, eps, op, g);
  } else {
    launch<false>(aligned, grid, s, xp, wp, gp, bp, mp, vp, sp, eps, op, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel (the 4-byte cp.async variant when aligned != 0; the
// Swish instantiation when swish != 0) one SM holds at once, or minus the
// CUDA error.
extern "C" int lipsync_av_stem_blocks_per_sm(int aligned, int swish) {
  int per_sm = 0;
  const int err = blocks_per_sm_of(aligned != 0, swish != 0, &per_sm);
  return err != 0 ? -err : per_sm;
}
