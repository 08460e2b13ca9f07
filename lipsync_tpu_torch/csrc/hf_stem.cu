// K2: fused high-frequency artifact stem for sm_90a.
//
// Replaces: lipsync_tpu/ops/pallas/hf_stem.py::hf_stem_fused (kernel body
// built by _make_kernel): relu(BN_eval(Conv3d 3->32, k 3x3x3, stride
// (1,2,2), zero pad 1, applied to the per-frame 3x3 pad-1 Laplacian of the
// clip, a full 3->3 channel mix) + b1), with BN and b1 folded into one
// scale and shift per channel.
//
// What bounds it on an H100: at B=16 windows of 32x96x96x3 it does ~7 GFLOP
// of fp32 FMA and moves ~210 MB (fp32), most of it the store of the
// 32-channel output. Both give about 0.1 ms at peak, so neither side may
// be wasted: the Laplacian intermediate never touches device memory, the
// input is read once per output tile (plus a thin halo), and the output is
// written once, coalesced.
//
// Design: grid (16x16 output tiles, B*T frames), 256 threads, one output
// pixel x 32 channels per thread, accumulated in fp32 registers. For each
// of the three input frames t-1..t+1 the block stages the frame's 35x35x3
// input patch in shared memory (zero outside the frame: the Laplacian's own
// padding), computes the 3->3 Laplacian at the 33x33 positions that the
// stride-2 3x3 taps read, and forces to zero every position outside
// [0,H)x[0,W) and every frame outside [0,T) (conv1's zero padding applies
// to the Laplacian output). The 81 taps are FMAs against w1 in shared
// memory (a broadcast: every thread reads the same tap). The epilogue
// applies scale/shift and ReLU, stages the tile in shared memory, and the
// block writes its 16 rows of 16 pixels x 32 channels as contiguous runs
// in the input dtype (fp32 or bf16). Tensor cores, TMA and wgmma are left
// for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 3;        // input channels
constexpr int kCo = 32;      // conv1 output channels
constexpr int kTileO = 16;   // output tile edge
constexpr int kLap = 2 * kTileO + 1;   // 33 Laplacian positions per edge
constexpr int kIn = kLap + 2;          // 35 input positions per edge
constexpr int kThreads = kTileO * kTileO;
constexpr int kStageStride = kCo + 1;  // padded row of the output stage

constexpr int kInFloats = kC * kIn * kIn;         // 3675
constexpr int kLapFloats = kC * kLap * kLap;      // 3267
constexpr int kW1Floats = 27 * kC * kCo;          // 2592
constexpr int kComputeFloats = kInFloats + kLapFloats;
constexpr int kStageFloats = kThreads * kStageStride;  // 8448
constexpr int kUnionFloats =
    kComputeFloats > kStageFloats ? kComputeFloats : kStageFloats;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hf_stem_kernel(const T* __restrict__ x,          // (B, T, H, W, 3)
               const float* __restrict__ wlap,   // (3, 3, ci, co)
               const float* __restrict__ w1,     // (3, 3, 3, ci, 32)
               const float* __restrict__ scale,  // (32,)
               const float* __restrict__ shift,  // (32,)
               T* __restrict__ out,              // (B, T, Ho, Wo, 32)
               int n_frames, int h, int w, int ho, int wo, int tiles_x) {
  __shared__ float buf[kUnionFloats];  // input + Laplacian, later the stage
  __shared__ __align__(16) float w1s[kW1Floats];
  __shared__ float wlaps[81];
  __shared__ float scs[kCo], shs[kCo];

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;             // b * T + t
  const int t = bt % n_frames;
  const int oy0 = (blockIdx.x / tiles_x) * kTileO;
  const int ox0 = (blockIdx.x % tiles_x) * kTileO;
  const int ly = tid / kTileO, lx = tid % kTileO;

  for (int i = tid; i < kW1Floats; i += kThreads) w1s[i] = w1[i];
  if (tid < 81) wlaps[tid] = wlap[tid];
  if (tid < kCo) {
    scs[tid] = scale[tid];
    shs[tid] = shift[tid];
  }

  float* in_s = buf;                 // [c][35][35]
  float* lap_s = buf + kInFloats;    // [c][33][33]
  // Laplacian position (i, j) of the tile is frame position
  // (2*oy0 - 1 + i, 2*ox0 - 1 + j); input position (i, j) is one further out.
  const int lr0 = 2 * oy0 - 1, lc0 = 2 * ox0 - 1;

  float acc[kCo];
#pragma unroll
  for (int c = 0; c < kCo; ++c) acc[c] = 0.f;

  for (int dt = 0; dt < 3; ++dt) {
    const int tf = t + dt - 1;
    if (tf < 0 || tf >= n_frames) continue;  // block-uniform: zero frame
    const T* xf = x + static_cast<size_t>(bt + dt - 1) * h * w * kC;
    __syncthreads();  // previous frame's readers are done with buf
    for (int i = tid; i < kIn * kIn * kC; i += kThreads) {
      const int c = i % kC;
      const int col = (i / kC) % kIn;
      const int row = i / (kC * kIn);
      const int r = lr0 - 1 + row, q = lc0 - 1 + col;
      float v = 0.f;
      if (r >= 0 && r < h && q >= 0 && q < w) {
        v = to_f32(xf[(static_cast<size_t>(r) * w + q) * kC + c]);
      }
      in_s[(c * kIn + row) * kIn + col] = v;
    }
    __syncthreads();
    for (int i = tid; i < kLap * kLap; i += kThreads) {
      const int row = i / kLap, col = i % kLap;
      const int r = lr0 + row, q = lc0 + col;
      float l0 = 0.f, l1 = 0.f, l2 = 0.f;
      if (r >= 0 && r < h && q >= 0 && q < w) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int ci = 0; ci < kC; ++ci) {
              const float v = in_s[(ci * kIn + row + dy) * kIn + col + dx];
              const float* wv = wlaps + ((dy * 3 + dx) * kC + ci) * kC;
              l0 = fmaf(v, wv[0], l0);
              l1 = fmaf(v, wv[1], l1);
              l2 = fmaf(v, wv[2], l2);
            }
          }
        }
      }
      lap_s[(0 * kLap + row) * kLap + col] = l0;
      lap_s[(1 * kLap + row) * kLap + col] = l1;
      lap_s[(2 * kLap + row) * kLap + col] = l2;
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          const float v = lap_s[(ci * kLap + 2 * ly + dy) * kLap + 2 * lx + dx];
          const float4* wv = reinterpret_cast<const float4*>(
              w1s + (((dt * 3 + dy) * 3 + dx) * kC + ci) * kCo);
#pragma unroll
          for (int c4 = 0; c4 < kCo / 4; ++c4) {
            const float4 wq = wv[c4];
            acc[4 * c4 + 0] = fmaf(v, wq.x, acc[4 * c4 + 0]);
            acc[4 * c4 + 1] = fmaf(v, wq.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(v, wq.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(v, wq.w, acc[4 * c4 + 3]);
          }
        }
      }
    }
  }

  __syncthreads();  // buf becomes the output stage
  float* stage = buf;
#pragma unroll
  for (int c = 0; c < kCo; ++c) {
    stage[tid * kStageStride + c] = fmaxf(fmaf(acc[c], scs[c], shs[c]), 0.f);
  }
  __syncthreads();

  // Row r of the tile is one contiguous run of n_x * 32 values.
  const int n_x = min(kTileO, wo - ox0);
  const int n_y = min(kTileO, ho - oy0);
  const int run = n_x * kCo;
  for (int i = tid; i < n_y * run; i += kThreads) {
    const int r = i / run, e = i % run;
    const int p = r * kTileO + e / kCo;
    const size_t o =
        ((static_cast<size_t>(bt) * ho + oy0 + r) * wo + ox0) * kCo + e;
    store(out + o, stage[p * kStageStride + e % kCo]);
  }
}

template <typename T>
int launch(const void* x, const float* wlap, const float* w1,
           const float* scale, const float* shift, void* out, int batch,
           int n_frames, int h, int w, int ho, int wo, cudaStream_t stream) {
  const int tiles_x = (wo + kTileO - 1) / kTileO;
  const int tiles_y = (ho + kTileO - 1) / kTileO;
  const dim3 grid(tiles_x * tiles_y, batch * n_frames);
  hf_stem_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), wlap, w1, scale, shift, static_cast<T*>(out),
      n_frames, h, w, ho, wo, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, n_frames, h, w, 3) channels-last, fp32 (dtype 0) or bf16
// (dtype 1); wlap: (3, 3, 3, 3) [dy][dx][ci][co]; w1: (3, 3, 3, 3, 32)
// [dt][dy][dx][ci][co]; scale, shift: (32,) folded BN; out: (batch,
// n_frames, ho, wo, 32) in the dtype of x. Returns cudaGetLastError() of
// the launch, or cudaErrorInvalidValue for an unknown dtype.
extern "C" int lipsync_hf_stem(const void* x, int dtype, const float* wlap,
                               const float* w1, const float* scale,
                               const float* shift, void* out, int batch,
                               int n_frames, int h, int w, int ho, int wo,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, wlap, w1, scale, shift, out, batch, n_frames, h,
                         w, ho, wo, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, wlap, w1, scale, shift, out, batch,
                                 n_frames, h, w, ho, wo, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
