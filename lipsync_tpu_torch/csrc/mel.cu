// K1: fused log-mel spectrogram for sm_90a.
//
// Replaces: lipsync_tpu/ops/pallas/mel_kernel.py::log_mel_spectrogram_pallas
// (kernel body _mel_block_kernel): frames @ Hann-folded DFT cos/sin bases,
// c^2 + s^2, @ the Slaney mel filterbank, 10*log10(max(., 1e-10)).
//
// What bounds it on an H100: a 4 s clip (65536 samples, 410 frames) needs
// ~0.15 GFLOP of fp32 FMA and ~1 MB of traffic, so it is bound by
// operations on the fp32 SIMT units (bf16 or TF32 tensor cores would cost
// dB at quiet bands, as anything short of HIGHEST precision does on the
// TPU). At that size the bound is a few microseconds; what the card can
// reach depends on spreading the work over all 132 SMs.
//
// Design: grid (tiles of F frames, clips), 896 threads: 7 warps of 32
// consecutive DFT bins (224 >= 201) times 4 slices of 100 samples. F is 3
// (137 blocks at 65536 samples, so every SM gets one) or, where there are
// frames enough for every SM at 8, 8 (more FMAs per twiddle read). A block
// windows its F frames into shared memory once, (x * w) as float4s per
// sample, so a warp's frame reads are broadcasts. Instead of the (400, 201)
// bases (643 KB, which every block would stream from L2), the DFT reads one
// 400-entry cos/sin twiddle table at (n * k) mod 400 from shared memory,
// skewed by one word per 32 entries to spread the power-of-two strides over
// the banks. Each thread keeps the cos and sin sums of its bin for F frames
// over its 100 samples; the 4 slices meet in shared memory and add
// pairwise, then c^2 + s^2. The mel projection reads only each band's
// nonzero bins (its support, from the wrapper) in bin order, which gives the
// dense sum's result, and the dB values are stored as (80, T). The clip-max
// reference and the -top_db floor stay in the wrapper, as they sit outside
// the Pallas body.

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;  // 201
constexpr int kMels = 80;
constexpr int kSlices = 4;                        // sample slices
constexpr int kSlice = kNFFT / kSlices;           // 100 samples each
constexpr int kBinWarps = (kBins + 31) / 32;      // 7
constexpr int kThreads = kBinWarps * kSlices * 32;  // 896
constexpr int kTw = kNFFT + kNFFT / 32;           // skewed twiddle table

__device__ __forceinline__ int skew(int m) { return m + (m >> 5); }

template <int kF>
struct Smem {
  static constexpr int kF4 = (kF + 3) / 4;  // float4s per windowed sample
  static constexpr int kXw = 0;             // float4 xw[kNFFT][kF4]
  static constexpr int kCs = kXw + kNFFT * kF4 * 4;
  static constexpr int kSn = kCs + kTw;
  static constexpr int kPart = kSn + kTw;   // [kSlices][kF][2][kBins]
  static constexpr int kPower = kPart + kSlices * kF * 2 * kBins;
  static constexpr int kBytes = (kPower + kF * kBins) * 4;
};

// Two blocks of 3 frames share an SM (32 registers a thread); a block of 8
// frames needs more registers for its 16 sums and has an SM to itself.
template <int kF>
__global__ void __launch_bounds__(kThreads, kF == 3 ? 2 : 1)
log_mel_kernel(const float* __restrict__ y, const float* __restrict__ win,
               const float* __restrict__ twc, const float* __restrict__ tws,
               const float* __restrict__ fbt, const int* __restrict__ bands,
               float* __restrict__ out, int n, int n_frames) {
  using S = Smem<kF>;
  constexpr int kF4 = S::kF4;
  extern __shared__ __align__(16) float smem[];
  float4* xw = reinterpret_cast<float4*>(smem + S::kXw);
  float* cs = smem + S::kCs;
  float* sn = smem + S::kSn;
  float* part = smem + S::kPart;
  float* power = smem + S::kPower;

  const int tid = threadIdx.x;
  const int clip = blockIdx.y;
  const int f0 = blockIdx.x * kF;
  const float* yc = y + static_cast<size_t>(clip) * n;

  // Sample i of frame f is sample (f0 + f) * hop + i - n_fft / 2 of the
  // clip (centre padding with zeros).
  for (int i = tid; i < kNFFT; i += kThreads) {
    const float wv = win[i];
    float v[kF4 * 4];
#pragma unroll
    for (int f = 0; f < kF4 * 4; ++f) {
      const int src = (f0 + f) * kHop + i - kNFFT / 2;
      v[f] = (f < kF && src >= 0 && src < n) ? yc[src] * wv : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kF4; ++q) {
      xw[i * kF4 + q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    cs[skew(i)] = twc[i];
    sn[skew(i)] = tws[i];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int s = warp % kSlices;
  const int k = (warp / kSlices) * 32 + (tid & 31);
  if (k < kBins) {
    float c[kF4 * 4], sv[kF4 * 4];
#pragma unroll
    for (int f = 0; f < kF4 * 4; ++f) c[f] = sv[f] = 0.f;
    const int n0 = s * kSlice;
    int idx = (n0 * k) % kNFFT;
    for (int j = 0; j < kSlice; ++j) {
      const int p = skew(idx);
      const float a = cs[p], b = sn[p];
#pragma unroll
      for (int q = 0; q < kF4; ++q) {
        const float4 xv = xw[(n0 + j) * kF4 + q];  // a broadcast
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e < kF) {
            c[4 * q + e] = fmaf(x4[e], a, c[4 * q + e]);
            sv[4 * q + e] = fmaf(x4[e], b, sv[4 * q + e]);
          }
        }
      }
      idx += k;
      if (idx >= kNFFT) idx -= kNFFT;
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      part[((s * kF + f) * 2 + 0) * kBins + k] = c[f];
      part[((s * kF + f) * 2 + 1) * kBins + k] = sv[f];
    }
  }
  __syncthreads();

  // The 4 slices' partial sums add pairwise, then c^2 + s^2.
  auto slice_sum = [&](int f, int cs_, int kk) {
    const float* q = part + (f * 2 + cs_) * kBins + kk;
    constexpr int kStride = kF * 2 * kBins;
    return (q[0] + q[kStride]) + (q[2 * kStride] + q[3 * kStride]);
  };
  for (int i = tid; i < kF * kBins; i += kThreads) {
    const int f = i / kBins, kk = i % kBins;
    const float c = slice_sum(f, 0, kk), sv = slice_sum(f, 1, kk);
    power[f * kBins + kk] = c * c + sv * sv;
  }
  __syncthreads();

  float* oc = out + static_cast<size_t>(clip) * kMels * n_frames;
  for (int i = tid; i < kF * kMels; i += kThreads) {
    const int m = i / kF, f = i % kF;
    const int t = f0 + f;
    if (t >= n_frames) continue;
    float acc = 0.f;
    for (int kk = bands[2 * m]; kk <= bands[2 * m + 1]; ++kk) {
      acc = fmaf(power[f * kBins + kk], __ldg(fbt + kk * kMels + m), acc);
    }
    oc[static_cast<size_t>(m) * n_frames + t] =
        10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

template <int kF>
int launch(const float* y, const float* win, const float* twc,
           const float* tws, const float* fbt, const int* bands, float* out,
           int batch, int n, int n_frames, cudaStream_t stream) {
  auto kernel = log_mel_kernel<kF>;
  constexpr int kBytes = Smem<kF>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kF - 1) / kF, batch);
  kernel<<<grid, kThreads, kBytes, stream>>>(y, win, twc, tws, fbt, bands,
                                             out, n, n_frames);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (batch, n) fp32 clips; win: (400,) Hann window; twc, tws: (400,)
// cos and sin of 2*pi*m/400; fbt: (201, 80) transposed mel filterbank;
// bands: (80, 2) first and last nonzero bin of each mel band; out:
// (batch, 80, n_frames) dB with n_frames = 1 + n / 160; frames_per_block:
// 3 or 8. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for another frames_per_block.
extern "C" int lipsync_log_mel(const float* y, const float* win,
                               const float* twc, const float* tws,
                               const float* fbt, const int* bands, float* out,
                               int batch, int n, int n_frames,
                               int frames_per_block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames_per_block == 3) {
    return launch<3>(y, win, twc, tws, fbt, bands, out, batch, n, n_frames, s);
  }
  if (frames_per_block == 8) {
    return launch<8>(y, win, twc, tws, fbt, bands, out, batch, n, n_frames, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
