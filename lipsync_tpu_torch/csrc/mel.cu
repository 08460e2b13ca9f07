// K1: fused log-mel spectrogram for sm_90a.
//
// Replaces: lipsync_tpu/ops/pallas/mel_kernel.py::log_mel_spectrogram_pallas
// (kernel body _mel_block_kernel): frames @ Hann-folded DFT cos/sin bases,
// c^2 + s^2, @ the Slaney mel filterbank, 10*log10(max(., 1e-10)).
//
// What bounds it on an H100: a 4 s clip (65536 samples, 410 frames) needs
// ~0.15 GFLOP of fp32 FMA and ~1 MB of traffic, so it is bound by
// operations on the fp32 SIMT units (bf16 or TF32 tensor cores would cost
// dB at low power, as HIGHEST precision does on the TPU). At peak that is a
// few microseconds; with one launch per request and a few dozen blocks, the
// latency of each block's serial loop over the 400 samples sets the time.
//
// Design: grid (tiles of 32 frames, clips), 256 threads. A block copies its
// span of the centre-padded PCM ((32-1)*160+400 samples, zeros outside the
// clip) into shared memory once and reads frames from there at hop stride,
// so no (T, 400) frame matrix is ever written to device memory. Thread k
// (k < 201) owns DFT bin k and keeps the cos and sin sums of all 32 frames
// in registers while it streams the fp32 tables (coalesced across bins,
// resident in L1/L2 after the first block); every frame sample it needs is
// a shared-memory broadcast. Powers go to shared memory, the 201->80 mel
// projection reads them there, and the dB values are stored as (80, T),
// coalesced along T. The clip-max reference and the -top_db floor stay in
// the wrapper, as they sit outside the Pallas body.

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;  // 201
constexpr int kMels = 80;
constexpr int kTile = 32;                           // frames per block
constexpr int kSpan = (kTile - 1) * kHop + kNFFT;   // 5360 samples
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ y, const float* __restrict__ wc,
               const float* __restrict__ ws, const float* __restrict__ fbt,
               float* __restrict__ out, int n, int n_frames) {
  __shared__ float span[kSpan];
  __shared__ float power[kTile * kBins];

  const int clip = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const float* yc = y + static_cast<size_t>(clip) * n;

  // Sample i of the span is sample f0*hop + i of the centre-padded signal,
  // i.e. sample f0*hop + i - n_fft/2 of the clip.
  const int base = f0 * kHop - kNFFT / 2;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    const int src = base + i;
    span[i] = (src >= 0 && src < n) ? yc[src] : 0.f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kBins) {
    float c[kTile], s[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      c[f] = 0.f;
      s[f] = 0.f;
    }
    for (int j = 0; j < kNFFT; ++j) {
      const float a = __ldg(wc + j * kBins + k);
      const float b = __ldg(ws + j * kBins + k);
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
        const float x = span[f * kHop + j];
        c[f] = fmaf(x, a, c[f]);
        s[f] = fmaf(x, b, s[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTile; ++f) {
      power[f * kBins + k] = c[f] * c[f] + s[f] * s[f];
    }
  }
  __syncthreads();

  // One (frame, mel) output per step; a warp shares its mel row, so the
  // filterbank read is a broadcast and the power reads (stride 201, odd)
  // hit 32 distinct banks.
  float* oc = out + static_cast<size_t>(clip) * kMels * n_frames;
  for (int idx = threadIdx.x; idx < kTile * kMels; idx += kThreads) {
    const int f = idx % kTile;
    const int m = idx / kTile;
    const int t = f0 + f;
    if (t >= n_frames) continue;
    const float* p = power + f * kBins;
    float acc = 0.f;
    for (int kk = 0; kk < kBins; ++kk) {
      acc = fmaf(p[kk], __ldg(fbt + kk * kMels + m), acc);
    }
    oc[static_cast<size_t>(m) * n_frames + t] =
        10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// y: (batch, n) fp32 clips; wc, ws: (400, 201) Hann-folded DFT bases;
// fbt: (201, 80) transposed mel filterbank; out: (batch, 80, n_frames) dB
// with n_frames = 1 + n / 160. Returns cudaGetLastError() of the launch.
extern "C" int lipsync_log_mel(const float* y, const float* wc, const float* ws,
                               const float* fbt, float* out, int batch, int n,
                               int n_frames, void* stream) {
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  log_mel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, wc, ws, fbt, out, n, n_frames);
  return static_cast<int>(cudaGetLastError());
}
