// K1: fused log-mel spectrogram for sm_90a.
//
// Replaces: lipsync_tpu/ops/pallas/mel_kernel.py::log_mel_spectrogram_pallas
// (kernel body _mel_block_kernel): frames @ Hann-folded DFT cos/sin bases,
// c^2 + s^2, @ the Slaney mel filterbank, 10*log10(max(., 1e-10)). It takes
// the Pallas kernel's whole parameter range at run time: any sample rate
// (through the wrapper's tables) and hop, centred frames or not, n_fft =
// win_length up to 511 (n_fft / 2 + 1 <= 256 bins, the Pallas _BINS_PAD)
// and up to 128 mel bands (_MELS_PAD); the wrapper refuses the rest.
//
// What bounds it on an H100: a 4 s clip (65536 samples, 410 frames at the
// defaults) needs ~0.15 GFLOP of fp32 FMA and ~1 MB of traffic, so it is
// bound by operations on the fp32 SIMT units (bf16 or TF32 tensor cores
// would cost dB at quiet bands, as anything short of HIGHEST precision does
// on the TPU). At that size the bound is a few microseconds; what the card
// can reach depends on spreading the work over all 132 SMs.
//
// Design: grid (tiles of F frames, clips). A block has ceil(n_bins / 32)
// warps of 32 consecutive DFT bins times S sample slices (S = 4, or 3 where
// 8 bin warps would pass 896 threads), so at most 896 threads: 7 x 4 at the
// defaults (224 >= 201 bins, slices of 100 samples). F is 3 (137 blocks at
// 65536 samples, so every SM gets one) or, where there are frames enough for
// every SM at 8, 8 (more FMAs per twiddle read). A block windows its F
// frames into shared memory once, (x * w) as float4s per sample, so a
// warp's frame reads are broadcasts. Instead of the (n_fft, n_bins) bases
// (643 KB at the defaults, which every block would stream from L2), the DFT
// reads one n_fft-entry cos/sin twiddle table at (n * k) mod n_fft from
// shared memory, skewed by one word per 32 entries to spread the
// power-of-two strides over the banks. Each thread keeps the cos and sin
// sums of its bin for F frames over its slice (the last slice is shorter
// where S does not divide n_fft); the slices meet in shared memory and add
// (pairwise for 4), then c^2 + s^2. The mel projection reads only each
// band's nonzero bins (its support, from the wrapper) in bin order, which
// gives the dense sum's result; a band with no nonzero bin gives
// 10 log10(1e-10). The dB values are stored as (n_mels, T). The clip-max
// reference and the -top_db floor stay in the wrapper, as they sit outside
// the Pallas body.
//
// The kernel is instantiated twice per F: with n_fft = 400 fixed at compile
// time (the defaults: the slice length, bin count and thread count fold to
// constants, as in the kernel before it took parameters) and with every
// size read at run time. Both are this one source.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 896;
constexpr int kMaxBins = 256;   // n_fft <= 511
constexpr int kMaxMels = 128;
constexpr int kDefaultNFFT = 400;

__device__ __host__ __forceinline__ int skew(int m) { return m + (m >> 5); }

// The sizes of one launch: n_fft and what follows from it.
struct Dims {
  int n_fft, n_bins, slices, slice_len, threads;
};

__host__ __device__ inline Dims dims_of(int n_fft) {
  Dims d;
  d.n_fft = n_fft;
  d.n_bins = n_fft / 2 + 1;
  const int bin_warps = (d.n_bins + 31) / 32;
  const int fit = kMaxThreads / 32 / bin_warps;  // slices that fit
  d.slices = fit < 4 ? fit : 4;
  d.slice_len = (n_fft + d.slices - 1) / d.slices;
  d.threads = bin_warps * d.slices * 32;
  return d;
}

// Shared-memory layout, in floats: float4 xw[n_fft][F4], the cos and sin
// twiddles (skewed), the slices' partial sums [S][F][2][n_bins] and the
// power [F][n_bins].
struct Smem {
  int cs, sn, part, power, bytes;
};

__host__ __device__ inline Smem smem_of(const Dims& d, int f) {
  const int f4 = (f + 3) / 4;
  const int tw = skew(d.n_fft - 1) + 1;
  Smem s;
  s.cs = d.n_fft * f4 * 4;
  s.sn = s.cs + tw;
  s.part = s.sn + tw;
  s.power = s.part + d.slices * f * 2 * d.n_bins;
  s.bytes = (s.power + f * d.n_bins) * 4;
  return s;
}

// Two blocks of 3 frames at n_fft = 400 share an SM (32 registers a
// thread); a block of 8 frames needs more registers for its 16 sums and has
// an SM to itself. kN is n_fft where it is fixed at compile time, else 0;
// the run-time-sized kernel keeps its sizes in registers too, so it is not
// held to 32 (ptxas would spill).
template <int kF, int kN>
__global__ void __launch_bounds__(kMaxThreads, kF == 3 && kN ? 2 : 1)
log_mel_kernel(const float* __restrict__ y, const float* __restrict__ win,
               const float* __restrict__ twc, const float* __restrict__ tws,
               const float* __restrict__ fbt, const int* __restrict__ bands,
               float* __restrict__ out, int n, int n_frames, int n_fft,
               int hop, int n_mels, int pad) {
  constexpr int kF4 = (kF + 3) / 4;  // float4s per windowed sample
  const Dims d = dims_of(kN ? kN : n_fft);
  const int N = d.n_fft, nb = d.n_bins, S = d.slices;
  const Smem L = smem_of(d, kF);
  extern __shared__ __align__(16) float smem[];
  float4* xw = reinterpret_cast<float4*>(smem);
  float* cs = smem + L.cs;
  float* sn = smem + L.sn;
  float* part = smem + L.part;
  float* power = smem + L.power;

  const int tid = threadIdx.x;
  const int clip = blockIdx.y;
  const int f0 = blockIdx.x * kF;
  const float* yc = y + static_cast<size_t>(clip) * n;

  // Sample i of frame f is sample (f0 + f) * hop + i - pad of the clip
  // (pad = n_fft / 2 zeros each side for centred frames, else 0).
  for (int i = tid; i < N; i += d.threads) {
    const float wv = win[i];
    float v[kF4 * 4];
#pragma unroll
    for (int f = 0; f < kF4 * 4; ++f) {
      const int src = (f0 + f) * hop + i - pad;
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
  const int s = warp % S;
  const int k = (warp / S) * 32 + (tid & 31);
  if (k < nb) {
    float c[kF4 * 4], sv[kF4 * 4];
#pragma unroll
    for (int f = 0; f < kF4 * 4; ++f) c[f] = sv[f] = 0.f;
    const int n0 = s * d.slice_len;
    const int len = min(d.slice_len, N - n0);
    int idx = (n0 * k) % N;
    for (int j = 0; j < len; ++j) {
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
      if (idx >= N) idx -= N;
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      part[((s * kF + f) * 2 + 0) * nb + k] = c[f];
      part[((s * kF + f) * 2 + 1) * nb + k] = sv[f];
    }
  }
  __syncthreads();

  // The slices' partial sums add (4 of them pairwise), then c^2 + s^2.
  const int stride = kF * 2 * nb;
  auto slice_sum = [&](int f, int cs_, int kk) {
    const float* q = part + (f * 2 + cs_) * nb + kk;
    if (S == 4) return (q[0] + q[stride]) + (q[2 * stride] + q[3 * stride]);
    float acc = q[0];
    for (int t = 1; t < S; ++t) acc += q[t * stride];
    return acc;
  };
  for (int i = tid; i < kF * nb; i += d.threads) {
    const int f = i / nb, kk = i % nb;
    const float c = slice_sum(f, 0, kk), sv = slice_sum(f, 1, kk);
    power[f * nb + kk] = c * c + sv * sv;
  }
  __syncthreads();

  float* oc = out + static_cast<size_t>(clip) * n_mels * n_frames;
  for (int i = tid; i < kF * n_mels; i += d.threads) {
    const int m = i / kF, f = i % kF;
    const int t = f0 + f;
    if (t >= n_frames) continue;
    float acc = 0.f;
    for (int kk = bands[2 * m]; kk <= bands[2 * m + 1]; ++kk) {
      acc = fmaf(power[f * nb + kk], __ldg(fbt + kk * n_mels + m), acc);
    }
    oc[static_cast<size_t>(m) * n_frames + t] =
        10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

template <int kF, int kN>
int launch(const float* y, const float* win, const float* twc,
           const float* tws, const float* fbt, const int* bands, float* out,
           int batch, int n, int n_frames, int n_fft, int hop, int n_mels,
           int pad, cudaStream_t stream) {
  auto kernel = log_mel_kernel<kF, kN>;
  const Dims d = dims_of(n_fft);
  const int bytes = smem_of(d, kF).bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kF - 1) / kF, batch);
  kernel<<<grid, d.threads, bytes, stream>>>(y, win, twc, tws, fbt, bands,
                                             out, n, n_frames, n_fft, hop,
                                             n_mels, pad);
  return static_cast<int>(cudaGetLastError());
}

template <int kF>
int launch_f(bool fixed, const float* y, const float* win, const float* twc,
             const float* tws, const float* fbt, const int* bands, float* out,
             int batch, int n, int n_frames, int n_fft, int hop, int n_mels,
             int pad, cudaStream_t stream) {
  if (fixed) {
    return launch<kF, kDefaultNFFT>(y, win, twc, tws, fbt, bands, out, batch,
                                    n, n_frames, n_fft, hop, n_mels, pad,
                                    stream);
  }
  return launch<kF, 0>(y, win, twc, tws, fbt, bands, out, batch, n, n_frames,
                       n_fft, hop, n_mels, pad, stream);
}

}  // namespace

// y: (batch, n) fp32 clips; win: (n_fft,) Hann window; twc, tws: (n_fft,)
// cos and sin of 2*pi*m/n_fft; fbt: (n_fft/2 + 1, n_mels) transposed mel
// filterbank; bands: (n_mels, 2) first and last nonzero bin of each mel
// band ((0, -1) for none); out: (batch, n_mels, n_frames) dB with n_frames
// = 1 + (n + 2 pad - n_fft) / hop, pad = n_fft / 2 if center else 0;
// frames_per_block: 3 or 8; general: 1 takes the run-time-sized kernel even
// at n_fft = 400 (to time it against the fixed one), 0 lets n_fft choose.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// sizes outside the kernel's range or another frames_per_block.
extern "C" int lipsync_log_mel(const float* y, const float* win,
                               const float* twc, const float* tws,
                               const float* fbt, const int* bands, float* out,
                               int batch, int n, int n_frames, int n_fft,
                               int hop, int n_mels, int center,
                               int frames_per_block, int general,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_fft < 1 || n_fft / 2 + 1 > kMaxBins || hop < 1 || n_mels < 1 ||
      n_mels > kMaxMels || n_frames < 1 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pad = center ? n_fft / 2 : 0;
  const bool fixed = !general && n_fft == kDefaultNFFT;
  if (frames_per_block == 3) {
    return launch_f<3>(fixed, y, win, twc, tws, fbt, bands, out, batch, n,
                       n_frames, n_fft, hop, n_mels, pad, s);
  }
  if (frames_per_block == 8) {
    return launch_f<8>(fixed, y, win, twc, tws, fbt, bands, out, batch, n,
                       n_frames, n_fft, hop, n_mels, pad, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
