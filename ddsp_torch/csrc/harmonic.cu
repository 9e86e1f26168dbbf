// Fused harmonic synthesis: forward (K1f) and its two backward kernels,
// amplitude taps (K1t) and phase (K1p), of ddsp_torch.
//
// Replaces ddsp_tpu/ops/pallas_kernels/harmonic.py:_fwd_kernel,
// _bwd_taps_kernel and _bwd_phase_kernel (reached through _pallas_fwd,
// _pallas_bwd_taps, _pallas_bwd_phase / fused_harmonic_synthesis). For each
// sample n of batch row b:
//
//   audio[b, n] = sum_{h=1..H, h < hmax[n]} A_h[n] * sin(h * phi[n])
//   hmax[n]     = (sample_rate / 2) / max(f0[b, n], 1e-20)
//   A_h[n]      = fall(d) * ham[b, k, h] + rise(d) * ham[b, k + 1, h]
//
// with k = n / hop, d = n % hop, ham[b, n_frames] an endpoint copy of the
// last frame, (rise, fall) the periodic-hann ('window') or linear 2-tap
// weights of ddsp_tpu's _weights, and phi the fundamental phase wrapped
// mod 2*pi (sin(h * (phi mod 2pi)) == sin(h * phi) for integer h). With g
// the cotangent of audio:
//
//   dtaps[b, k, 0, h] = sum_{d} fall(d) g[b, n] [h < hmax[n]] sin(h phi[n])
//   dtaps[b, k, 1, h] = sum_{d} rise(d) g[b, n] [h < hmax[n]] sin(h phi[n])
//   dphi[b, n] = g[b, n] sum_{h < hmax[n]} A_h[n] h cos(h phi[n])
//
// dtaps holds the per-hop partials; the wrapper folds tap 0 of hop k onto
// frame k and tap 1 onto frame k + 1 (the endpoint onto the last frame).
// All three kernels share the wrap, the tap weights, the Chebyshev chain
// and the mask rule hmax <= h, so their masks agree bit for bit.
//
// Design, forward and phase backward. Grid (sample blocks, batch); one
// thread per sample. A block first stages the few frames of ham its
// samples interpolate between into shared memory, so each amplitude read
// is a shared-memory broadcast within a hop. Each thread takes one
// accurate sincosf and generates sin(h * phi) (or cos) with the Chebyshev
// recurrence s_{h+1} = 2 cos(phi) s_h - s_{h-1}, stopping at the first
// harmonic above Nyquist (the mask is monotone in h). The [batch,
// n_samples, n_harmonics] amplitude and phase tensors of the plain version
// never exist.
//
// Design, taps backward. A reduction over the samples of a hop for each
// (tap, harmonic): grid (hops, batch), one block per hop. In chunks of
// kChunk samples, one thread per sample writes its masked sin(h phi) chain
// into shared memory [H][kChunk + 1]; then one thread per (harmonic, tap)
// sums its row against the weighted cotangents. No atomics: the result is
// the same from run to run.
//
// Bound. Forward: about 12 B and 6 FLOP of fp32 SIMT work (recurrence 2,
// mask 1, two taps' FMAs) per sample per harmonic below Nyquist. With all
// H = 60 harmonics audible that is 30 FLOP/B, above the H100's fp32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B), so operations bound it; with
// typical f0 fewer than 40 are audible and bytes bound it. The backward
// kernels read one more stream (g) and do the same order of work. At
// serving sizes (64000 samples) both bounds are under a microsecond, and
// launch latency dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Stages frames k0 .. of ham[b] that the block's samples interpolate between
// into amps[rows][n_harmonics]; returns k0. Ends with a __syncthreads().
__device__ __forceinline__ int stage_frames(const float* __restrict__ ham,
                                            float* amps, int b, int s0,
                                            int n_samples, int n_frames,
                                            int n_harmonics, int hop) {
  const int s_last = min(s0 + kThreads, n_samples) - 1;
  const int k0 = s0 / hop;
  const int rows = s_last / hop + 2 - k0;  // frames k0 .. k_last + 1
  const float* ham_b = ham + (size_t)b * n_frames * n_harmonics;
  for (int i = threadIdx.x; i < rows * n_harmonics; i += kThreads) {
    const int row = i / n_harmonics;
    const int h = i - row * n_harmonics;
    const int frame = min(k0 + row, n_frames - 1);  // endpoint frame
    amps[i] = ham_b[(size_t)frame * n_harmonics + h];
  }
  __syncthreads();
  return k0;
}

// Tap weights of sample d within its hop, in float64, rounded once, as
// numpy computes them.
__device__ __forceinline__ void tap_weights(int d, int hop, int linear,
                                            float* rise, float* fall) {
  if (linear) {
    const double t = (double)d / hop;
    *rise = (float)t;
    *fall = (float)(1.0 - t);
  } else {
    const double c = cospi((double)d / hop);
    *rise = (float)(0.5 - 0.5 * c);
    *fall = (float)(0.5 + 0.5 * c);
  }
}

// sin and cos of the phase wrapped to [0, 2 pi) (jnp's % : floor-mod).
__device__ __forceinline__ void wrapped_sincos(float phase, float* s,
                                               float* c) {
  const float two_pi = 6.28318530717958647692f;
  float p = fmodf(phase, two_pi);
  if (p < 0.f) p += two_pi;
  sincosf(p, s, c);
}

__device__ __forceinline__ float harmonic_limit(float f0, float nyquist) {
  return nyquist / fmaxf(f0, 1e-20f);
}

__global__ void __launch_bounds__(kThreads)
harmonic_fwd_kernel(const float* __restrict__ phase,
                    const float* __restrict__ f0,
                    const float* __restrict__ ham,
                    float* __restrict__ out,
                    int n_samples, int n_frames, int n_harmonics, int hop,
                    float nyquist, int linear) {
  extern __shared__ float amps[];  // [rows, n_harmonics]
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kThreads;
  const int k0 = stage_frames(ham, amps, b, s0, n_samples, n_frames,
                              n_harmonics, hop);
  const int n = s0 + threadIdx.x;
  if (n >= n_samples) return;
  const size_t idx = (size_t)b * n_samples + n;
  const int k = n / hop;
  float rise, fall;
  tap_weights(n - k * hop, hop, linear, &rise, &fall);

  float s_cur, c1;
  wrapped_sincos(phase[idx], &s_cur, &c1);
  const float two_c = 2.f * c1;
  const float hmax = harmonic_limit(f0[idx], nyquist);

  const float* a0 = amps + (k - k0) * n_harmonics;
  const float* a1 = a0 + n_harmonics;
  float acc0 = 0.f, acc1 = 0.f, s_prev = 0.f;
  for (int h = 1; h <= n_harmonics; ++h) {
    if (hmax <= (float)h) break;  // this and every higher harmonic muted
    acc0 = fmaf(a0[h - 1], s_cur, acc0);
    acc1 = fmaf(a1[h - 1], s_cur, acc1);
    const float s_next = two_c * s_cur - s_prev;
    s_prev = s_cur;
    s_cur = s_next;
  }
  out[idx] = fall * acc0 + rise * acc1;
}

// dphi[b, n] = g * sum_h A_h * h * cos(h phi): the forward's structure with
// the cos chain c_{h+1} = 2 cos(phi) c_h - c_{h-1}, c_0 = 1.
__global__ void __launch_bounds__(kThreads)
harmonic_bwd_phase_kernel(const float* __restrict__ phase,
                          const float* __restrict__ f0,
                          const float* __restrict__ ham,
                          const float* __restrict__ g,
                          float* __restrict__ dphase,
                          int n_samples, int n_frames, int n_harmonics,
                          int hop, float nyquist, int linear) {
  extern __shared__ float amps[];  // [rows, n_harmonics]
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kThreads;
  const int k0 = stage_frames(ham, amps, b, s0, n_samples, n_frames,
                              n_harmonics, hop);
  const int n = s0 + threadIdx.x;
  if (n >= n_samples) return;
  const size_t idx = (size_t)b * n_samples + n;
  const int k = n / hop;
  float rise, fall;
  tap_weights(n - k * hop, hop, linear, &rise, &fall);

  float s1, c_cur;
  wrapped_sincos(phase[idx], &s1, &c_cur);
  const float two_c = 2.f * c_cur;
  const float hmax = harmonic_limit(f0[idx], nyquist);

  const float* a0 = amps + (k - k0) * n_harmonics;
  const float* a1 = a0 + n_harmonics;
  float acc0 = 0.f, acc1 = 0.f, c_prev = 1.f;
  for (int h = 1; h <= n_harmonics; ++h) {
    if (hmax <= (float)h) break;
    const float hc = (float)h * c_cur;
    acc0 = fmaf(a0[h - 1], hc, acc0);
    acc1 = fmaf(a1[h - 1], hc, acc1);
    const float c_next = two_c * c_cur - c_prev;
    c_prev = c_cur;
    c_cur = c_next;
  }
  dphase[idx] = g[idx] * (fall * acc0 + rise * acc1);
}

constexpr int kTapThreads = 128;
constexpr int kChunk = 64;  // samples of a hop per pass, <= kTapThreads

// dtaps[b, k, tap, h] for hop k = blockIdx.x of row b = blockIdx.y.
__global__ void __launch_bounds__(kTapThreads)
harmonic_bwd_taps_kernel(const float* __restrict__ phase,
                         const float* __restrict__ f0,
                         const float* __restrict__ g,
                         float* __restrict__ dtaps,
                         int n_samples, int n_frames, int n_harmonics,
                         int hop, float nyquist, int linear) {
  extern __shared__ float smem[];
  constexpr int kStride = kChunk + 1;      // odd: no bank conflicts
  float* sins = smem;                      // [n_harmonics][kStride]
  float* gw = sins + n_harmonics * kStride;  // [2][kChunk]: fall*g, rise*g
  float* acc = gw + 2 * kChunk;            // [n_harmonics][2]
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * n_samples + (size_t)k * hop;
  for (int i = tid; i < 2 * n_harmonics; i += kTapThreads) acc[i] = 0.f;

  for (int d0 = 0; d0 < hop; d0 += kChunk) {
    const int count = min(kChunk, hop - d0);
    __syncthreads();  // the previous chunk's sums are done with sins, gw
    if (tid < count) {
      const int d = d0 + tid;
      float rise, fall;
      tap_weights(d, hop, linear, &rise, &fall);
      const float gv = g[base + d];
      gw[tid] = fall * gv;
      gw[kChunk + tid] = rise * gv;
      float s_cur, c1;
      wrapped_sincos(phase[base + d], &s_cur, &c1);
      const float two_c = 2.f * c1;
      const float hmax = harmonic_limit(f0[base + d], nyquist);
      float s_prev = 0.f;
      int h = 1;
      for (; h <= n_harmonics; ++h) {
        if (hmax <= (float)h) break;
        sins[(h - 1) * kStride + tid] = s_cur;
        const float s_next = two_c * s_cur - s_prev;
        s_prev = s_cur;
        s_cur = s_next;
      }
      for (; h <= n_harmonics; ++h) sins[(h - 1) * kStride + tid] = 0.f;
    }
    __syncthreads();
    for (int i = tid; i < 2 * n_harmonics; i += kTapThreads) {
      const float* row = sins + (i >> 1) * kStride;
      const float* w = gw + (i & 1) * kChunk;
      float sum = 0.f;
      for (int d = 0; d < count; ++d) sum = fmaf(w[d], row[d], sum);
      acc[i] += sum;
    }
  }
  float* out = dtaps + ((size_t)b * n_frames + k) * 2 * n_harmonics;
  for (int i = tid; i < 2 * n_harmonics; i += kTapThreads) {
    // acc is [h][tap]; dtaps is [tap][h].
    out[(i & 1) * n_harmonics + (i >> 1)] = acc[i];
  }
}

size_t frames_smem(int hop, int n_harmonics) {
  const int max_rows = (kThreads - 1) / hop + 3;
  return (size_t)max_rows * n_harmonics * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// phase, f0, out: [batch, n_samples] float32; ham: [batch, n_frames,
// n_harmonics] float32; n_samples % n_frames == 0. Returns cudaError_t.
extern "C" int ddsp_harmonic_fwd(const void* phase, const void* f0,
                                 const void* ham, void* out, int batch,
                                 int n_samples, int n_frames,
                                 int n_harmonics, float nyquist, int linear,
                                 void* stream) {
  const int hop = n_samples / n_frames;
  const size_t smem = frames_smem(hop, n_harmonics);
  const cudaError_t e = allow_smem(harmonic_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_samples + kThreads - 1) / kThreads, batch);
  harmonic_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)phase, (const float*)f0, (const float*)ham, (float*)out,
      n_samples, n_frames, n_harmonics, hop, nyquist, linear);
  return (int)cudaGetLastError();
}

// g, dphase: [batch, n_samples] float32; the rest as ddsp_harmonic_fwd.
extern "C" int ddsp_harmonic_bwd_phase(const void* phase, const void* f0,
                                       const void* ham, const void* g,
                                       void* dphase, int batch, int n_samples,
                                       int n_frames, int n_harmonics,
                                       float nyquist, int linear,
                                       void* stream) {
  const int hop = n_samples / n_frames;
  const size_t smem = frames_smem(hop, n_harmonics);
  const cudaError_t e = allow_smem(harmonic_bwd_phase_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_samples + kThreads - 1) / kThreads, batch);
  harmonic_bwd_phase_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)phase, (const float*)f0, (const float*)ham,
      (const float*)g, (float*)dphase, n_samples, n_frames, n_harmonics, hop,
      nyquist, linear);
  return (int)cudaGetLastError();
}

// dtaps: [batch, n_frames, 2, n_harmonics] float32, every element written.
// n_frames <= 2^31 - 1 and batch <= 65535 (grid limits).
extern "C" int ddsp_harmonic_bwd_taps(const void* phase, const void* f0,
                                      const void* g, void* dtaps, int batch,
                                      int n_samples, int n_frames,
                                      int n_harmonics, float nyquist,
                                      int linear, void* stream) {
  const int hop = n_samples / n_frames;
  const size_t smem = sizeof(float) * ((size_t)n_harmonics * (kChunk + 1) +
                                       2 * kChunk + 2 * (size_t)n_harmonics);
  const cudaError_t e = allow_smem(harmonic_bwd_taps_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_frames, batch);
  harmonic_bwd_taps_kernel<<<grid, kTapThreads, smem, (cudaStream_t)stream>>>(
      (const float*)phase, (const float*)f0, (const float*)g, (float*)dtaps,
      n_samples, n_frames, n_harmonics, hop, nyquist, linear);
  return (int)cudaGetLastError();
}
