// Fused harmonic synthesis, forward (kernel K1 of ddsp_torch).
//
// Replaces ddsp_tpu/ops/pallas_kernels/harmonic.py:_fwd_kernel (reached
// through _pallas_fwd / fused_harmonic_synthesis). For each sample n of
// batch row b:
//
//   audio[b, n] = sum_{h=1..H, h < hmax[n]} A_h[n] * sin(h * phi[n])
//   hmax[n]     = (sample_rate / 2) / max(f0[b, n], 1e-20)
//   A_h[n]      = fall(d) * ham[b, k, h] + rise(d) * ham[b, k + 1, h]
//
// with k = n / hop, d = n % hop, ham[b, n_frames] an endpoint copy of the
// last frame, (rise, fall) the periodic-hann ('window') or linear 2-tap
// weights of ddsp_tpu's _weights, and phi the fundamental phase wrapped
// mod 2*pi (sin(h * (phi mod 2pi)) == sin(h * phi) for integer h).
//
// Design. Grid (sample blocks, batch); one thread per sample. A block first
// stages the few frames of ham its samples interpolate between into shared
// memory, so each amplitude read is a shared-memory broadcast within a hop.
// Each thread takes one accurate sincosf and generates sin(h * phi) with
// the Chebyshev recurrence s_{h+1} = 2 cos(phi) s_h - s_{h-1}, stopping at
// the first harmonic above Nyquist (the mask is monotone in h). The
// [batch, n_samples, n_harmonics] amplitude and phase tensors of the plain
// version never exist: the kernel reads phase and f0 (8 B per sample) and
// writes audio (4 B per sample), plus the small frame array.
//
// Bound. About 12 B and 6 FLOP of fp32 SIMT work (recurrence 2, mask 1,
// two taps' FMAs) per sample per harmonic below Nyquist. With all H = 60
// harmonics audible that is 30 FLOP/B, above the H100's fp32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B), so operations bound it; with
// typical f0 fewer than 40 are audible and bytes bound it. At serving
// sizes (64000 samples) both bounds are under a microsecond, and launch
// latency dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

  const int n = s0 + threadIdx.x;
  if (n >= n_samples) return;
  const size_t idx = (size_t)b * n_samples + n;
  const int k = n / hop;
  const int d = n - k * hop;
  // Tap weights in float64, rounded once, as numpy computes them.
  float rise, fall;
  if (linear) {
    const double t = (double)d / hop;
    rise = (float)t;
    fall = (float)(1.0 - t);
  } else {
    const double c = cospi((double)d / hop);
    rise = (float)(0.5 - 0.5 * c);
    fall = (float)(0.5 + 0.5 * c);
  }

  const float two_pi = 6.28318530717958647692f;
  float p = fmodf(phase[idx], two_pi);  // jnp's % : floor-mod
  if (p < 0.f) p += two_pi;
  float s_cur, c1;
  sincosf(p, &s_cur, &c1);
  const float two_c = 2.f * c1;
  const float hmax = nyquist / fmaxf(f0[idx], 1e-20f);

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

}  // namespace

// phase, f0, out: [batch, n_samples] float32; ham: [batch, n_frames,
// n_harmonics] float32; n_samples % n_frames == 0. Returns cudaError_t.
extern "C" int ddsp_harmonic_fwd(const void* phase, const void* f0,
                                 const void* ham, void* out, int batch,
                                 int n_samples, int n_frames,
                                 int n_harmonics, float nyquist, int linear,
                                 void* stream) {
  const int hop = n_samples / n_frames;
  const int max_rows = (kThreads - 1) / hop + 3;
  const size_t smem = (size_t)max_rows * n_harmonics * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        harmonic_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n_samples + kThreads - 1) / kThreads, batch);
  harmonic_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)phase, (const float*)f0, (const float*)ham, (float*)out,
      n_samples, n_frames, n_harmonics, hop, nyquist, linear);
  return (int)cudaGetLastError();
}
