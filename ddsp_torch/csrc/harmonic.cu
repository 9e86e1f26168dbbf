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
// mod 2 pi (sin(h * (phi mod 2pi)) == sin(h * phi) for integer h). With g
// the cotangent of audio:
//
//   taps[k, 0, h] = sum_{d} fall(d) g[b, n] [h < hmax[n]] sin(h phi[n])
//   taps[k, 1, h] = sum_{d} rise(d) g[b, n] [h < hmax[n]] sin(h phi[n])
//   dham[b, k, h] = taps[k, 0, h] + taps[k - 1, 1, h]
//                   (+ taps[k, 1, h] on the last frame: the endpoint copy)
//   dphi[b, n] = g[b, n] sum_{h < hmax[n]} A_h[n] h cos(h phi[n])
//
// All three kernels share the wrap, the tap weights and the mask rule
// hmax <= h (muted), so their masks agree bit for bit.
//
// The wrap. The phase of a training step is a plain cumsum that reaches
// ~1e4 rad in 4 s. fmodf by float32(2 pi) is exact, but float32(2 pi) is
// 2 pi + 1.75e-7, so after q turns the wrapped phase is off by q * 1.75e-7
// (3e-4 rad at 1e4 rad, times h in harmonic h). wrap_two_pi subtracts
// q * 2 pi in two parts, float32(2 pi) (exact, in one fma) and the rest
// (one more rounding), so the result is phi mod 2 pi to within a float32
// rounding, in four instructions.
//
// What bounds these kernels on an H100. Per sample and audible harmonic
// they do one fma of the Chebyshev recurrence s_{h+1} = 2 cos(phi) s_h -
// s_{h-1} and two fmas of the taps; per sample they read and write 12-16 B.
// On the training shape (16 x 64000 samples, ~24 audible harmonics a
// sample) that is ~5 us of bytes and ~2 us of fp32 operations, so bytes
// bound them on paper. What holds them back in fact is instruction issue:
// the first designs spent 7-17 instructions per sample-harmonic (scalar
// shared loads, a compare and a branch per harmonic, and in K1t a store
// and two loads per fma); these spend ~3.3 (5.4 where a chunk crosses a
// sample's limit), and the fma loops issue at about half the SM's peak.
//
// K1f, the forward. Grid (hop blocks, batch), kFwdThreads threads. A hop
// is split over P threads, each taking S samples of it (d = p + P i): S = 4
// while batch * n_samples / 4 threads still fill the card (training), else
// 1 (one request, which keeps its blocks). Each block stages the frames of
// its hops in shared memory, padded to a multiple of 4 harmonics, and each
// float4 load of 4 amplitudes feeds S samples. The audible harmonics are counted
// once per sample (n_audible, the same rule as hmax <= h); the harmonic
// loop is unrolled by 4 without a branch, up to the warp's largest count,
// and only chunks past the warp's smallest count pay a select per
// sample-harmonic. The tap weights are filled once per block (float64
// rounded once, as numpy computes them).
//
// K1t, the taps backward. Grid (frame runs, batch), kTapThreads threads,
// S = 8 samples a thread, P = ceil(hop / 8) threads a hop, G hops a round.
// The sine chains stay in registers; each thread sums fall*g and rise*g
// times its 8 samples' sines into a 4-harmonic x 2-tap register tile. Per
// tile, a reduce-scatter by shuffles over L lanes (the largest of 8, 4, 2,
// 1 dividing P) and 8 / L shared stores; then a fixed-order pass sums each
// hop's P / L rows. At hop 64 that is 7 shuffles and one store per 64 fmas.
// The block folds tap 1 of hop k into frame k + 1 itself: a block that
// writes frames [k0, k0 + frames_blk) also computes hop k0 - 1, so every
// frame is written once, by one block, in one order. There are no atomics
// and no [B, F, 2, H] intermediate; the result is the same from run to
// run. Hops longer than 8 * kTapThreads take several passes, each adding
// to the same partials. The partials take (2 * threads / L + 2 G + 1) floats
// a harmonic of shared memory; where H harmonics need more than the card
// has, the grid's z dimension splits them into blocks of h_blk, and each
// block runs the chain from harmonic 1 but sums only its own, so every
// harmonic sees the same chain values and the same order as in one block.
//
// K1p, the phase backward, keeps its first design: one thread per sample,
// the cos chain, a loop that stops at the first muted harmonic.

#include <cuda_runtime.h>

namespace {

// ---- Helpers shared by the three kernels. ----

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

// Fills fall[d], rise[d] (d < hop) in shared memory; no barrier.
__device__ __forceinline__ void fill_tap_table(float* fall, float* rise,
                                               int hop, int linear) {
  for (int d = threadIdx.x; d < hop; d += blockDim.x) {
    tap_weights(d, hop, linear, &rise[d], &fall[d]);
  }
}

// phi mod 2 pi to within one float32 rounding (see the head of the file).
__device__ __forceinline__ float wrap_two_pi(float phase) {
  const float two_pi_hi = 6.28318548202514648438f;      // float32(2 pi)
  const float two_pi_lo = -1.74845553146951715461e-07f;  // 2 pi - hi
  const float inv_two_pi = 0.15915494309189533577f;
  const float q = floorf(phase * inv_two_pi);
  const float r = fmaf(-q, two_pi_hi, phase);  // exact
  return fmaf(-q, two_pi_lo, r);
}

__device__ __forceinline__ void wrapped_sincos(float phase, float* s,
                                               float* c) {
  sincosf(wrap_two_pi(phase), s, c);
}

__device__ __forceinline__ float harmonic_limit(float f0, float nyquist) {
  return nyquist / fmaxf(f0, 1e-20f);
}

// #{h in 1..H : h < hmax}: harmonic h is audible iff h <= n_audible, the
// rule `hmax <= h` mutes, counted once.
__device__ __forceinline__ int n_audible(float f0, float nyquist,
                                         int n_harmonics) {
  const float hmax = harmonic_limit(f0, nyquist);
  if (!(hmax <= (float)n_harmonics)) return n_harmonics;
  return max((int)ceilf(hmax) - 1, 0);
}

__host__ __device__ __forceinline__ int round_up4(int x) {
  return (x + 3) & ~3;
}

// How a hop is split: P threads a hop, S samples a thread per pass
// (d = pass * P * S + p + P * i), `passes` passes, G hops per block round.
struct Split {
  int P, passes, G;
};

__host__ __device__ inline Split split_hop(int hop, int S, int threads) {
  Split s;
  const int per_hop = (hop + S - 1) / S;
  s.P = per_hop < threads ? per_hop : threads;
  s.passes = (hop + s.P * S - 1) / (s.P * S);
  s.G = threads / s.P;
  return s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- K1f. ----

constexpr int kFwdThreads = 128;

template <int S>
__global__ void __launch_bounds__(kFwdThreads)
harmonic_fwd_kernel(const float* __restrict__ phase,
                    const float* __restrict__ f0,
                    const float* __restrict__ ham,
                    float* __restrict__ out,
                    int n_samples, int n_frames, int n_harmonics, int hop,
                    float nyquist, int linear) {
  extern __shared__ float4 smem4[];
  const Split sp = split_hop(hop, S, kFwdThreads);
  const int hp = round_up4(n_harmonics);
  float* amps = reinterpret_cast<float*>(smem4);  // [G + 1][hp]
  float* fall_tab = amps + (sp.G + 1) * hp;       // [hop]
  float* rise_tab = fall_tab + hop;               // [hop]
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * sp.G;

  const float* ham_b = ham + (size_t)b * n_frames * n_harmonics;
  for (int i = threadIdx.x; i < (sp.G + 1) * hp; i += kFwdThreads) {
    const int row = i / hp;
    const int h = i - row * hp;
    const int frame = min(k0 + row, n_frames - 1);  // endpoint frame
    amps[i] = (h < n_harmonics && k0 + row <= n_frames)
                  ? ham_b[(size_t)frame * n_harmonics + h] : 0.f;
  }
  fill_tap_table(fall_tab, rise_tab, hop, linear);
  __syncthreads();

  // Every thread stays to the end: the loop bounds are warp-wide.
  const int g = threadIdx.x / sp.P;
  const int p = threadIdx.x - g * sp.P;
  const int k = k0 + g;
  const bool hop_ok = g < sp.G && k < n_frames;
  const int row = min(g, sp.G - 1);
  const float4* a0 = reinterpret_cast<const float4*>(amps + row * hp);
  const float4* a1 = reinterpret_cast<const float4*>(amps + (row + 1) * hp);
  const size_t row0 = (size_t)b * n_samples + (size_t)min(k, n_frames - 1) * hop;

  for (int pass = 0; pass < sp.passes; ++pass) {
    float s_cur[S], s_prev[S], two_c[S], acc0[S], acc1[S];
    int n_aud[S];
    int lo = n_harmonics, hi = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int d = pass * sp.P * S + p + sp.P * i;
      s_cur[i] = 0.f;
      two_c[i] = 0.f;
      n_aud[i] = 0;
      if (hop_ok && d < hop) {
        float c1;
        wrapped_sincos(phase[row0 + d], &s_cur[i], &c1);
        two_c[i] = 2.f * c1;
        n_aud[i] = n_audible(f0[row0 + d], nyquist, n_harmonics);
        lo = min(lo, n_aud[i]);
        hi = max(hi, n_aud[i]);
      }
      s_prev[i] = 0.f;
      acc0[i] = 0.f;
      acc1[i] = 0.f;
    }
    // Warp-wide bounds: no lane diverges from the warp's chunk loops.
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    const int full = min(lo, hi) & ~3;
    int h0 = 0;
    // Chunks where every sample of this thread is audible.
    for (; h0 < full; h0 += 4) {
      const float4 x0 = a0[h0 >> 2];
      const float4 x1 = a1[h0 >> 2];
      const float w0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          acc0[i] = fmaf(w0[j], s_cur[i], acc0[i]);
          acc1[i] = fmaf(w1[j], s_cur[i], acc1[i]);
          const float s_next = two_c[i] * s_cur[i] - s_prev[i];
          s_prev[i] = s_cur[i];
          s_cur[i] = s_next;
        }
      }
    }
    // Chunks that cross some sample's limit: harmonic h0 + j + 1 is
    // audible iff h0 + j < n_aud.
    for (; h0 < hi; h0 += 4) {
      const float4 x0 = a0[h0 >> 2];
      const float4 x1 = a1[h0 >> 2];
      const float w0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float sm = (h0 + j < n_aud[i]) ? s_cur[i] : 0.f;
          acc0[i] = fmaf(w0[j], sm, acc0[i]);
          acc1[i] = fmaf(w1[j], sm, acc1[i]);
          const float s_next = two_c[i] * s_cur[i] - s_prev[i];
          s_prev[i] = s_cur[i];
          s_cur[i] = s_next;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int d = pass * sp.P * S + p + sp.P * i;
      if (hop_ok && d < hop) {
        out[row0 + d] = fall_tab[d] * acc0[i] + rise_tab[d] * acc1[i];
      }
    }
  }
}

// ---- K1p (first design, helpers shared). ----

constexpr int kPhaseThreads = 256;

// Stages frames k0 .. of ham[b] that the block's samples interpolate between
// into amps[rows][n_harmonics]; returns k0. Ends with a __syncthreads().
__device__ __forceinline__ int stage_frames(const float* __restrict__ ham,
                                            float* amps, int b, int s0,
                                            int n_samples, int n_frames,
                                            int n_harmonics, int hop) {
  const int s_last = min(s0 + kPhaseThreads, n_samples) - 1;
  const int k0 = s0 / hop;
  const int rows = s_last / hop + 2 - k0;  // frames k0 .. k_last + 1
  const float* ham_b = ham + (size_t)b * n_frames * n_harmonics;
  for (int i = threadIdx.x; i < rows * n_harmonics; i += kPhaseThreads) {
    const int row = i / n_harmonics;
    const int h = i - row * n_harmonics;
    const int frame = min(k0 + row, n_frames - 1);  // endpoint frame
    amps[i] = ham_b[(size_t)frame * n_harmonics + h];
  }
  __syncthreads();
  return k0;
}

// dphi[b, n] = g * sum_h A_h * h * cos(h phi): the cos chain
// c_{h+1} = 2 cos(phi) c_h - c_{h-1}, c_0 = 1, one thread per sample.
__global__ void __launch_bounds__(kPhaseThreads)
harmonic_bwd_phase_kernel(const float* __restrict__ phase,
                          const float* __restrict__ f0,
                          const float* __restrict__ ham,
                          const float* __restrict__ g,
                          float* __restrict__ dphase,
                          int n_samples, int n_frames, int n_harmonics,
                          int hop, float nyquist, int linear) {
  extern __shared__ float amps[];  // [rows, n_harmonics]
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kPhaseThreads;
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

// ---- K1t. ----

constexpr int kTapThreads = 128;
constexpr int kTapSamples = 8;     // S of K1t

// Frames a K1t block writes: R rounds of G hops, less the hop before them,
// at least min_frames. 31 halves the recomputed hops where the batch still
// gives every SM two blocks; 15 keeps small batches spread over the SMs.
__host__ __device__ inline int taps_frames_per_block(const Split& sp,
                                                     int min_frames) {
  const int rounds = (min_frames + 1 + sp.G - 1) / sp.G;
  return rounds * sp.G - 1;
}

inline int taps_min_frames(int batch, int n_frames) {
  return (long long)batch * n_frames >= 2LL * 132 * 32 ? 31 : 15;
}

// Lanes whose partials are summed by shuffles before shared memory: the
// largest of 8, 4, 2, 1 that divides P, so that every aligned group of L
// lanes works on one hop.
__host__ __device__ inline int taps_lanes(int P) {
  return P % 8 == 0 ? 8 : P % 4 == 0 ? 4 : P % 2 == 0 ? 2 : 1;
}

// Partial row stride: 2 * hp floats plus 4 (fewer bank conflicts).
__host__ __device__ inline int taps_row(int hp) { return 2 * hp + 4; }

// Reduce-scatter of v[8] over the L lanes of an aligned group, in a fixed
// order: afterwards v[m], m < 8 / L, holds the group's sum of the value
// that was at scatter_index<L>(m, lane).
template <int L>
__device__ __forceinline__ void reduce_scatter(float (&v)[8], int lane) {
#pragma unroll
  for (int w = L / 2, n = 8; w >= 1; w /= 2, n /= 2) {
    const bool up = lane & w;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) {
      const float keep = up ? v[m + n / 2] : v[m];
      const float send = up ? v[m] : v[m + n / 2];
      v[m] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
}

template <int L>
__device__ __forceinline__ int scatter_index(int m, int lane) {
  int idx = m;
#pragma unroll
  for (int w = L / 2, n = 8; w >= 1; w /= 2, n /= 2) {
    if (lane & w) idx += n / 2;
  }
  return idx;
}

// v[tap * 4 + j] holds harmonic h0 + j + 1 of tap `tap`, summed over this
// thread's samples. Sums it over the lane group and stores (pass 0) or
// adds (later passes) the group's partials into its row of shared memory.
template <int L>
__device__ __forceinline__ void put_partials(float* part, int row_len, int hp,
                                             int h0, int pass,
                                             float (&v)[8]) {
  const int tid = threadIdx.x;
  reduce_scatter<L>(v, tid & 31);
  float* row = part + (tid / L) * row_len + h0;
#pragma unroll
  for (int m = 0; m < 8 / L; ++m) {
    const int idx = scatter_index<L>(m, tid & 31);
    float* dst = row + (idx >> 2) * hp + (idx & 3);
    *dst = pass > 0 ? *dst + v[m] : v[m];
  }
}

// dham[b, k, h] for frames k in [blockIdx.x * frames_blk, + frames_blk)
// of row b = blockIdx.y; frames_blk + 1 is a multiple of G.
template <int L>
__global__ void __launch_bounds__(kTapThreads)
harmonic_bwd_taps_kernel(const float* __restrict__ phase,
                         const float* __restrict__ f0,
                         const float* __restrict__ g,
                         float* __restrict__ dham,
                         int n_samples, int n_frames, int n_harmonics,
                         int hop, float nyquist, int linear,
                         int frames_blk, int h_blk) {
  constexpr int S = kTapSamples;
  extern __shared__ float4 smem4[];
  const Split sp = split_hop(hop, S, kTapThreads);
  const int hb0 = blockIdx.z * h_blk;  // harmonics hb0 + 1 .. hb0 + nh
  const int nh = min(h_blk, n_harmonics - hb0);
  const int hp = round_up4(nh);
  const int row_len = taps_row(hp);
  const int rounds = (frames_blk + 1) / sp.G;
  const int rows_per_hop = sp.P / L;
  float* part = reinterpret_cast<float*>(smem4);  // [threads / L][row_len]
  float* tot = part + (kTapThreads / L) * row_len;  // [G][2 hp]
  float* carry = tot + sp.G * 2 * hp;             // [hp]: tap 1, last hop
  float* fall_tab = carry + hp;                   // [hop]
  float* rise_tab = fall_tab + hop;               // [hop]

  const int b = blockIdx.y;
  const int kb = blockIdx.x * frames_blk;  // first frame written
  const int tid = threadIdx.x;
  const int grp = tid / sp.P;
  const int p = tid - grp * sp.P;
  fill_tap_table(fall_tab, rise_tab, hop, linear);
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    // Hop of this thread's group; hop kb - 1 is computed for its tap 1.
    const int k = kb - 1 + round * sp.G + grp;
    const bool hop_ok = grp < sp.G && k >= 0 && k < n_frames;
    const size_t row0 = (size_t)b * n_samples + (size_t)max(k, 0) * hop;
    for (int pass = 0; pass < sp.passes; ++pass) {
      float s_cur[S], s_prev[S], two_c[S], gf[S], gr[S];
      int n_aud[S];  // audible harmonics of this block
      int lo = nh, hi = 0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int d = pass * sp.P * S + p + sp.P * i;
        s_cur[i] = 0.f;
        two_c[i] = 0.f;
        gf[i] = 0.f;
        gr[i] = 0.f;
        n_aud[i] = 0;
        if (hop_ok && d < hop) {
          float c1;
          wrapped_sincos(phase[row0 + d], &s_cur[i], &c1);
          two_c[i] = 2.f * c1;
          const float gv = g[row0 + d];
          gf[i] = fall_tab[d] * gv;
          gr[i] = rise_tab[d] * gv;
          n_aud[i] = min(max(n_audible(f0[row0 + d], nyquist, n_harmonics) -
                                 hb0, 0), nh);
          lo = min(lo, n_aud[i]);
          hi = max(hi, n_aud[i]);
        }
        s_prev[i] = 0.f;
      }
      // Warp-wide bounds: every lane runs the same chunks (the shuffles
      // need them all).
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (hi > 0) {  // the chain up to this block's first harmonic
        for (int t = 0; t < hb0; ++t) {
#pragma unroll
          for (int i = 0; i < S; ++i) {
            const float s_next = two_c[i] * s_cur[i] - s_prev[i];
            s_prev[i] = s_cur[i];
            s_cur[i] = s_next;
          }
        }
      }
      const int full = min(lo, hi) & ~3;
      int h0 = 0;
      for (; h0 < full; h0 += 4) {
        float v[8] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < S; ++i) {
            v[j] = fmaf(gf[i], s_cur[i], v[j]);
            v[4 + j] = fmaf(gr[i], s_cur[i], v[4 + j]);
            const float s_next = two_c[i] * s_cur[i] - s_prev[i];
            s_prev[i] = s_cur[i];
            s_cur[i] = s_next;
          }
        }
        put_partials<L>(part, row_len, hp, h0, pass, v);
      }
      for (; h0 < hi; h0 += 4) {
        float v[8] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < S; ++i) {
            const float sm = (h0 + j < n_aud[i]) ? s_cur[i] : 0.f;
            v[j] = fmaf(gf[i], sm, v[j]);
            v[4 + j] = fmaf(gr[i], sm, v[4 + j]);
            const float s_next = two_c[i] * s_cur[i] - s_prev[i];
            s_prev[i] = s_cur[i];
            s_cur[i] = s_next;
          }
        }
        put_partials<L>(part, row_len, hp, h0, pass, v);
      }
      if (pass == 0) {  // the chunks above every sample's limit
        float* row = part + (tid / L) * row_len;
        for (int c = h0 + (tid % L); c < hp; c += L) {
          row[c] = 0.f;
          row[hp + c] = 0.f;
        }
        // A later pass adds to these columns from another lane of the
        // group (scatter_index): order the stores before those reads.
        __syncwarp();
      }
    }
    __syncthreads();
    // Each hop's taps: its rows of partials, summed in row order.
    for (int i = tid; i < sp.G * 2 * hp; i += kTapThreads) {
      const int gi = i / (2 * hp);
      const int c = i - gi * 2 * hp;
      const float* src = part + gi * rows_per_hop * row_len + c;
      float sum = 0.f;
      for (int q = 0; q < rows_per_hop; ++q) sum += src[q * row_len];
      tot[i] = sum;
    }
    __syncthreads();
    // Fold: frame k = tap 0 of hop k + tap 1 of hop k - 1 (+ tap 1 of
    // hop k on the last frame), in fold_taps' order.
    const int k_first = kb - 1 + round * sp.G;
    for (int i = tid; i < sp.G * hp; i += kTapThreads) {
      const int gi = i / hp;
      const int h = i - gi * hp;
      const int kf = k_first + gi;
      if (h >= nh || kf < kb || kf >= kb + frames_blk || kf >= n_frames) {
        continue;
      }
      const float* t = tot + gi * 2 * hp;
      const float prev = gi > 0 ? t[-2 * hp + hp + h] : carry[h];
      float v = t[h] + prev;
      if (kf == n_frames - 1) v += t[hp + h];
      dham[((size_t)b * n_frames + kf) * n_harmonics + hb0 + h] = v;
    }
    __syncthreads();
    for (int h = tid; h < hp; h += kTapThreads) {
      carry[h] = tot[(sp.G - 1) * 2 * hp + hp + h];
    }
    // The next round's first barrier orders these reads of tot before its
    // writes, and the fold after it reads carry.
  }
}

template <int L>
cudaError_t launch_taps(const float* phase, const float* f0, const float* g,
                        float* dham, int batch, int n_samples, int n_frames,
                        int n_harmonics, int hop, float nyquist, int linear,
                        cudaStream_t stream) {
  const Split sp = split_hop(hop, kTapSamples, kTapThreads);
  const int frames_blk =
      taps_frames_per_block(sp, taps_min_frames(batch, n_frames));
  // Shared floats: partial rows, hop sums and carry per harmonic of a
  // block, row padding and the tap table besides (the kernel's layout).
  const long long rows = kTapThreads / L;
  const long long per_h = 2 * rows + 2 * sp.G + 1;
  const long long fixed = 4 * rows + 2 * (long long)hop;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  const long long fit = ((max_smem / (long long)sizeof(float) - fixed) /
                         per_h) & ~3LL;
  if (fit < 4) return cudaErrorInvalidValue;  // the tap table alone
  const int n_blk = (int)((round_up4(n_harmonics) + fit - 1) / fit);
  const int h_blk = round_up4((n_harmonics + n_blk - 1) / n_blk);
  const size_t smem = sizeof(float) * (size_t)(fixed + per_h * h_blk);
  e = allow_smem(harmonic_bwd_taps_kernel<L>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n_frames + frames_blk - 1) / frames_blk, batch,
                  (n_harmonics + h_blk - 1) / h_blk);
  harmonic_bwd_taps_kernel<L><<<grid, kTapThreads, smem, stream>>>(
      phase, f0, g, dham, n_samples, n_frames, n_harmonics, hop, nyquist,
      linear, frames_blk, h_blk);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_fwd(const float* phase, const float* f0, const float* ham,
                       float* out, int batch, int n_samples, int n_frames,
                       int n_harmonics, int hop, float nyquist, int linear,
                       cudaStream_t stream) {
  const Split sp = split_hop(hop, S, kFwdThreads);
  const size_t smem = sizeof(float) * ((size_t)(sp.G + 1) *
                                           round_up4(n_harmonics) +
                                       2 * (size_t)hop);
  const cudaError_t e = allow_smem(harmonic_fwd_kernel<S>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n_frames + sp.G - 1) / sp.G, batch);
  harmonic_fwd_kernel<S><<<grid, kFwdThreads, smem, stream>>>(
      phase, f0, ham, out, n_samples, n_frames, n_harmonics, hop, nyquist,
      linear);
  return cudaGetLastError();
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
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const auto args = [&](auto launch) {
    return launch((const float*)phase, (const float*)f0, (const float*)ham,
                  (float*)out, batch, n_samples, n_frames, n_harmonics, hop,
                  nyquist, linear, (cudaStream_t)stream);
  };
  // 4 samples a thread while that still leaves 512 threads an SM.
  const bool fills = (long long)batch * n_samples / 4 >= 512LL * sms;
  return (int)(fills ? args(launch_fwd<4>) : args(launch_fwd<1>));
}

// g, dphase: [batch, n_samples] float32; the rest as ddsp_harmonic_fwd.
extern "C" int ddsp_harmonic_bwd_phase(const void* phase, const void* f0,
                                       const void* ham, const void* g,
                                       void* dphase, int batch, int n_samples,
                                       int n_frames, int n_harmonics,
                                       float nyquist, int linear,
                                       void* stream) {
  const int hop = n_samples / n_frames;
  const int max_rows = (kPhaseThreads - 1) / hop + 3;
  const size_t smem = (size_t)max_rows * n_harmonics * sizeof(float);
  const cudaError_t e = allow_smem(harmonic_bwd_phase_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_samples + kPhaseThreads - 1) / kPhaseThreads, batch);
  harmonic_bwd_phase_kernel<<<grid, kPhaseThreads, smem,
                              (cudaStream_t)stream>>>(
      (const float*)phase, (const float*)f0, (const float*)ham,
      (const float*)g, (float*)dphase, n_samples, n_frames, n_harmonics, hop,
      nyquist, linear);
  return (int)cudaGetLastError();
}

// dham: [batch, n_frames, n_harmonics] float32, every element written; the
// rest as ddsp_harmonic_bwd_phase. Any n_harmonics: past the card's shared
// memory, the harmonics are split over the grid's z dimension. A hop whose
// tap table alone overflows it (over ~29000 samples) is refused.
extern "C" int ddsp_harmonic_bwd_taps(const void* phase, const void* f0,
                                      const void* g, void* dham, int batch,
                                      int n_samples, int n_frames,
                                      int n_harmonics, float nyquist,
                                      int linear, void* stream) {
  const int hop = n_samples / n_frames;
  const Split sp = split_hop(hop, kTapSamples, kTapThreads);
  const auto args = [&](auto launch) {
    return launch((const float*)phase, (const float*)f0, (const float*)g,
                  (float*)dham, batch, n_samples, n_frames, n_harmonics, hop,
                  nyquist, linear, (cudaStream_t)stream);
  };
  switch (taps_lanes(sp.P)) {
    case 8: return (int)args(launch_taps<8>);
    case 4: return (int)args(launch_taps<4>);
    case 2: return (int)args(launch_taps<2>);
    default: return (int)args(launch_taps<1>);
  }
}
