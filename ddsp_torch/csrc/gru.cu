// Fused GRU sequence of ddsp_torch: the forward (K2f) and backward (K2b)
// recurrences, each one launch, and K2b's weight-gradient pass.
//
// Replaces ddsp_tpu/ops/pallas_kernels/gru.py:_fwd_kernel (K2f) and
// _bwd_kernel (K2b), reached through _pallas_gru_fwd, _pallas_gru_bwd /
// fused_gru. Reset-after gates, xp = x @ wi + bi hoisted outside:
//
//   hp = h_{t-1} @ wh                           ([B, H] x [H, 3H])
//   r  = sigmoid(xp_r + hp_r),  z = sigmoid(xp_z + hp_z)
//   n  = tanh(xp_n + r * (hp_n + bn))
//   h_t = (1 - z) * n + z * h_{t-1}
//
// Backward (gru.py:176-209), walking time in reverse with dh carried:
//
//   r, z, n recomputed from xp_t and h_{t-1} (streamed in as h_prev)
//   dht = dh + g_t
//   dn_pre = dht (1 - z) (1 - n^2),  dz = dht (h_{t-1} - n) z (1 - z)
//   dr_pre = dn_pre (hp_n + bn) r (1 - r),  dhn = dn_pre r
//   dxp_t = [dr_pre, dz, dn_pre],  dhp = [dr_pre, dz, dhn] (stream type)
//   dh   = dht z + dhp @ wh^T
//   dwh += h_{t-1}^T dhp,  dbn += sum_b dhn
//
// Layout: xp [T, B, 3H], wh [H, 3H], h_prev [T, B, H], dxp at the stream
// type; bn [H], h0 [B, H], g and ys [T, B, H], dwh, dbn, dh0 float32.
//
// What bounds them. Each step needs all of h_{t-1} (or dh) from the step
// before, so both recurrences are latency-bound per serial step, not by
// FLOPs or bytes: at B = 16, T = 1000, H = 512 the forward is 25 GFLOP and
// 82 MB (about 26 us at the card's peak rates), but it is 1000 dependent
// steps, each a [16, 512] x [512, 1536] product, a gate update and an
// exchange of h between the SMs that own its parts.
//
// bf16 streams (the main path): thread-block clusters.
//   * One cluster per tile of 16 batch rows (kRows); rows never interact in
//     a GRU, so ceil(B / 16) clusters run independently, in later waves
//     when they do not all fit. Nothing grows with B.
//   * The cluster partitions the hidden units: each of its H / 32 CTAs
//     owns u = 32 units (kUnits), i.e. 96 gate columns of wh; at H = 512
//     that is a cluster of 16 (non-portable size). u is fixed at 32: the
//     96 columns are 12 n-tiles of mma.m16n8k16, and with them the forward
//     keeps its slice of wh in registers as mma B-fragments (96 per thread
//     at H = 512) and the backward keeps it in shared memory (96 KiB).
//   * The recurrent products run on tensor cores:
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, A = the tile's 16 rows
//     of h in bf16 (a tile of one row pads to 16), float32 accumulation:
//     exactly the reference's bf16 x bf16 -> f32 dot. Eight warps split K
//     four ways and N two ways, so each accumulator chains H / 64 mmas;
//     the four K-partials are summed in shared memory by the gate threads.
//   * The new h slice goes out in bf16, 16-byte st.async stores, to every
//     CTA of the cluster through distributed shared memory, into a
//     double-buffered [2, 16, H] A operand; ys[t] goes to device memory in
//     float32.
//   * No barrier per step: each buffer has an mbarrier in the receiving CTA
//     that expects the buffer's bytes (mbarrier.arrive.expect_tx), and each
//     st.async completes its bytes on it, so a CTA waits only for the data
//     it needs. Double buffering is safe without a barrier because a CTA
//     can only refill a buffer two steps on after every CTA has sent it the
//     step between, i.e. after every CTA has read the buffer. One cluster
//     barrier at the start (barriers initialised) and one at the end (no
//     CTA exits while stores to it may be in flight). This replaces the
//     cluster barrier per step (barrier.cluster.arrive/wait) of the first
//     version of this design, which took 2.9 us per forward step at
//     H = 512 against 2.1 us here (chip_smoke.py, PERF.md).
//   * K2b (a), the serial reverse-time kernel, uses the same cluster, the
//     same partition and the resident bf16 column slice w_col [H, 96]:
//     it recomputes hp from h_prev[t] (cp.async-prefetched a step ahead,
//     and issued before it waits for the previous step's dh, since it does
//     not depend on dh), forms dxp and dhp for its units, and computes its
//     partial dhp_own [16, 96] @ w_col^T [96, H] on the same slice (ldmatrix
//     without .trans reads it as the transposed operand). The partials are
//     reduce-scattered over DSMEM: each CTA sends each destination its
//     [16, 32] float32 block with st.async, double-buffered, completing on
//     the destination's mbarrier, and sums the C blocks it receives. A
//     second, row-major copy of wh would not fit beside the first.
//   * K2b (b): dwh = h_prev^T dhp over K = T * B and dbn are taken off the
//     serial path. (a) writes the dhn stream [T, B, H] (the other two thirds
//     of dhp are dxp's) and per-tile float32 sums of dhn [tiles, H]; a
//     Hopper GEMM kernel (TMA loads into a 4-stage ring, wgmma on both
//     operands as stored, K split over the SMs and the slices added in a
//     fixed order; see gru_wgrad_kernel) computes dwh and sums the tiles'
//     dbn. The products and roundings are those of the reference; only the
//     order of summation changes.
//   Shared memory per CTA at H = 512: forward 60 KiB (h double buffer
//   33 KiB, K-partials 26 KiB, h slice 1 KiB); backward 214 KiB (w_col
//   104 KiB, h_prev 16 KiB, dh partials 2 x 16 x 2 KiB, K-partials 26 KiB,
//   dhp 3 KiB). The cluster kernels take H in {64, 128, 256, 512}
//   (clusters of 2, 4, 8, 16): H a multiple of 64 for the K split, at most
//   16 CTAs per cluster. The wrapper runs any other H up to 512 on the
//   next of these sizes, zero-padded: padded units get zero xp columns,
//   wh rows and columns, bn and h0, so they stay exactly 0 and add exact
//   zeros to every real unit's sums.
//
// float32 streams (compute_dtype='float32', a parity mode), and bf16 streams
// past H = 512, where no cluster of at most 16 CTAs holds wh (at H = 1024
// bf16 wh alone is 6.3 MB against 16 x 227 KB): cooperative launches of
// H / u blocks, one per SM, each owning u units with their 3u columns of
// wh in shared memory at the stream type, one software grid barrier per
// step (a monotonic arrival counter). CUDA-core dot products with float32
// accumulation (exact float32 products, which TF32 tensor cores would not
// hold to the float32 tolerance; with bf16 streams h and dhp are rounded to
// bf16 first, as the cluster kernels and the plain versions round them);
// gates and carries are float32. The forward sends h through
// L2; the backward reduce-scatters dhp @ wh^T: each block writes its
// columns' partial for every unit and sums the partials of its own units
// after the barrier, so a block holds one copy of wh (and its float32 dwh
// columns), which fits H = 1024 in float32 for up to 19 rows a launch.
// Rows never interact, so a batch whose carries do not fit beside them runs
// as row groups, one launch each, in sequence (the wrapper plans them).
// Tiles of kBatchTile rows keep the rest of the footprint fixed. A float32
// forward of one step (T = 1, the VST hop) takes neither: gru_step_kernel
// is an ordinary launch without a grid barrier (one step exchanges
// nothing between steps).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__device__ __forceinline__ float gate_sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ------------------------------------------------------------------------
// Cooperative kernels with a software grid barrier: float32 streams, and
// bf16 streams past the clusters' 512 units. T is the stream type of xp,
// wh, h_prev and dxp.
// ------------------------------------------------------------------------

constexpr int kBatchTile = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the stream type: the operand the recurrent products take.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Bytes of a block's [cols][hidden] slice of wh at the stream type, rounded
// up so the float arrays after it stay 16-byte aligned.
__host__ __device__ inline size_t slice_bytes(int cols, int hidden,
                                              size_t item) {
  return ((size_t)cols * hidden * item + 15) & ~(size_t)15;
}

// All blocks arrive once per step; step t waits for gridDim.x * (t + 1)
// arrivals in total. The counter starts at 0 for each launch.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*((volatile unsigned int*)counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// out[b][c] = sum_k h_s[b][k] w_s[c][k] for b < nb, c < cols: one warp per
// column c, its lanes striding k, every row of the tile at once (each w
// element is read once a tile), then a shuffle sum per output. The order
// of each output's sum does not depend on nb.
template <typename TW>
__device__ __forceinline__ void warp_dots(const float* h_s, const TW* w_s,
                                          float* out, int nb, int cols,
                                          int hidden) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = warp; c < cols; c += kThreads / 32) {
    const TW* wv = w_s + (size_t)c * hidden;
    float acc[kBatchTile];
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) acc[b] = 0.f;
    for (int k = lane; k < hidden; k += 32) {
      const float w = to_f(wv[k]);
#pragma unroll
      for (int b = 0; b < kBatchTile; ++b) {
        if (b < nb) acc[b] = fmaf(h_s[b * hidden + k], w, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) {
      float a = acc[b];
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
      }
      if (lane == 0 && b < nb) out[b * cols + c] = a;
    }
  }
}

// Rows b of a launch are rows b0 + b of the caller's tensors: xp, ys, g,
// hprev and dxp step by ld rows per timestep (ld >= batch), h0 and dh0 are
// [batch, H] at the group's first row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
               const float* __restrict__ bn, const float* __restrict__ h0,
               float* ys, unsigned int* barrier, int seq_len, int batch,
               int ld, int hidden, int u) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = 3 * u;
  T* w_s = reinterpret_cast<T*>(smem);  // [cols][hidden]
  float* h_s = reinterpret_cast<float*>(
      smem + slice_bytes(cols, hidden, sizeof(T)));  // [kBatchTile][hidden]
  float* hp_s = h_s + kBatchTile * hidden;           // [kBatchTile][cols]
  float* carry = hp_s + kBatchTile * cols;           // [batch][u]
  const int j = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < cols * hidden; i += kThreads) {
    const int c = i / hidden;
    const int k = i - c * hidden;
    const int gate = c / u;
    w_s[i] = wh[(size_t)k * 3 * hidden + gate * hidden + j * u + (c - gate * u)];
  }
  for (int i = tid; i < batch * u; i += kThreads) {
    const int b = i / u;
    carry[i] = h0[(size_t)b * hidden + j * u + (i - b * u)];
  }

  for (int t = 0; t < seq_len; ++t) {
    // h_{t-1} was written by other blocks during this launch: read it
    // through L2 (ld.global.cg), never from a possibly stale L1 line.
    const float* h_prev = t == 0 ? h0 : ys + (size_t)(t - 1) * ld * hidden;
    const T* xp_t = xp + (size_t)t * ld * 3 * hidden;
    float* ys_t = ys + (size_t)t * ld * hidden;
    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int nb = min(kBatchTile, batch - b0);
      __syncthreads();  // the previous tile's h_s and hp_s are consumed
      for (int i = tid; i < nb * hidden; i += kThreads) {
        h_s[i] = round_to<T>(__ldcg(h_prev + (size_t)b0 * hidden + i));
      }
      __syncthreads();
      warp_dots(h_s, w_s, hp_s, nb, cols, hidden);
      __syncthreads();
      for (int i = tid; i < nb * u; i += kThreads) {
        const int b = i / u;
        const int uu = i - b * u;
        const int unit = j * u + uu;
        const T* x = xp_t + (size_t)(b0 + b) * 3 * hidden;
        const float* hp = hp_s + b * cols;
        const float r = gate_sigmoid(to_f(x[unit]) + hp[uu]);
        const float z = gate_sigmoid(to_f(x[hidden + unit]) + hp[u + uu]);
        const float n = tanhf(to_f(x[2 * hidden + unit]) +
                              r * (hp[2 * u + uu] + bn[unit]));
        float* c = carry + (b0 + b) * u + uu;
        const float h = (1.f - z) * n + z * *c;
        *c = h;
        ys_t[(size_t)(b0 + b) * hidden + unit] = h;
      }
    }
    grid_barrier(barrier, gridDim.x * (unsigned int)(t + 1));
  }
}

// g [T, ld, H], xp, hprev, dxp at the stream type; exchange: scratch of
// 2 * gridDim.x * batch * H floats, each block's partial dh for every unit
// ([gridDim.x][batch][H], double-buffered by step); dwh [H, 3H] and dbn [H]
// are added to (the caller zeroes them), dh0 [batch, H] written.
//
// Per step, block j owns u units, i.e. 3u columns of wh (w_col, in shared
// memory): it recomputes hp for them from h_prev, forms dxp and
// dhp_own = [dr_pre, dz, dhn] for its units, adds h_prev^T dhp_own into its
// columns of dwh (shared memory, float32), and computes its partial
// dhp_own @ w_col^T for all H units. After the grid barrier it sums the
// blocks' partials for its own units: a reduce-scatter through L2, as the
// cluster kernel does over DSMEM. One copy of wh a block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ g, const T* __restrict__ xp,
               const T* __restrict__ hprev, const T* __restrict__ wh,
               const float* __restrict__ bn, T* __restrict__ dxp,
               float* exchange, float* __restrict__ dwh,
               float* __restrict__ dbn, float* __restrict__ dh0,
               unsigned int* barrier, int seq_len, int batch, int ld,
               int hidden, int u) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = 3 * u;
  const int three_h = 3 * hidden;
  T* w_col = reinterpret_cast<T*>(smem);  // [cols][hidden]
  float* dwh_s = reinterpret_cast<float*>(
      smem + slice_bytes(cols, hidden, sizeof(T)));  // [cols][hidden]
  float* h_s = dwh_s + cols * hidden;            // [kBatchTile][hidden]
  float* hp_s = h_s + kBatchTile * hidden;       // [kBatchTile][cols]
  float* dhp_own = hp_s + kBatchTile * cols;     // [kBatchTile][cols]
  float* dhn_s = dhp_own + kBatchTile * cols;    // [kBatchTile][u]
  float* dh_s = dhn_s + kBatchTile * u;          // [batch][u], the carry
  float* dhz_s = dh_s + batch * u;               // [batch][u], dht * z
  float* dbn_s = dhz_s + batch * u;              // [u]
  const int j = blockIdx.x;
  const int n_blocks = gridDim.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < cols * hidden; i += kThreads) {
    const int c = i / hidden;
    const int k = i - c * hidden;
    const int gate = c / u;
    w_col[i] = wh[(size_t)k * three_h + gate * hidden + j * u + (c - gate * u)];
    dwh_s[i] = 0.f;
  }
  for (int i = tid; i < batch * u; i += kThreads) dh_s[i] = 0.f;
  for (int i = tid; i < u; i += kThreads) dbn_s[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < seq_len; ++step) {
    const int t = seq_len - 1 - step;
    const T* xp_t = xp + (size_t)t * ld * three_h;
    const T* hprev_t = hprev + (size_t)t * ld * hidden;
    const float* g_t = g + (size_t)t * ld * hidden;
    T* dxp_t = dxp + (size_t)t * ld * three_h;
    float* ex = exchange + (size_t)(step & 1) * n_blocks * batch * hidden;
    float* ex_own = ex + (size_t)j * batch * hidden;

    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int nb = min(kBatchTile, batch - b0);
      // h_{t-1} of this tile (an input of the launch: plain loads).
      for (int i = tid; i < nb * hidden; i += kThreads) {
        h_s[i] = to_f(hprev_t[(size_t)b0 * hidden + i]);
      }
      __syncthreads();
      warp_dots(h_s, w_col, hp_s, nb, cols, hidden);
      __syncthreads();
      for (int i = tid; i < nb * u; i += kThreads) {
        const int b = i / u;
        const int uu = i - b * u;
        const int unit = j * u + uu;
        const size_t row = (size_t)(b0 + b);
        const T* x = xp_t + row * three_h;
        const float* hp = hp_s + b * cols;
        const float hpn = hp[2 * u + uu] + bn[unit];
        const float r = gate_sigmoid(to_f(x[unit]) + hp[uu]);
        const float z = gate_sigmoid(to_f(x[hidden + unit]) + hp[u + uu]);
        const float n = tanhf(to_f(x[2 * hidden + unit]) + r * hpn);
        const float h_prev = h_s[b * hidden + unit];
        const float dht = dh_s[row * u + uu] + g_t[row * hidden + unit];
        const float dn_pre = dht * (1.f - z) * (1.f - n * n);
        const float dz = dht * (h_prev - n) * z * (1.f - z);
        const float dr_pre = dn_pre * hpn * r * (1.f - r);
        const float dhn = dn_pre * r;
        T* dx = dxp_t + row * three_h;
        dx[unit] = from_f<T>(dr_pre);
        dx[hidden + unit] = from_f<T>(dz);
        dx[2 * hidden + unit] = from_f<T>(dn_pre);
        // dhp at the stream type, as both products take it.
        float* own = dhp_own + b * cols;
        own[uu] = round_to<T>(dr_pre);
        own[u + uu] = round_to<T>(dz);
        own[2 * u + uu] = round_to<T>(dhn);
        dhn_s[i] = dhn;
        dhz_s[row * u + uu] = dht * z;
      }
      __syncthreads();
      // Per k: dwh[k, own columns] += h_{t-1}[:, k]^T dhp_own, and the
      // partial dh[:, k] = dhp_own . w_col[:, k] for this tile's rows.
      for (int k = tid; k < hidden; k += kThreads) {
        float hv[kBatchTile], pd[kBatchTile];
#pragma unroll
        for (int b = 0; b < kBatchTile; ++b) {
          hv[b] = b < nb ? h_s[b * hidden + k] : 0.f;
          pd[b] = 0.f;
        }
        for (int c = 0; c < cols; ++c) {
          const float w = to_f(w_col[c * hidden + k]);
          float acc = dwh_s[c * hidden + k];
#pragma unroll
          for (int b = 0; b < kBatchTile; ++b) {
            if (b < nb) {
              const float d = dhp_own[b * cols + c];
              acc = fmaf(hv[b], d, acc);
              pd[b] = fmaf(d, w, pd[b]);
            }
          }
          dwh_s[c * hidden + k] = acc;
        }
#pragma unroll
        for (int b = 0; b < kBatchTile; ++b) {
          if (b < nb) ex_own[(size_t)(b0 + b) * hidden + k] = pd[b];
        }
      }
      if (tid < u) {
        float acc = dbn_s[tid];
        for (int b = 0; b < nb; ++b) acc += dhn_s[b * u + tid];
        dbn_s[tid] = acc;
      }
      __syncthreads();
    }

    grid_barrier(barrier, n_blocks * (unsigned int)(step + 1));

    // dh_{t-1}[b, own units] = dht z + the blocks' partials, read through
    // L2 (other blocks wrote them in this launch).
    for (int i = tid; i < batch * u; i += kThreads) {
      const int b = i / u;
      const float* p = ex + (size_t)b * hidden + j * u + (i - b * u);
      float s = dhz_s[i];
      for (int jj = 0; jj < n_blocks; ++jj) {
        s += __ldcg(p + (size_t)jj * batch * hidden);
      }
      dh_s[i] = s;
    }
    __syncthreads();
  }

  for (int i = tid; i < cols * hidden; i += kThreads) {
    const int c = i / hidden;
    const int k = i - c * hidden;
    const int gate = c / u;
    dwh[(size_t)k * three_h + gate * hidden + j * u + (c - gate * u)] +=
        dwh_s[i];
  }
  for (int i = tid; i < u; i += kThreads) dbn[j * u + i] += dbn_s[i];
  for (int i = tid; i < batch * u; i += kThreads) {
    const int b = i / u;
    dh0[(size_t)b * hidden + j * u + (i - b * u)] = dh_s[i];
  }
}

size_t fwd_smem_bytes(int hidden, int batch, int u, size_t item) {
  const size_t cols = 3 * (size_t)u;
  return slice_bytes((int)cols, hidden, item) +
         sizeof(float) * ((size_t)kBatchTile * (hidden + cols) +
                          (size_t)batch * u);
}

size_t bwd_smem_bytes(int hidden, int batch, int u, size_t item) {
  const size_t cols = 3 * (size_t)u;
  return slice_bytes((int)cols, hidden, item) +
         sizeof(float) * (cols * hidden +
                          (size_t)kBatchTile * (hidden + 2 * cols + u) +
                          2 * (size_t)batch * u + u);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* blocks_per_sm, int* n_sms) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a pending error
    return (int)e;
  }
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, smem);
}

template <typename Kernel>
int launch_cooperative(Kernel kernel, size_t smem, int n_blocks, void** args,
                       void* stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(n_blocks),
                                  dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int coop_occupancy(int hidden, int batch, int u, int bwd, int* blocks_per_sm,
                   int* n_sms) {
  return bwd ? occupancy(gru_bwd_kernel<T>,
                         bwd_smem_bytes(hidden, batch, u, sizeof(T)),
                         blocks_per_sm, n_sms)
             : occupancy(gru_fwd_kernel<T>,
                         fwd_smem_bytes(hidden, batch, u, sizeof(T)),
                         blocks_per_sm, n_sms);
}

template <typename T>
int coop_fwd(const void* xp, const void* wh, const void* bn, const void* h0,
             void* ys, void* barrier, int seq_len, int batch, int ld,
             int hidden, int u, void* stream) {
  const T* xp_t = (const T*)xp;
  const T* wh_t = (const T*)wh;
  const float* bn_f = (const float*)bn;
  const float* h0_f = (const float*)h0;
  float* ys_f = (float*)ys;
  unsigned int* bar = (unsigned int*)barrier;
  void* args[] = {&xp_t, &wh_t, &bn_f, &h0_f, &ys_f, &bar,
                  &seq_len, &batch, &ld, &hidden, &u};
  return launch_cooperative(gru_fwd_kernel<T>,
                            fwd_smem_bytes(hidden, batch, u, sizeof(T)),
                            hidden / u, args, stream);
}

template <typename T>
int coop_bwd(const void* g, const void* xp, const void* hprev, const void* wh,
             const void* bn, void* dxp, void* exchange, void* dwh, void* dbn,
             void* dh0, void* barrier, int seq_len, int batch, int ld,
             int hidden, int u, void* stream) {
  const float* g_f = (const float*)g;
  const T* xp_t = (const T*)xp;
  const T* hprev_t = (const T*)hprev;
  const T* wh_t = (const T*)wh;
  const float* bn_f = (const float*)bn;
  T* dxp_t = (T*)dxp;
  float* ex_f = (float*)exchange;
  float* dwh_f = (float*)dwh;
  float* dbn_f = (float*)dbn;
  float* dh0_f = (float*)dh0;
  unsigned int* bar = (unsigned int*)barrier;
  void* args[] = {&g_f, &xp_t, &hprev_t, &wh_t, &bn_f, &dxp_t, &ex_f,
                  &dwh_f, &dbn_f, &dh0_f, &bar, &seq_len, &batch, &ld,
                  &hidden, &u};
  return launch_cooperative(gru_bwd_kernel<T>,
                            bwd_smem_bytes(hidden, batch, u, sizeof(T)),
                            hidden / u, args, stream);
}

// ------------------------------------------------------------------------
// K2f at one step (T = 1) with float32 streams: the VST hop.
// ------------------------------------------------------------------------
//
// One step has no step-to-step exchange, so it needs no co-resident grid,
// no grid barrier and no copy of wh in shared memory: an ordinary launch of
// ceil(H / kStepUnits) blocks, each owning kStepUnits units, i.e. 3 x
// kStepUnits columns of wh, read straight from device memory (wh is 3.1 MB
// at H = 512 and stays in L2 from hop to hop). What bounds it: bytes (wh
// read once, 0.94 us at 3.35 TB/s), and in practice the launch and the
// latency of each thread's chain of loads, so K is split kStepSplit ways
// over the block's threads: thread (p, c) sums h[b][k] wh[k][c] over
// k = p, p + kStepSplit, ... in float32 FMAs (exact products, no TF32),
// and the gate threads add the kStepSplit partials in order p = 0, 1, ...
// Rows of h0 are staged kStepRows at a time; rows are independent, so any
// B runs, one pass of kStepRows rows after another.
constexpr int kStepUnits = 4;
constexpr int kStepCols = 3 * kStepUnits;
constexpr int kStepSplit = 32;
constexpr int kStepThreads = kStepCols * kStepSplit;  // 384
constexpr int kStepRows = 8;

size_t step_smem_bytes(int hidden) {
  return sizeof(float) * ((size_t)kStepRows * hidden +
                          (size_t)kStepSplit * kStepRows * kStepCols);
}

__global__ void __launch_bounds__(kStepThreads)
gru_step_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
                const float* __restrict__ bn, const float* __restrict__ h0,
                float* __restrict__ ys, int batch, int hidden) {
  extern __shared__ __align__(16) float step_smem[];
  float* h_s = step_smem;                  // [kStepRows][hidden]
  float* part = h_s + kStepRows * hidden;  // [kStepSplit][kStepRows][kStepCols]
  const int tid = threadIdx.x;
  const int c = tid % kStepCols, p = tid / kStepCols;
  const int unit0 = blockIdx.x * kStepUnits;
  const int unit = unit0 + c % kStepUnits;
  const bool live = unit < hidden;
  const size_t three_h = 3 * (size_t)hidden;
  const float* w = wh + (c / kStepUnits) * hidden + (live ? unit : 0);
  for (int b0 = 0; b0 < batch; b0 += kStepRows) {
    const int nb = min(kStepRows, batch - b0);
    __syncthreads();  // the previous pass is done with h_s and part
    for (int i = tid; i < nb * hidden; i += kStepThreads) {
      h_s[i] = h0[(size_t)b0 * hidden + i];
    }
    __syncthreads();
    float acc[kStepRows];
#pragma unroll
    for (int b = 0; b < kStepRows; ++b) acc[b] = 0.f;
    if (live) {
#pragma unroll 4
      for (int k = p; k < hidden; k += kStepSplit) {
        const float wk = __ldg(w + k * three_h);
#pragma unroll
        for (int b = 0; b < kStepRows; ++b) {
          if (b < nb) acc[b] = fmaf(h_s[b * hidden + k], wk, acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kStepRows; ++b) {
      if (b < nb) part[(p * kStepRows + b) * kStepCols + c] = acc[b];
    }
    __syncthreads();
    for (int i = tid; i < nb * kStepUnits; i += kStepThreads) {
      const int b = i / kStepUnits, uu = i % kStepUnits;
      const int un = unit0 + uu;
      if (un >= hidden) continue;
      float hp[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        float s = 0.f;
        for (int q = 0; q < kStepSplit; ++q) {
          s += part[(q * kStepRows + b) * kStepCols + gate * kStepUnits + uu];
        }
        hp[gate] = s;
      }
      const float* x = xp + (size_t)(b0 + b) * three_h;
      const float r = gate_sigmoid(x[un] + hp[0]);
      const float z = gate_sigmoid(x[hidden + un] + hp[1]);
      const float n = tanhf(x[2 * hidden + un] + r * (hp[2] + bn[un]));
      ys[(size_t)(b0 + b) * hidden + un] =
          (1.f - z) * n + z * h_s[b * hidden + un];
    }
  }
}

// ------------------------------------------------------------------------
// bf16: cluster kernels on tensor cores.
// ------------------------------------------------------------------------

constexpr int kRows = 16;   // batch rows per cluster: mma's M
constexpr int kUnits = 32;  // hidden units per CTA
constexpr int kCols = 3 * kUnits;
constexpr int kKw = 4;      // warps along K in h @ w_col
constexpr int kNw = 2;      // warps along N in h @ w_col
constexpr int kNt = kCols / 8 / kNw;  // n-tiles per warp in h @ w_col
constexpr int kPad = kCols + 8;  // row stride (elements) of [*, 96] tiles
static_assert(kKw * kNw * 32 == kThreads, "8 warps");
static_assert(kRows * kUnits == 2 * kThreads, "two units per gate thread");

template <int H>
struct Shape {
  static_assert(H % 64 == 0 && H / kUnits <= 16, "H in {64, ..., 512}");
  static constexpr int kCluster = H / kUnits;
  static constexpr int kKt = H / 16 / kKw;        // k-tiles per warp
  static constexpr int kNt2 = H / 8 / (kThreads / 32);  // dhp @ w_col^T
  static constexpr int kHs = H + 8;               // row stride of h tiles
  static constexpr size_t kHBytes = (size_t)kRows * kHs * sizeof(bf16);
  static constexpr size_t kPartialBytes = (size_t)kKw * kRows * kPad * 4;
  static constexpr size_t kRecvBytes =
      (size_t)2 * kCluster * kRows * kUnits * 4;
  static constexpr size_t kFwdSmem =
      2 * kHBytes + kPartialBytes + kRows * kUnits * sizeof(bf16) + 16;
  static constexpr size_t kBwdSmem = (size_t)H * kPad * sizeof(bf16) +
                                     kHBytes + kRecvBytes + kPartialBytes +
                                     (size_t)kRows * kPad * sizeof(bf16) + 16;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of complete_tx in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async_v4(unsigned addr, uint4 v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_v2f(unsigned addr, float a, float b,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// Column j (0..95) of a CTA's slice -> column of wh [H, 3H].
__device__ __forceinline__ int slice_col(int j, int rank, int hidden) {
  return (j / kUnits) * hidden + rank * kUnits + j % kUnits;
}

// The gate threads: thread tid owns batch row tid / 16 of the tile and the
// units 2 (tid % 16) and 2 (tid % 16) + 1 of the CTA.
struct GateThread {
  int row;   // row in the tile
  int uu;    // first of its two units in the CTA
  __device__ GateThread() : row(threadIdx.x >> 4), uu((threadIdx.x & 15) * 2) {}
};

// hp for the gate thread's two units: the kKw K-partials summed.
__device__ __forceinline__ void sum_partials(const float* partial,
                                             const GateThread& gt,
                                             float (&hp)[3][2]) {
#pragma unroll
  for (int gate = 0; gate < 3; ++gate) {
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kKw; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(
          partial + (k * kRows + gt.row) * kPad + gate * kUnits + gt.uu);
      s.x += v.x;
      s.y += v.y;
    }
    hp[gate][0] = s.x;
    hp[gate][1] = s.y;
  }
}

// Write a warp's [16, 8 * kNt] K-partial (mma accumulator layout).
__device__ __forceinline__ void store_partial(float* partial,
                                              const float (&acc)[kNt][4],
                                              int kw, int nw) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  float* pw = partial + kw * kRows * kPad;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = (nw * kNt + nt) * 8 + 2 * c;
    *reinterpret_cast<float2*>(pw + g * kPad + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * kPad + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// K2f, bf16. Grid (H / 32, ceil(B / 16)), clusters of (H / 32, 1, 1).
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_cluster(const bf16* __restrict__ xp, const bf16* __restrict__ wh,
                const float* __restrict__ bn, const float* __restrict__ h0,
                float* __restrict__ ys, int seq_len, int batch) {
  using S = Shape<H>;
  constexpr int kHs = S::kHs;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hbuf = reinterpret_cast<bf16*>(smem);  // [2][16][kHs]
  float* partial = reinterpret_cast<float*>(smem + 2 * S::kHBytes);
  bf16* stage = reinterpret_cast<bf16*>(smem + 2 * S::kHBytes +
                                        S::kPartialBytes);  // [16][32]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int kw = warp % kKw, nw = warp / kKw;
  constexpr int three_h = 3 * H;

  // This warp's part of w_col as mma B-fragments, for the whole sequence.
  uint32_t bfrag[S::kKt][kNt][2];
#pragma unroll
  for (int kt = 0; kt < S::kKt; ++kt) {
    const int k = (kw * S::kKt + kt) * 16 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = slice_col((nw * kNt + nt) * 8 + g, rank, H);
      const bf16* w = wh + (size_t)k * three_h + col;
      bfrag[kt][nt][0] = pack_raw(w[0], w[three_h]);
      bfrag[kt][nt][1] = pack_raw(w[8 * three_h], w[9 * three_h]);
    }
  }

  const GateThread gt;
  const int row = row0 + gt.row;
  const bool valid = row < batch;
  const int unit = rank * kUnits + gt.uu;
  float carry[2] = {0.f, 0.f};
  if (valid) {
    const float2 v = *reinterpret_cast<const float2*>(h0 + (size_t)row * H + unit);
    carry[0] = v.x;
    carry[1] = v.y;
  }
  const float2 bnv = *reinterpret_cast<const float2*>(bn + unit);

  // h_{-1} = h0 in bf16, all H columns of the tile's rows.
  for (int i = tid; i < kRows * H / 8; i += kThreads) {
    const int r = i / (H / 8), q = (i % (H / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < batch) {
      const float4* src = reinterpret_cast<const float4*>(
          h0 + (size_t)(row0 + r) * H + q);
      const float4 a = src[0], b = src[1];
      v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                     pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(hbuf + r * kHs + q) = v;
  }

  uint32_t x[3] = {0, 0, 0};  // xp_t for the two units, per gate
  auto load_xp = [&](int t) {
    if (valid) {
      const bf16* src = xp + ((size_t)t * batch + row) * three_h + unit;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        x[gate] = *reinterpret_cast<const uint32_t*>(src + gate * H);
      }
    }
  };
  // full[b]: h buffer b holds this phase's h, all kCluster slices.
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kRows * kUnits);
  constexpr unsigned kFill = S::kCluster * kRows * kUnits * sizeof(bf16);
  load_xp(0);
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    mbar_expect(&full[0], kFill);
    mbar_expect(&full[1], kFill);
  }
  cluster.sync();  // every CTA runs, holds h0 and its barriers
  unsigned parity = 0;  // bit b: the phase of full[b] to wait for

  for (int t = 0; t < seq_len; ++t) {
    const bf16* h_cur = hbuf + (t & 1) * kRows * kHs;
    bf16* h_next = hbuf + ((t + 1) & 1) * kRows * kHs;
    if (t > 0) {
      const int b = t & 1;
      mbar_wait(&full[b], (parity >> b) & 1);
      parity ^= 1u << b;
      if (tid == 0) mbar_expect(&full[b], kFill);  // its fill two steps on
    }

    float acc[kNt][4] = {};
#pragma unroll
    for (int kt = 0; kt < S::kKt; ++kt) {
      const int k0 = (kw * S::kKt + kt) * 16;
      uint32_t a[4];
      ldsm_x4(a, h_cur + (lane & 15) * kHs + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        mma_bf16(acc[nt], a, bfrag[kt][nt][0], bfrag[kt][nt][1]);
      }
    }
    store_partial(partial, acc, kw, nw);
    __syncthreads();

    float hp[3][2];
    sum_partials(partial, gt, hp);
    float h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xr = e ? unpack_bf16(x[0]).y : unpack_bf16(x[0]).x;
      const float xz = e ? unpack_bf16(x[1]).y : unpack_bf16(x[1]).x;
      const float xn = e ? unpack_bf16(x[2]).y : unpack_bf16(x[2]).x;
      const float b = e ? bnv.y : bnv.x;
      const float r = gate_sigmoid(xr + hp[0][e]);
      const float z = gate_sigmoid(xz + hp[1][e]);
      const float n = tanhf(xn + r * (hp[2][e] + b));
      h[e] = (1.f - z) * n + z * carry[e];
      carry[e] = h[e];
    }
    if (valid) {
      *reinterpret_cast<float2*>(ys + ((size_t)t * batch + row) * H + unit) =
          make_float2(h[0], h[1]);
    }
    *reinterpret_cast<uint32_t*>(stage + gt.row * kUnits + gt.uu) =
        pack_bf16(h[0], h[1]);
    __syncthreads();

    // The CTA's [16, 32] slice of h_t to every CTA of the cluster.
    if (t + 1 < seq_len) {
      uint64_t* bar = &full[(t + 1) & 1];
      for (int i = tid; i < S::kCluster * kRows * 4; i += kThreads) {
        const int dst = i / (kRows * 4), v = i % (kRows * 4);
        const int r = v >> 2, q = (v & 3) * 8;
        const uint4 val =
            *reinterpret_cast<const uint4*>(stage + r * kUnits + q);
        st_async_v4(map_rank(h_next + r * kHs + rank * kUnits + q, dst), val,
                    map_rank(bar, dst));
      }
      load_xp(t + 1);
    }
  }
  cluster.sync();  // no CTA exits while stores to it may be in flight
}

// K2b (a), bf16. Grid and clusters as the forward. Writes dxp [T, B, 3H]
// and the dhn stream [T, B, H] (bf16), dbn_part [tiles, H] (per-tile sums
// of dhn) and dh0 [B, H] (float32).
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_cluster(const float* __restrict__ g, const bf16* __restrict__ xp,
                const bf16* __restrict__ hprev, const bf16* __restrict__ wh,
                const float* __restrict__ bn, bf16* __restrict__ dxp,
                bf16* __restrict__ dhn_out, float* __restrict__ dbn_part,
                float* __restrict__ dh0, int seq_len, int batch) {
  using S = Shape<H>;
  constexpr int kHs = S::kHs;
  constexpr int kC = S::kCluster;
  constexpr int three_h = 3 * H;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [H][kPad], w_col
  unsigned char* p = smem + (size_t)H * kPad * sizeof(bf16);
  bf16* h_a = reinterpret_cast<bf16*>(p);  // [16][kHs], h_prev[t]
  p += S::kHBytes;
  float* recv = reinterpret_cast<float*>(p);  // [2][kC][16][32]
  p += S::kRecvBytes;
  float* partial = reinterpret_cast<float*>(p);  // [kKw][16][kPad]
  p += S::kPartialBytes;
  bf16* dhp_s = reinterpret_cast<bf16*>(p);  // [16][kPad]
  // rfull[b]: recv[b] holds this phase's kC blocks of dh partials.
  uint64_t* rfull = reinterpret_cast<uint64_t*>(dhp_s + kRows * kPad);
  constexpr unsigned kFill = kC * kRows * kUnits * sizeof(float);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int kw = warp % kKw, nw = warp / kKw;

  for (int i = tid; i < H * (kCols / 8); i += kThreads) {
    const int k = i / (kCols / 8), j = (i % (kCols / 8)) * 8;
    *reinterpret_cast<uint4*>(w_s + k * kPad + j) =
        *reinterpret_cast<const uint4*>(wh + (size_t)k * three_h +
                                        slice_col(j, rank, H));
  }
  auto prefetch_h = [&](int t) {
    for (int i = tid; i < kRows * H / 8; i += kThreads) {
      const int r = i / (H / 8), q = (i % (H / 8)) * 8;
      const bool ok = row0 + r < batch;
      cp_async16(h_a + r * kHs + q,
                 hprev + ((size_t)t * batch + (ok ? row0 + r : 0)) * H + q, ok);
    }
    cp_async_commit();
  };

  const GateThread gt;
  const int row = row0 + gt.row;
  const bool valid = row < batch;
  const int unit = rank * kUnits + gt.uu;
  const float2 bnv = *reinterpret_cast<const float2*>(bn + unit);
  uint32_t x[3] = {0, 0, 0};
  float2 gv = make_float2(0.f, 0.f);
  auto load_step = [&](int t) {
    if (valid) {
      const bf16* src = xp + ((size_t)t * batch + row) * three_h + unit;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        x[gate] = *reinterpret_cast<const uint32_t*>(src + gate * H);
      }
      gv = *reinterpret_cast<const float2*>(g + ((size_t)t * batch + row) * H +
                                            unit);
    }
  };

  // hp = h_prev[t] @ w_col into the K-partials; the gate thread's own
  // h_prev values into hv.
  float hv[2];
  auto recompute_hp = [&]() {
    float acc[kNt][4] = {};
#pragma unroll
    for (int kt = 0; kt < S::kKt; ++kt) {
      const int k0 = (kw * S::kKt + kt) * 16;
      uint32_t a[4];
      ldsm_x4(a, h_a + (lane & 15) * kHs + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int pr = 0; pr < kNt / 2; ++pr) {
        const int n0 = (nw * kNt + 2 * pr) * 8;
        uint32_t b[4];
        ldsm_x4_trans(b, w_s + (k0 + (lane & 15)) * kPad + n0 + (lane >> 4) * 8);
        mma_bf16(acc[2 * pr], a, b[0], b[1]);
        mma_bf16(acc[2 * pr + 1], a, b[2], b[3]);
      }
    }
    store_partial(partial, acc, kw, nw);
    const float2 h = unpack_bf16(
        *reinterpret_cast<const uint32_t*>(h_a + gt.row * kHs + unit));
    hv[0] = h.x;
    hv[1] = h.y;
  };

  float dh[2] = {0.f, 0.f}, dhz[2] = {0.f, 0.f}, dbn_acc[2] = {0.f, 0.f};
  auto reduce_dh = [&](int buf) {
    const float* rb = recv + (size_t)buf * kC * kRows * kUnits;
#pragma unroll
    for (int e = 0; e < 2; ++e) dh[e] = dhz[e];
#pragma unroll 4
    for (int src = 0; src < kC; ++src) {
      const float2 v = *reinterpret_cast<const float2*>(
          rb + (src * kRows + gt.row) * kUnits + gt.uu);
      dh[0] += v.x;
      dh[1] += v.y;
    }
  };

  const int t_last = seq_len - 1;
  prefetch_h(t_last);
  load_step(t_last);
  cp_async_wait<0>();
  if (tid == 0) {
    mbar_init(&rfull[0], 1);
    mbar_init(&rfull[1], 1);
    mbar_fence_init();
    mbar_expect(&rfull[0], kFill);
    mbar_expect(&rfull[1], kFill);
  }
  __syncthreads();
  cluster.sync();  // every CTA runs and holds its barriers
  unsigned parity = 0;
  recompute_hp();
  __syncthreads();
  if (t_last > 0) prefetch_h(t_last - 1);

  for (int s = 0; s < seq_len; ++s) {
    const int t = t_last - s;
    const int buf = s & 1;
    if (s > 0) {
      mbar_wait(&rfull[buf ^ 1], (parity >> (buf ^ 1)) & 1);
      parity ^= 1u << (buf ^ 1);
      if (tid == 0) mbar_expect(&rfull[buf ^ 1], kFill);
      reduce_dh(buf ^ 1);
    }

    float hp[3][2];
    sum_partials(partial, gt, hp);
    float dr_pre[2], dz[2], dn_pre[2], dhn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xr = e ? unpack_bf16(x[0]).y : unpack_bf16(x[0]).x;
      const float xz = e ? unpack_bf16(x[1]).y : unpack_bf16(x[1]).x;
      const float xn = e ? unpack_bf16(x[2]).y : unpack_bf16(x[2]).x;
      const float hpn = hp[2][e] + (e ? bnv.y : bnv.x);
      const float r = gate_sigmoid(xr + hp[0][e]);
      const float z = gate_sigmoid(xz + hp[1][e]);
      const float n = tanhf(xn + r * hpn);
      const float dht = dh[e] + (e ? gv.y : gv.x);
      dn_pre[e] = dht * (1.f - z) * (1.f - n * n);
      dz[e] = dht * (hv[e] - n) * z * (1.f - z);
      dr_pre[e] = dn_pre[e] * hpn * r * (1.f - r);
      dhn[e] = dn_pre[e] * r;
      dhz[e] = dht * z;
      dbn_acc[e] += dhn[e];
    }
    const uint32_t pr = pack_bf16(dr_pre[0], dr_pre[1]);
    const uint32_t pz = pack_bf16(dz[0], dz[1]);
    const uint32_t pn = pack_bf16(dhn[0], dhn[1]);
    if (valid) {
      bf16* dx = dxp + ((size_t)t * batch + row) * three_h + unit;
      *reinterpret_cast<uint32_t*>(dx) = pr;
      *reinterpret_cast<uint32_t*>(dx + H) = pz;
      *reinterpret_cast<uint32_t*>(dx + 2 * H) = pack_bf16(dn_pre[0], dn_pre[1]);
      *reinterpret_cast<uint32_t*>(dhn_out + ((size_t)t * batch + row) * H +
                                   unit) = pn;
    }
    bf16* own = dhp_s + gt.row * kPad + gt.uu;
    *reinterpret_cast<uint32_t*>(own) = pr;
    *reinterpret_cast<uint32_t*>(own + kUnits) = pz;
    *reinterpret_cast<uint32_t*>(own + 2 * kUnits) = pn;
    __syncthreads();

    // dhp_own [16, 96] @ w_col^T [96, H]: this CTA's share of dh for every
    // unit, sent to the CTA owning the unit.
    {
      uint32_t a[kCols / 16][4];
#pragma unroll
      for (int kt = 0; kt < kCols / 16; ++kt) {
        ldsm_x4(a[kt], dhp_s + (lane & 15) * kPad + kt * 16 + (lane >> 4) * 8);
      }
      float* send = recv + ((size_t)buf * kC + rank) * kRows * kUnits;
#pragma unroll
      for (int nt = 0; nt < S::kNt2; ++nt) {
        const int n0 = (warp * S::kNt2 + nt) * 8;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kp = 0; kp < kCols / 32; ++kp) {
          uint32_t b[4];
          ldsm_x4(b, w_s + (n0 + (lane & 7)) * kPad + kp * 32 + (lane >> 3) * 8);
          mma_bf16(acc, a[2 * kp], b[0], b[1]);
          mma_bf16(acc, a[2 * kp + 1], b[2], b[3]);
        }
        const int dst = n0 / kUnits;
        const int col = n0 % kUnits + 2 * cq;
        const unsigned bar = map_rank(&rfull[buf], dst);
        st_async_v2f(map_rank(send + gq * kUnits + col, dst), acc[0], acc[1],
                     bar);
        st_async_v2f(map_rank(send + (gq + 8) * kUnits + col, dst), acc[2],
                     acc[3], bar);
      }
    }
    if (t > 0) {
      // The next step's hp does not depend on dh: overlap the exchange.
      load_step(t - 1);
      cp_async_wait<0>();
      __syncthreads();
      recompute_hp();
      __syncthreads();
      if (t > 1) prefetch_h(t - 2);
    }
  }
  {
    const int b = (seq_len - 1) & 1;
    mbar_wait(&rfull[b], (parity >> b) & 1);
    reduce_dh(b);
  }
  if (valid) {
    *reinterpret_cast<float2*>(dh0 + (size_t)row * H + unit) =
        make_float2(dh[0], dh[1]);
  }
  // Per-tile dbn: the 16 rows' sums of dhn (padded rows add zeros).
  __syncthreads();
  *reinterpret_cast<float2*>(partial + gt.row * kUnits + gt.uu) =
      make_float2(dbn_acc[0], dbn_acc[1]);
  __syncthreads();
  if (tid < kUnits) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += partial[r * kUnits + tid];
    dbn_part[(size_t)blockIdx.y * H + rank * kUnits + tid] = s;
  }
  cluster.sync();  // no CTA exits while stores to it may be in flight
}

// ------------------------------------------------------------------------
// K2b (b), the weight-gradient pass: TMA loads, wgmma, split K.
// ------------------------------------------------------------------------
//
// dwh [H, 3H] = h_prev^T [dxp_r, dxp_z, dhn] over K = rows = T * B, and
// dbn [H] = the sum of K2b (a)'s per-tile partials dbn_part [dbn_rows, H].
// The reference (gru.py:203-207) adds h_{t-1}^T dhp into a resident
// accumulator step by step; here the T steps are one product over K.
//
// What bounds it: operations. At B = 16, T = 1000, H = 512 it is 25.2 GFLOP
// of bf16 products (25.4 us at the card's 989 TFLOP/s) on 65.5 MB of
// streams (19.6 us at 3.35 TB/s). The design:
//   * CTA tiles of BM x BN outputs, BM = min(128, H), BN = min(256, H). BN
//     divides H, so a tile's columns lie all in dxp's first 2H columns or
//     all in dhn, never across the boundary. Both operands are read as they
//     are stored, MN-major: A = h_prev^T from h_prev [rows, H] ([k][m]), B
//     from dxp [rows, 3H] or dhn [rows, H] ([k][n]); wgmma's transpose bits
//     take them so, and nothing is transposed in memory.
//   * K in chunks of kWgBk = 64 rows through a ring of kWgStages = 4 stages.
//     One thread of the producer warpgroup issues each stage's TMA loads
//     (boxes of 64 rows x 64 columns, 128-byte swizzle; rows past T * B
//     arrive as zeros) onto the stage's `full` mbarrier. Each consumer
//     warpgroup runs wgmma.m64nBNk16 on its 64 rows of the tile with both
//     operands in shared memory and float32 sums in registers, and frees a
//     stage (its `empty` mbarrier) once the next stage's products are issued
//     and its own have completed.
//   * Split K: H = 512 has only 24 tiles of 128 x 256 against 132 SMs, so
//     each tile's rows are cut into S slices of whole chunks, one CTA each,
//     and the S CTAs of a tile form a thread-block cluster (kernels/gru.py
//     wgrad_plan: S <= 8, tiles x S CTAs in one wave, all clusters
//     resident). After its last products each CTA stages its float32
//     partial tile in its own shared memory (over the ring); after a
//     cluster barrier, CTA r of the cluster adds up its share of the
//     tile's rows from all S CTAs' shared memory (DSMEM) in rank order,
//     0 to S - 1, and writes them to dwh; a second cluster barrier keeps
//     every CTA resident until its tile has been read. Nothing partial
//     goes through device memory, and the order is fixed, so dwh is
//     bit-identical from call to call. CTA 0 of each cluster in column
//     block 0 also adds up dbn, in tile order.
//   The products are exact (bf16 x bf16 in float32) and the sums float32:
//   only their order differs from the reference's.
constexpr int kWgBk = 64;      // rows of K per stage
constexpr int kWgStages = 4;
constexpr int kWgBox = 64;     // columns per TMA box: one 128-byte atom
constexpr int kWgBoxBytes = kWgBk * kWgBox * 2;  // 8 KiB
constexpr int kWgMaxSplits = 8;  // K slices: CTAs in a portable cluster

template <int BM, int BN>
struct WgradShape {
  static_assert(BM % 64 == 0 && BM <= 128 && BN % kWgBox == 0 && BN <= 256,
                "wgmma tiles");
  static constexpr int kConsumers = BM / 64;  // warpgroups of 64 rows
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = BM / kWgBox * kWgBoxBytes;
  static constexpr int kStageBytes = (BM + BN) / kWgBox * kWgBoxBytes;
  static constexpr int kAcc = BN / 2;  // float32 sums per consumer thread
  // The partial tile staged over the ring, rows padded by 8 floats (no bank
  // conflicts in the fragments' float2 stores, 16-byte aligned rows).
  static constexpr int kTileLd = BN + 8;
  static_assert((size_t)BM * kTileLd * 4 <= (size_t)kWgStages * kStageBytes,
                "the staged tile fits over the ring");
  // 1024 bytes to align the ring to the swizzle pattern, the ring, and two
  // mbarriers a stage.
  static constexpr size_t kSmem = 1024 + (size_t)kWgStages * kStageBytes +
                                  2 * kWgStages * sizeof(uint64_t);
};

// A wgmma shared-memory matrix descriptor of a 128-byte-swizzled MN-major
// operand, in atoms of 64 (MN) x 8 (K) bf16, a K row 128 bytes long. lbo:
// bytes from one 64-wide atom to the next along MN; sbo: bytes from one
// group of 8 K rows to the next. Base offset 0: every start address lies on
// a 1024-byte boundary, where the swizzle pattern starts.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
struct Wgmma;

// d[32] += A (64 x 16) B (16 x 64), both MN-major in shared memory.
template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// d[64] += A (64 x 16) B (16 x 128), both MN-major in shared memory.
template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// d[128] += A (64 x 16) B (16 x 256), both MN-major in shared memory.
template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A 2D TMA load of one box at (column c0, row c1), completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Barrier 1 over the consumer warpgroups only.
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

template <int BM, int BN>
__global__ void __launch_bounds__(WgradShape<BM, BN>::kThreads, 1)
gru_wgrad_kernel(const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_dxp,
                 const __grid_constant__ CUtensorMap map_dhn,
                 const float* __restrict__ dbn_part, float* __restrict__ dwh,
                 float* __restrict__ dbn, int hidden, int dbn_rows,
                 int n_chunks) {
  using S = WgradShape<BM, BN>;
  extern __shared__ __align__(16) unsigned char wgrad_smem[];
  unsigned char* ring =
      wgrad_smem + ((1024 - (smem_addr(wgrad_smem) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kWgStages * S::kStageBytes);
  uint64_t* empty = full + kWgStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int slice = (int)cluster.block_rank();
  const int tile = blockIdx.x / splits;  // a tile's slices: one cluster
  const int m_blocks = hidden / BM;
  const int m0 = (tile % m_blocks) * BM;
  const int n0 = (tile / m_blocks) * BN;
  const int c0 = (int)((long long)slice * n_chunks / splits);
  const int n_local = (int)((long long)(slice + 1) * n_chunks / splits) - c0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer warpgroup: one thread issues every load.
    if constexpr (S::kConsumers == 2) reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const bool from_dhn = n0 >= 2 * hidden;
      const CUtensorMap* map_b = from_dhn ? &map_dhn : &map_dxp;
      const int nb0 = from_dhn ? n0 - 2 * hidden : n0;
      for (int c = 0; c < n_local; ++c) {
        const int st = c % kWgStages;
        mbar_wait(&empty[st], ((c / kWgStages) & 1) ^ 1);
        unsigned char* stage = ring + st * S::kStageBytes;
        mbar_expect(&full[st], S::kStageBytes);
        const int k = (c0 + c) * kWgBk;
#pragma unroll
        for (int i = 0; i < BM / kWgBox; ++i) {
          tma_load_2d(stage + i * kWgBoxBytes, &map_h, &full[st],
                      m0 + i * kWgBox, k);
        }
#pragma unroll
        for (int i = 0; i < BN / kWgBox; ++i) {
          tma_load_2d(stage + S::kABytes + i * kWgBoxBytes, map_b, &full[st],
                      nb0 + i * kWgBox, k);
        }
      }
    }
    cluster.sync();  // the partial tiles are staged
    cluster.sync();  // and have been read
  } else {
    // Consumer warpgroup cw: rows m0 + 64 cw ... + 63 of the tile.
    if constexpr (S::kConsumers == 2) reg_alloc<232>();
    const int cw = wg - 1;
    float acc[S::kAcc];
#pragma unroll
    for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.f;
    const uint32_t ring_addr = smem_addr(ring);
    for (int c = 0; c < n_local; ++c) {
      const int st = c % kWgStages;
      mbar_wait(&full[st], (c / kWgStages) & 1);
      const uint32_t a = ring_addr + st * S::kStageBytes + cw * kWgBoxBytes;
      const uint32_t b = ring_addr + st * S::kStageBytes + S::kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kWgBk / 16; ++j) {
        // 16 rows of K: two groups of 8 rows, 1024 bytes apart.
        Wgmma<BN>::mma(acc, wgmma_desc(a + j * 2048, kWgBoxBytes, 1024),
                       wgmma_desc(b + j * 2048, kWgBoxBytes, 1024));
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous chunk's products have completed
      if (c > 0 && (threadIdx.x & 127) == 0) {
        mbar_arrive(&empty[(c - 1) % kWgStages]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Stage the partial tile over the ring, once both warpgroups' last
    // products (the last reads of the ring) have completed.
    // acc[4 i + 2 half + e] is the tile's (row + 8 half, col + 8 i + e).
    consumers_sync<S::kConsumers * 128>();
    float* staged = reinterpret_cast<float*>(ring);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row = cw * 64 + warp * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float2*>(staged + (row + 8 * half) * S::kTileLd +
                                   col + 8 * i) =
            make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
      }
    }
    cluster.sync();

    // This CTA's share of the tile's rows, summed over the cluster's
    // partials in rank order.
    const float* parts[kWgMaxSplits];
#pragma unroll
    for (int r = 0; r < kWgMaxSplits; ++r) {
      parts[r] = cluster.map_shared_rank(staged, r < splits ? r : 0);
    }
    const int r0 = slice * BM / splits, r1 = (slice + 1) * BM / splits;
    const size_t three_h = 3 * (size_t)hidden;
    for (int v = threadIdx.x - 128; v < (r1 - r0) * (BN / 4);
         v += S::kConsumers * 128) {
      const int tr = r0 + v / (BN / 4), tc = 4 * (v % (BN / 4));
      const int at = tr * S::kTileLd + tc;
      float4 sum = *reinterpret_cast<const float4*>(parts[0] + at);
#pragma unroll
      for (int r = 1; r < kWgMaxSplits; ++r) {
        if (r < splits) {
          const float4 x = *reinterpret_cast<const float4*>(parts[r] + at);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
      }
      *reinterpret_cast<float4*>(dwh + (m0 + tr) * three_h + n0 + tc) = sum;
    }
    const int t = threadIdx.x - 128;
    if (slice == 0 && n0 == 0 && t < BM) {
      float sb = 0.f;
      for (int r = 0; r < dbn_rows; ++r) {
        sb += dbn_part[(size_t)r * hidden + m0 + t];
      }
      dbn[m0 + t] = sb;
    }
    cluster.sync();  // no CTA leaves while its partial tile may be read
  }
}

// cuTensorMapEncodeTiled, reached through the runtime, so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(EncodeTiledFn* fn) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = encode;
  return cudaSuccess;
}

// The map of a [rows, cols] bf16 matrix whose rows are ld elements apart,
// in boxes of kWgBk rows x kWgBox columns with the 128-byte swizzle; boxes
// past the last row are filled with zeros.
cudaError_t wgrad_map(EncodeTiledFn encode, CUtensorMap* map, const void* base,
                      int cols, int rows, int ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {kWgBox, kWgBk};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch of gru_wgrad_kernel<BM, BN> over `tiles` clusters of `splits`
// CTAs (grid and stream unused by the occupancy query).
template <int BM, int BN>
cudaLaunchConfig_t wgrad_config(int tiles, int splits, void* stream,
                                cudaLaunchAttribute* attr) {
  using S = WgradShape<BM, BN>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits, 1, 1);
  cfg.blockDim = dim3(S::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BM, int BN>
int wgrad_clusters(int splits, int* max_clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      gru_wgrad_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WgradShape<BM, BN>::kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgrad_config<BM, BN>(1, splits, nullptr,
                                                      &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      max_clusters, (const void*)gru_wgrad_kernel<BM, BN>, &cfg);
}

template <int BM, int BN>
int launch_wgrad(const CUtensorMap& map_h, const CUtensorMap& map_dxp,
                 const CUtensorMap& map_dhn, const void* dbn_part, void* dwh,
                 void* dbn, int hidden, int dbn_rows, int n_chunks,
                 int splits, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gru_wgrad_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WgradShape<BM, BN>::kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wgrad_config<BM, BN>(
      (hidden / BM) * (3 * hidden / BN), splits, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, gru_wgrad_kernel<BM, BN>, map_h, map_dxp,
                         map_dhn, (const float*)dbn_part, (float*)dwh,
                         (float*)dbn, hidden, dbn_rows, n_chunks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Kernel>
cudaError_t cluster_attributes(Kernel kernel, int cluster, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return e;
}

cudaLaunchConfig_t cluster_config(int cluster, int tiles, size_t smem,
                                  void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
int query_cluster(Kernel kernel, int cluster, size_t smem, int* max_clusters) {
  cudaError_t e = cluster_attributes(kernel, cluster, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(max_clusters, (const void*)kernel,
                                             &cfg);
}

template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int cluster, int tiles,
                   size_t smem, void* stream, Args... args) {
  cudaError_t e = cluster_attributes(kernel, cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, tiles, smem, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int H>
int query_h(int bwd, int* cluster, int* units, int* max_clusters, int* smem) {
  using S = Shape<H>;
  *cluster = S::kCluster;
  *units = kUnits;
  *smem = (int)(bwd ? S::kBwdSmem : S::kFwdSmem);
  return bwd ? query_cluster(gru_bwd_cluster<H>, S::kCluster, S::kBwdSmem,
                             max_clusters)
             : query_cluster(gru_fwd_cluster<H>, S::kCluster, S::kFwdSmem,
                             max_clusters);
}

template <int H>
int fwd_h(const void* xp, const void* wh, const void* bn, const void* h0,
          void* ys, int seq_len, int batch, void* stream) {
  using S = Shape<H>;
  return launch_cluster(gru_fwd_cluster<H>, S::kCluster,
                        (batch + kRows - 1) / kRows, S::kFwdSmem, stream,
                        (const bf16*)xp, (const bf16*)wh, (const float*)bn,
                        (const float*)h0, (float*)ys, seq_len, batch);
}

template <int H>
int bwd_h(const void* g, const void* xp, const void* hprev, const void* wh,
          const void* bn, void* dxp, void* dhn, void* dbn_part, void* dh0,
          int seq_len, int batch, void* stream) {
  using S = Shape<H>;
  return launch_cluster(gru_bwd_cluster<H>, S::kCluster,
                        (batch + kRows - 1) / kRows, S::kBwdSmem, stream,
                        (const float*)g, (const bf16*)xp, (const bf16*)hprev,
                        (const bf16*)wh, (const float*)bn, (bf16*)dxp,
                        (bf16*)dhn, (float*)dbn_part, (float*)dh0, seq_len,
                        batch);
}

}  // namespace

// ---- cooperative entry points (float32; bf16 past 512 units) -----------

// Blocks of the cooperative forward (bwd = 0) or backward (bwd = 1) kernel,
// with float32 (use_bf16 = 0) or bf16 streams, that fit on one SM for this
// shape, and the SM count.
extern "C" int ddsp_gru_occupancy(int hidden, int batch, int u, int bwd,
                                  int use_bf16, int* blocks_per_sm,
                                  int* n_sms) {
  return use_bf16
             ? coop_occupancy<bf16>(hidden, batch, u, bwd, blocks_per_sm,
                                    n_sms)
             : coop_occupancy<float>(hidden, batch, u, bwd, blocks_per_sm,
                                     n_sms);
}

// xp [T, ld, 3H], wh [H, 3H] at the stream type; bn [H], h0 [batch, H],
// ys [T, ld, H] float32, each pointer at the launch's first row; barrier:
// one zeroed uint32 on the device. hidden % u == 0. Returns cudaError_t.
extern "C" int ddsp_gru_fwd(const void* xp, const void* wh, const void* bn,
                            const void* h0, void* ys, void* barrier,
                            int seq_len, int batch, int ld, int hidden, int u,
                            int use_bf16, void* stream) {
  return use_bf16 ? coop_fwd<bf16>(xp, wh, bn, h0, ys, barrier, seq_len,
                                   batch, ld, hidden, u, stream)
                  : coop_fwd<float>(xp, wh, bn, h0, ys, barrier, seq_len,
                                    batch, ld, hidden, u, stream);
}

// g [T, ld, H] float32; xp, hprev, dxp [T, ld, *] at the stream type;
// exchange: scratch of 2 * (hidden / u) * batch * H floats; dwh [H, 3H],
// dbn [H] float32, added to; dh0 [batch, H] float32; barrier: one zeroed
// uint32.
extern "C" int ddsp_gru_bwd(const void* g, const void* xp, const void* hprev,
                            const void* wh, const void* bn, void* dxp,
                            void* exchange, void* dwh, void* dbn, void* dh0,
                            void* barrier, int seq_len, int batch, int ld,
                            int hidden, int u, int use_bf16, void* stream) {
  return use_bf16
             ? coop_bwd<bf16>(g, xp, hprev, wh, bn, dxp, exchange, dwh, dbn,
                              dh0, barrier, seq_len, batch, ld, hidden, u,
                              stream)
             : coop_bwd<float>(g, xp, hprev, wh, bn, dxp, exchange, dwh, dbn,
                               dh0, barrier, seq_len, batch, ld, hidden, u,
                               stream);
}

// ---- bf16 entry points ---------------------------------------------------

// The cluster size and units per CTA of the bf16 forward (bwd = 0) or
// backward (bwd = 1) kernel at this H, its shared memory per CTA, and how
// many such clusters the device can hold at once (0: none fits).
extern "C" int ddsp_gru_cluster_query(int hidden, int bwd, int* cluster,
                                      int* units, int* max_clusters,
                                      int* smem) {
#define DDSP_GRU_QUERY(H) query_h<H>(bwd, cluster, units, max_clusters, smem)
  switch (hidden) {
    case 64: return DDSP_GRU_QUERY(64);
    case 128: return DDSP_GRU_QUERY(128);
    case 256: return DDSP_GRU_QUERY(256);
    case 512: return DDSP_GRU_QUERY(512);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DDSP_GRU_QUERY
}

// xp [T, B, 3H], wh [H, 3H] bf16; bn [H], h0 [B, H], ys [T, B, H] float32.
extern "C" int ddsp_gru_cluster_fwd(const void* xp, const void* wh,
                                    const void* bn, const void* h0, void* ys,
                                    int seq_len, int batch, int hidden,
                                    void* stream) {
#define DDSP_GRU_FWD(H) fwd_h<H>(xp, wh, bn, h0, ys, seq_len, batch, stream)
  switch (hidden) {
    case 64: return DDSP_GRU_FWD(64);
    case 128: return DDSP_GRU_FWD(128);
    case 256: return DDSP_GRU_FWD(256);
    case 512: return DDSP_GRU_FWD(512);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DDSP_GRU_FWD
}

// g [T, B, H] float32; xp, hprev, wh, dxp [T, B, 3H], dhn [T, B, H] bf16;
// bn [H], dbn_part [ceil(B / 16), H], dh0 [B, H] float32.
extern "C" int ddsp_gru_cluster_bwd(const void* g, const void* xp,
                                    const void* hprev, const void* wh,
                                    const void* bn, void* dxp, void* dhn,
                                    void* dbn_part, void* dh0, int seq_len,
                                    int batch, int hidden, void* stream) {
#define DDSP_GRU_BWD(H) \
  bwd_h<H>(g, xp, hprev, wh, bn, dxp, dhn, dbn_part, dh0, seq_len, batch, stream)
  switch (hidden) {
    case 64: return DDSP_GRU_BWD(64);
    case 128: return DDSP_GRU_BWD(128);
    case 256: return DDSP_GRU_BWD(256);
    case 512: return DDSP_GRU_BWD(512);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DDSP_GRU_BWD
}

// How many clusters of `splits` CTAs of K2b (b)'s kernel with bm x bn tiles
// the device holds at once.
extern "C" int ddsp_gru_wgrad_clusters(int bm, int bn, int splits,
                                       int* max_clusters) {
  if (splits < 1 || splits > kWgMaxSplits) return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 256) return wgrad_clusters<128, 256>(splits, max_clusters);
  if (bm == 128 && bn == 128) return wgrad_clusters<128, 128>(splits, max_clusters);
  if (bm == 64 && bn == 64) return wgrad_clusters<64, 64>(splits, max_clusters);
  return (int)cudaErrorInvalidValue;
}

// K2b (b). hprev [rows, H], dxp [rows, 3H], dhn [rows, H] bf16 with
// rows = T * B, 16-byte aligned; dbn_part [dbn_rows, H], dwh [H, 3H], dbn
// [H] float32. (bm, bn, chunk, splits) is kernels/gru.py wgrad_plan's:
// tiles of bm x bn with bm, bn dividing H, K cut into splits slices of
// whole chunks, a cluster of splits CTAs per tile.
extern "C" int ddsp_gru_wgrad(const void* hprev, const void* dxp,
                              const void* dhn, const void* dbn_part, void* dwh,
                              void* dbn, int rows, int hidden, int dbn_rows,
                              int bm, int bn, int chunk, int splits,
                              void* stream) {
  if (rows < 1 || hidden < 1 || chunk != kWgBk) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = (rows + kWgBk - 1) / kWgBk;
  if (splits < 1 || splits > kWgMaxSplits || splits > n_chunks ||
      hidden % bm != 0 || hidden % bn != 0) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTiledFn encode;
  cudaError_t e = tensor_map_encoder(&encode);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map_h, map_dxp, map_dhn;
  if ((e = wgrad_map(encode, &map_h, hprev, hidden, rows, hidden)) !=
          cudaSuccess ||
      (e = wgrad_map(encode, &map_dxp, dxp, 2 * hidden, rows, 3 * hidden)) !=
          cudaSuccess ||
      (e = wgrad_map(encode, &map_dhn, dhn, hidden, rows, hidden)) !=
          cudaSuccess) {
    return (int)e;
  }
#define DDSP_GRU_WGRAD(BM, BN)                                              \
  launch_wgrad<BM, BN>(map_h, map_dxp, map_dhn, dbn_part, dwh, dbn, hidden, \
                       dbn_rows, n_chunks, splits, stream)
  if (bm == 128 && bn == 256) return DDSP_GRU_WGRAD(128, 256);
  if (bm == 128 && bn == 128) return DDSP_GRU_WGRAD(128, 128);
  if (bm == 64 && bn == 64) return DDSP_GRU_WGRAD(64, 64);
#undef DDSP_GRU_WGRAD
  return (int)cudaErrorInvalidValue;
}

// K2f at one step, float32: xp [1, B, 3H], wh [H, 3H], bn [H], h0 [B, H],
// ys [1, B, H], all float32. Any B and H.
extern "C" int ddsp_gru_step(const void* xp, const void* wh, const void* bn,
                             const void* h0, void* ys, int batch, int hidden,
                             void* stream) {
  if (batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem_bytes(hidden);
  const cudaError_t e = allow_smem(gru_step_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  gru_step_kernel<<<(hidden + kStepUnits - 1) / kStepUnits, kStepThreads,
                    smem, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)wh, (const float*)bn, (const float*)h0,
      (float*)ys, batch, hidden);
  return (int)cudaGetLastError();
}
