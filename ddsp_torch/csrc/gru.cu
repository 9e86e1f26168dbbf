// Fused GRU sequence, forward (K2f) and backward (K2b) of ddsp_torch: the
// whole recurrence in one launch each way.
//
// Replaces ddsp_tpu/ops/pallas_kernels/gru.py:_fwd_kernel and _bwd_kernel
// (reached through _pallas_gru_fwd, _pallas_gru_bwd / fused_gru).
// Reset-after gates, xp = x @ wi + bi hoisted outside the kernels:
//
//   hp = h_{t-1} @ wh                           ([B, H] x [H, 3H])
//   r  = sigmoid(xp_r + hp_r),  z = sigmoid(xp_z + hp_z)
//   n  = tanh(xp_n + r * (hp_n + bn))
//   h_t = (1 - z) * n + z * h_{t-1}
//
// Layout: xp [T, B, 3H] (float32 or bfloat16), wh [H, 3H] (same type as
// xp), bn [H], h0 [B, H] and ys [T, B, H] float32. In bfloat16 mode the
// recurrent dot takes h rounded to bf16 and bf16 wh with float32
// accumulation; gates and the carry stay float32 (gru.py:141-148).
//
// Design. wh at H = 512 is 1.5 MiB in bf16, too large for one SM's shared
// memory, so the hidden units are partitioned: block j owns units
// [j*u, (j+1)*u) and keeps the 3u gate columns of wh for them (all H rows)
// in shared memory for the whole sequence (12 KiB of bf16 data at u = 4,
// held as float). The gate math is local to a block; the only exchange
// between blocks is h_t, which goes through ys[t] itself. Between steps
// there is one grid-wide barrier (a monotonic arrival counter; the launch
// is cooperative, so every block is co-resident or the launch fails).
// Each step a block reads h_{t-1} (B*H floats, from L2) into shared memory,
// computes its B x 3u dot products of length H (one warp per output, lanes
// split the k axis, shuffle reduction), then its B x u gate updates.
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
// The same partition serves it: block j recomputes the gates of its units
// and keeps its 3u columns of dwh and its u entries of dbn and of the dh
// carry in shared memory for the whole sequence. Only dh = dhp @ wh^T
// contracts over all 3H columns, so each step every block writes its 3u
// columns of dhp to a [2, B, 3H] exchange buffer in global memory (double
// buffered, so one grid barrier per step is enough), and after the barrier
// reads all of dhp back through L2 for the rows of wh of its own units
// ([u, 3H], also resident). h_prev and dhp are staged through shared
// memory in tiles of kBatchTile batch rows, so the footprint does not grow
// with the batch: at H = 512, u = 4 it is 72 KiB of weights and
// accumulators plus 64 KiB of tiles.
//
// Bound. Latency: T x (one grid barrier + one length-H dot per column),
// not FLOPs or bytes. At B = 1, T = 1000, H = 512 in bf16 the work is
// 1.6 GFLOP and 6.6 MB, about 2 microseconds at the card's peak rates,
// while each of the 1000 serial steps costs a barrier of microseconds.
// The backward does three such products per step and moves B x 3H of dhp
// to every block through L2, so its step is a few times the forward's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float gate_sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
               const float* __restrict__ bn, const float* __restrict__ h0,
               float* ys, unsigned int* barrier, int seq_len, int batch,
               int hidden, int u) {
  extern __shared__ float smem[];
  const int cols = 3 * u;
  float* w_s = smem;                   // [cols][hidden]
  float* h_s = w_s + cols * hidden;    // [batch][hidden], h_{t-1}
  float* hp_s = h_s + batch * hidden;  // [batch][cols]
  float* carry = hp_s + batch * cols;  // [batch][u], float32 carry
  const int j = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < cols * hidden; i += kThreads) {
    const int c = i / hidden;
    const int k = i - c * hidden;
    const int gate = c / u;
    const int col = gate * hidden + j * u + (c - gate * u);
    w_s[i] = to_float(wh[(size_t)k * 3 * hidden + col]);
  }
  for (int i = tid; i < batch * u; i += kThreads) {
    const int b = i / u;
    carry[i] = h0[(size_t)b * hidden + j * u + (i - b * u)];
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  for (int t = 0; t < seq_len; ++t) {
    // h_{t-1} was written by other blocks during this launch: read it
    // through L2 (ld.global.cg), never from a possibly stale L1 line.
    const float* h_prev = t == 0 ? h0 : ys + (size_t)(t - 1) * batch * hidden;
    for (int i = tid; i < batch * hidden; i += kThreads) {
      const float v = __ldcg(h_prev + i);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        h_s[i] = __bfloat162float(__float2bfloat16(v));
      } else {
        h_s[i] = v;
      }
    }
    __syncthreads();

    for (int o = warp; o < batch * cols; o += kWarps) {
      const int b = o / cols;
      const float* hv = h_s + b * hidden;
      const float* wv = w_s + (o - b * cols) * hidden;
      float acc = 0.f;
      for (int k = lane; k < hidden; k += 32) acc = fmaf(hv[k], wv[k], acc);
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) hp_s[o] = acc;
    }
    __syncthreads();

    const T* xp_t = xp + (size_t)t * batch * 3 * hidden;
    float* ys_t = ys + (size_t)t * batch * hidden;
    for (int i = tid; i < batch * u; i += kThreads) {
      const int b = i / u;
      const int uu = i - b * u;
      const int unit = j * u + uu;
      const T* x = xp_t + (size_t)b * 3 * hidden;
      const float* hp = hp_s + b * cols;
      const float r = gate_sigmoid(to_float(x[unit]) + hp[uu]);
      const float z = gate_sigmoid(to_float(x[hidden + unit]) + hp[u + uu]);
      const float n =
          tanhf(to_float(x[2 * hidden + unit]) + r * (hp[2 * u + uu] + bn[unit]));
      const float h = (1.f - z) * n + z * carry[i];
      carry[i] = h;
      ys_t[(size_t)b * hidden + unit] = h;
    }
    grid_barrier(barrier, gridDim.x * (unsigned int)(t + 1));
  }
}

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// Loads that bypass L1: the data was written by other blocks in this launch.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

constexpr int kBatchTile = 8;

// g [T, B, H] float32; xp, hprev, dxp at the stream type T; exchange
// [2, B, 3H] of T (scratch); dwh [H, 3H], dbn [H], dh0 [B, H] float32, every
// element written. Launched cooperatively with hidden / u blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ g, const T* __restrict__ xp,
               const T* __restrict__ hprev, const T* __restrict__ wh,
               const float* __restrict__ bn, T* __restrict__ dxp, T* exchange,
               float* __restrict__ dwh, float* __restrict__ dbn,
               float* __restrict__ dh0, unsigned int* barrier, int seq_len,
               int batch, int hidden, int u) {
  extern __shared__ float smem[];
  const int cols = 3 * u;
  const int three_h = 3 * hidden;
  float* w_col = smem;                          // [cols][hidden]
  float* w_row = w_col + cols * hidden;         // [u][3H]
  float* dwh_s = w_row + u * three_h;           // [cols][hidden]
  float* h_s = dwh_s + cols * hidden;           // [kBatchTile][hidden]
  float* dhp_all = h_s + kBatchTile * hidden;   // [kBatchTile][3H]
  float* hp_s = dhp_all + kBatchTile * three_h;  // [kBatchTile][cols]
  float* dhp_own = hp_s + kBatchTile * cols;    // [kBatchTile][cols]
  float* dhn_s = dhp_own + kBatchTile * cols;   // [kBatchTile][u]
  float* dh_s = dhn_s + kBatchTile * u;         // [batch][u], the carry
  float* dhz_s = dh_s + batch * u;              // [batch][u], dht * z
  float* dbn_s = dhz_s + batch * u;             // [u]
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kWarps = kThreads / 32;

  for (int i = tid; i < cols * hidden; i += kThreads) {
    const int c = i / hidden;
    const int k = i - c * hidden;
    const int gate = c / u;
    const int col = gate * hidden + j * u + (c - gate * u);
    w_col[i] = to_float(wh[(size_t)k * three_h + col]);
    dwh_s[i] = 0.f;
  }
  for (int i = tid; i < u * three_h; i += kThreads) {
    const int uu = i / three_h;
    w_row[i] = to_float(wh[(size_t)(j * u + uu) * three_h + (i - uu * three_h)]);
  }
  for (int i = tid; i < batch * u; i += kThreads) dh_s[i] = 0.f;
  for (int i = tid; i < u; i += kThreads) dbn_s[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < seq_len; ++step) {
    const int t = seq_len - 1 - step;
    const T* xp_t = xp + (size_t)t * batch * three_h;
    const T* hprev_t = hprev + (size_t)t * batch * hidden;
    const float* g_t = g + (size_t)t * batch * hidden;
    T* dxp_t = dxp + (size_t)t * batch * three_h;
    T* ex = exchange + (size_t)(step & 1) * batch * three_h;

    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int nb = min(kBatchTile, batch - b0);
      // h_{t-1} of this tile (an input of the launch: plain loads).
      for (int i = tid; i < nb * hidden; i += kThreads) {
        h_s[i] = to_float(hprev_t[(size_t)b0 * hidden + i]);
      }
      __syncthreads();
      for (int o = warp; o < nb * cols; o += kWarps) {
        const int b = o / cols;
        const float* hv = h_s + b * hidden;
        const float* wv = w_col + (o - b * cols) * hidden;
        float acc = 0.f;
        for (int k = lane; k < hidden; k += 32) acc = fmaf(hv[k], wv[k], acc);
        for (int off = 16; off > 0; off >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) hp_s[o] = acc;
      }
      __syncthreads();
      for (int i = tid; i < nb * u; i += kThreads) {
        const int b = i / u;
        const int uu = i - b * u;
        const int unit = j * u + uu;
        const size_t row = (size_t)(b0 + b);
        const T* x = xp_t + row * three_h;
        const float* hp = hp_s + b * cols;
        const float hpn = hp[2 * u + uu] + bn[unit];
        const float r = gate_sigmoid(to_float(x[unit]) + hp[uu]);
        const float z = gate_sigmoid(to_float(x[hidden + unit]) + hp[u + uu]);
        const float n = tanhf(to_float(x[2 * hidden + unit]) + r * hpn);
        const float h_prev = h_s[b * hidden + unit];
        const float dht = dh_s[row * u + uu] + g_t[row * hidden + unit];
        const float dn_pre = dht * (1.f - z) * (1.f - n * n);
        const float dz = dht * (h_prev - n) * z * (1.f - z);
        const float dr_pre = dn_pre * hpn * r * (1.f - r);
        const float dhn = dn_pre * r;
        T* dx = dxp_t + row * three_h;
        store(dx + unit, dr_pre);
        store(dx + hidden + unit, dz);
        store(dx + 2 * hidden + unit, dn_pre);
        T* e = ex + row * three_h;
        store(e + unit, dr_pre);
        store(e + hidden + unit, dz);
        store(e + 2 * hidden + unit, dhn);
        float* own = dhp_own + b * cols;
        own[uu] = round_to(dr_pre, T());
        own[u + uu] = round_to(dz, T());
        own[2 * u + uu] = round_to(dhn, T());
        dhn_s[i] = dhn;
        dhz_s[row * u + uu] = dht * z;
      }
      __syncthreads();
      // dwh[:, own columns] += h_{t-1}^T dhp; dbn += sum_b dhn.
      for (int i = tid; i < cols * hidden; i += kThreads) {
        const int c = i / hidden;
        const int k = i - c * hidden;
        float acc = dwh_s[i];
        for (int b = 0; b < nb; ++b) {
          acc = fmaf(h_s[b * hidden + k], dhp_own[b * cols + c], acc);
        }
        dwh_s[i] = acc;
      }
      if (tid < u) {
        float acc = dbn_s[tid];
        for (int b = 0; b < nb; ++b) acc += dhn_s[b * u + tid];
        dbn_s[tid] = acc;
      }
      __syncthreads();
    }

    grid_barrier(barrier, gridDim.x * (unsigned int)(step + 1));

    // dh_{t-1}[b, own units] = dht z + dhp[b, :] . wh[unit, :].
    for (int b0 = 0; b0 < batch; b0 += kBatchTile) {
      const int nb = min(kBatchTile, batch - b0);
      for (int i = tid; i < nb * three_h; i += kThreads) {
        dhp_all[i] = load_cg(ex + (size_t)b0 * three_h + i);
      }
      __syncthreads();
      for (int o = warp; o < nb * u; o += kWarps) {
        const int b = o / u;
        const int uu = o - b * u;
        const float* dv = dhp_all + b * three_h;
        const float* wv = w_row + uu * three_h;
        float acc = 0.f;
        for (int c = lane; c < three_h; c += 32) acc = fmaf(dv[c], wv[c], acc);
        for (int off = 16; off > 0; off >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) {
          const size_t idx = (size_t)(b0 + b) * u + uu;
          dh_s[idx] = dhz_s[idx] + acc;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < cols * hidden; i += kThreads) {
    const int c = i / hidden;
    const int k = i - c * hidden;
    const int gate = c / u;
    const int col = gate * hidden + j * u + (c - gate * u);
    dwh[(size_t)k * three_h + col] = dwh_s[i];
  }
  for (int i = tid; i < u; i += kThreads) dbn[j * u + i] = dbn_s[i];
  for (int i = tid; i < batch * u; i += kThreads) {
    const int b = i / u;
    dh0[(size_t)b * hidden + j * u + (i - b * u)] = dh_s[i];
  }
}

size_t fwd_smem_bytes(int hidden, int batch, int u) {
  return sizeof(float) * ((size_t)3 * u * hidden + (size_t)batch * hidden +
                          (size_t)batch * 3 * u + (size_t)batch * u);
}

size_t bwd_smem_bytes(int hidden, int batch, int u) {
  const size_t cols = 3 * (size_t)u;
  return sizeof(float) * (2 * cols * hidden + (size_t)u * 3 * hidden +
                          (size_t)kBatchTile * (4 * (size_t)hidden + 2 * cols +
                                                u) +
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
int launch_fwd(const void* xp, const void* wh, const void* bn, const void* h0,
               void* ys, void* barrier, int seq_len, int batch, int hidden,
               int u, void* stream) {
  void* args[] = {&xp, &wh, &bn, &h0, &ys, &barrier,
                  &seq_len, &batch, &hidden, &u};
  return launch_cooperative(gru_fwd_kernel<T>,
                            fwd_smem_bytes(hidden, batch, u), hidden / u,
                            args, stream);
}

template <typename T>
int launch_bwd(const void* g, const void* xp, const void* hprev,
               const void* wh, const void* bn, void* dxp, void* exchange,
               void* dwh, void* dbn, void* dh0, void* barrier, int seq_len,
               int batch, int hidden, int u, void* stream) {
  void* args[] = {&g, &xp, &hprev, &wh, &bn, &dxp, &exchange, &dwh, &dbn,
                  &dh0, &barrier, &seq_len, &batch, &hidden, &u};
  return launch_cooperative(gru_bwd_kernel<T>,
                            bwd_smem_bytes(hidden, batch, u), hidden / u,
                            args, stream);
}

}  // namespace

// Blocks of the forward (bwd = 0) or backward (bwd = 1) kernel that fit on
// one SM for this shape, and the SM count.
extern "C" int ddsp_gru_occupancy(int hidden, int batch, int u, int bf16,
                                  int bwd, int* blocks_per_sm, int* n_sms) {
  if (bwd) {
    const size_t smem = bwd_smem_bytes(hidden, batch, u);
    return bf16 ? occupancy(gru_bwd_kernel<__nv_bfloat16>, smem,
                            blocks_per_sm, n_sms)
                : occupancy(gru_bwd_kernel<float>, smem, blocks_per_sm, n_sms);
  }
  const size_t smem = fwd_smem_bytes(hidden, batch, u);
  return bf16 ? occupancy(gru_fwd_kernel<__nv_bfloat16>, smem, blocks_per_sm,
                          n_sms)
              : occupancy(gru_fwd_kernel<float>, smem, blocks_per_sm, n_sms);
}

// barrier: one zeroed uint32 on the device. hidden % u == 0. Returns
// cudaError_t.
extern "C" int ddsp_gru_fwd(const void* xp, const void* wh, const void* bn,
                            const void* h0, void* ys, void* barrier,
                            int seq_len, int batch, int hidden, int u,
                            int bf16, void* stream) {
  return bf16 ? launch_fwd<__nv_bfloat16>(xp, wh, bn, h0, ys, barrier,
                                          seq_len, batch, hidden, u, stream)
              : launch_fwd<float>(xp, wh, bn, h0, ys, barrier, seq_len, batch,
                                  hidden, u, stream);
}

// g [T, B, H] float32; xp [T, B, 3H], hprev [T, B, H], wh [H, 3H] and the
// outputs dxp [T, B, 3H] at the stream type; exchange: scratch of
// 2 * B * 3H stream-type elements; dwh [H, 3H], dbn [H], dh0 [B, H]
// float32; barrier: one zeroed uint32. Returns cudaError_t.
extern "C" int ddsp_gru_bwd(const void* g, const void* xp, const void* hprev,
                            const void* wh, const void* bn, void* dxp,
                            void* exchange, void* dwh, void* dbn, void* dh0,
                            void* barrier, int seq_len, int batch, int hidden,
                            int u, int bf16, void* stream) {
  return bf16 ? launch_bwd<__nv_bfloat16>(g, xp, hprev, wh, bn, dxp, exchange,
                                          dwh, dbn, dh0, barrier, seq_len,
                                          batch, hidden, u, stream)
              : launch_bwd<float>(g, xp, hprev, wh, bn, dxp, exchange, dwh,
                                  dbn, dh0, barrier, seq_len, batch, hidden, u,
                                  stream);
}
