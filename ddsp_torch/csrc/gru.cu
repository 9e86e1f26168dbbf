// Fused GRU sequence, forward (kernel K2 of ddsp_torch): the whole
// recurrence in one launch.
//
// Replaces ddsp_tpu/ops/pallas_kernels/gru.py:_fwd_kernel (reached through
// _pallas_gru_fwd / fused_gru). Reset-after gates, xp = x @ wi + bi hoisted
// outside the kernel:
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
// Bound. Latency: T x (one grid barrier + one length-H dot per column),
// not FLOPs or bytes. At B = 1, T = 1000, H = 512 in bf16 the work is
// 1.6 GFLOP and 6.6 MB, about 2 microseconds at the card's peak rates,
// while each of the 1000 serial steps costs a barrier of microseconds.

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

size_t smem_bytes(int hidden, int batch, int u) {
  return sizeof(float) * ((size_t)3 * u * hidden + (size_t)batch * hidden +
                          (size_t)batch * 3 * u + (size_t)batch * u);
}

template <typename T>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(gru_fwd_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int occupancy(int hidden, int batch, int u, int* blocks_per_sm,
              int* n_sms) {
  const size_t smem = smem_bytes(hidden, batch, u);
  cudaError_t e = set_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gru_fwd_kernel<T>, kThreads, smem);
}

template <typename T>
int launch(const void* xp, const void* wh, const void* bn, const void* h0,
           void* ys, void* barrier, int seq_len, int batch, int hidden, int u,
           void* stream) {
  const size_t smem = smem_bytes(hidden, batch, u);
  cudaError_t e = set_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  const T* xp_p = (const T*)xp;
  const T* wh_p = (const T*)wh;
  const float* bn_p = (const float*)bn;
  const float* h0_p = (const float*)h0;
  float* ys_p = (float*)ys;
  unsigned int* bar_p = (unsigned int*)barrier;
  void* args[] = {&xp_p, &wh_p, &bn_p, &h0_p, &ys_p, &bar_p,
                  &seq_len, &batch, &hidden, &u};
  e = cudaLaunchCooperativeKernel((const void*)gru_fwd_kernel<T>,
                                  dim3(hidden / u), dim3(kThreads), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the kernel that fit on one SM for this shape, and the SM count.
extern "C" int ddsp_gru_occupancy(int hidden, int batch, int u, int bf16,
                                  int* blocks_per_sm, int* n_sms) {
  return bf16 ? occupancy<__nv_bfloat16>(hidden, batch, u, blocks_per_sm,
                                         n_sms)
              : occupancy<float>(hidden, batch, u, blocks_per_sm, n_sms);
}

// barrier: one zeroed uint32 on the device. hidden % u == 0. Returns
// cudaError_t.
extern "C" int ddsp_gru_fwd(const void* xp, const void* wh, const void* bn,
                            const void* h0, void* ys, void* barrier,
                            int seq_len, int batch, int hidden, int u,
                            int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(xp, wh, bn, h0, ys, barrier, seq_len,
                                      batch, hidden, u, stream)
              : launch<float>(xp, wh, bn, h0, ys, barrier, seq_len, batch,
                              hidden, u, stream);
}
