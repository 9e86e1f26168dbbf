// Neighbour halo shift along the 'time' axis of a (data x time) mesh (K3)
// of ddsp_torch.
//
// Replaces ddsp_tpu/parallel/pallas_halo.py:_shift_kernel (reached through
// _shift / shift_right / shift_left / neighbor_shift(impl='pallas')). There,
// each TPU chip sends its block to its ring neighbour by remote DMA and the
// shard whose source wrapped around the ring zeroes what it received. Here
// every shard of the mesh lies on one card, so one launch moves every
// shard's block: destination shard (d, t) receives the block of shard
// (d, t - direction), and zeros where t - direction falls outside
// [0, n_time). A data row never mixes with another.
//
//   grid.y  destination shard d * n_time + t;
//   grid.x  the block's elements, as (row, chunk of a row) pairs.
//
// The source and destination pointers and each source's row stride travel
// in a struct passed by value as a kernel parameter (no pointer table in
// device memory, no copy or synchronisation per call). A source block is
// read as [rows, cols] with contiguous rows and any row stride, so a strided
// view (the STFT halo audio[:, :size - 1] of a [batch, t_local] shard) is
// read in place; the destination is contiguous.
//
// The shift is a copy of bits: the kernel is templated on the element's
// width (32-bit words for float32, 16-bit for bfloat16), and zero bits are
// +0.0 in both. Where every row starts on a 16-byte boundary and holds a
// whole number of 16-byte units, the copy moves 16-byte vectors; otherwise
// it moves elements.
//
// Bound. Bytes: every block that has a source is read once and every block
// is written once, (n_time - 1) / n_time reads plus one write per shard and
// element. At the reverb carry of a (1 x 4) mesh ([16, 64000] float32 per
// shard, 4.1 MB) that is 28.7 MB, 8.6 us at 3.35 TB/s. No arithmetic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;

struct ShiftTable {
  const void* src[kMaxShards];
  void* dst[kMaxShards];
  long long src_row_stride[kMaxShards];  // in units of Unit
};

// Unit: the word one thread moves at a time (uint4 for the 16-byte path,
// else the element itself). cols and the row strides count Units.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
halo_shift_kernel(const ShiftTable table, int n_time, int direction,
                  long long cols, int chunks_per_row) {
  const int shard = blockIdx.y;
  const int t = shard % n_time;
  const int src_t = t - direction;
  const int row = blockIdx.x / chunks_per_row;
  const long long c0 = (long long)(blockIdx.x % chunks_per_row) *
                       (kThreads * kUnitsPerThread) + threadIdx.x;
  Unit* __restrict__ dst = static_cast<Unit*>(table.dst[shard]) +
                           (long long)row * cols;
  if (src_t < 0 || src_t >= n_time) {
    const Unit zero{};
#pragma unroll
    for (int k = 0; k < kUnitsPerThread; ++k) {
      const long long c = c0 + (long long)k * kThreads;
      if (c < cols) dst[c] = zero;
    }
    return;
  }
  // The source shard (d, t - direction) is shard - direction.
  const int src_shard = shard - direction;
  const Unit* __restrict__ src =
      static_cast<const Unit*>(table.src[src_shard]) +
      (long long)row * table.src_row_stride[src_shard];
#pragma unroll
  for (int k = 0; k < kUnitsPerThread; ++k) {
    const long long c = c0 + (long long)k * kThreads;
    if (c < cols) dst[c] = src[c];
  }
}

template <typename Unit>
cudaError_t launch(const ShiftTable& table, int n_shards, int n_time,
                   int direction, int rows, long long cols,
                   cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnitsPerThread;
  const long long chunks = (cols + per_block - 1) / per_block;
  if (chunks * rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(chunks * rows), n_shards);
  halo_shift_kernel<Unit><<<grid, kThreads, 0, stream>>>(
      table, n_time, direction, cols, (int)chunks);
  return cudaGetLastError();
}

}  // namespace

// Shift the [rows, cols] block of every shard of an (n_data x n_time) mesh
// by `direction` along 'time'.
//
// src[i], dst[i]: shard i's source block (rows contiguous, row stride
// src_row_stride[i] elements) and its contiguous destination, i = d * n_time
// + t, all on the current device; elem_bytes 4 (float32) or 2 (bfloat16);
// n_data * n_time <= 64. Returns a cudaError_t (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int ddsp_halo_shift(const void* const* src, void* const* dst,
                               const long long* src_row_stride, int n_data,
                               int n_time, int direction, int rows,
                               long long cols, int elem_bytes,
                               void* stream) {
  const int n_shards = n_data * n_time;
  if (n_data < 1 || n_time < 1 || n_shards > kMaxShards || rows < 0 ||
      cols < 0 || (elem_bytes != 4 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaSuccess;
  ShiftTable table;
  bool vec = (cols * elem_bytes) % 16 == 0;
  for (int i = 0; i < n_shards; ++i) {
    table.src[i] = src[i];
    table.dst[i] = dst[i];
    table.src_row_stride[i] = src_row_stride[i];
    vec = vec && reinterpret_cast<uintptr_t>(src[i]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dst[i]) % 16 == 0 &&
          (src_row_stride[i] * elem_bytes) % 16 == 0;
  }
  for (int i = n_shards; i < kMaxShards; ++i) {
    table.src[i] = nullptr;
    table.dst[i] = nullptr;
    table.src_row_stride[i] = 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const int per = 16 / elem_bytes;
    for (int i = 0; i < n_shards; ++i) table.src_row_stride[i] /= per;
    return (int)launch<uint4>(table, n_shards, n_time, direction, rows,
                              cols / per, s);
  }
  if (elem_bytes == 4)
    return (int)launch<uint32_t>(table, n_shards, n_time, direction, rows,
                                 cols, s);
  return (int)launch<uint16_t>(table, n_shards, n_time, direction, rows, cols,
                               s);
}
