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
//
// The remote copy (ddsp_halo_remote, below) is the shift between ranks of a
// mesh over torch.distributed processes, one process per device: the
// counterpart of the TPU kernel's make_async_remote_copy between
// neighbour barrier semaphores. Each rank allocates receive slots with
// cudaMalloc (IPC handles cover whole allocations), exchanges their
// cudaIpcMemHandle_t with its row's ranks once per slot and maps its
// neighbours' (kernels/halo.py). One launch per shift and rank:
//
//   1. push: this rank's edge block goes into the neighbour's mapped slot
//      with 16-byte stores where the rows allow them (NVLink between cards,
//      the same card's memory between processes on one card), then a flag
//      word stamped with the slot's use count and the call's id, by a
//      release store at system scope;
//   2. receive: an acquire load waits for the own slot's stamp, and the
//      slot is copied into the output (L2 loads, no stale L1 line); at the
//      ends of the time axis the output is zeros;
//   3. the slot's parity is marked consumed, in the rank's own memory.
//
// Slots are double-buffered by the use count's parity. Before it writes
// use u into a parity, the sender waits until the receiver has consumed
// use u - 2 there: a rank that only sends (time shard 0 of a right shift)
// cannot overwrite a slot that its neighbour has not read. This takes the
// place of the TPU kernel's neighbour barrier. Every block of the grid
// (at most kRemoteBlocks, all resident) pushes, waits for and consumes its
// own contiguous range with its own flag words, so no block waits on
// another of its grid, and the rank with the lowest call always
// progresses. A wait is bounded by a time on %globaltimer; past it, or on
// a stamp of another call, the kernel writes an error word, which the
// host entry reads after the launch and returns. Nothing falls back.
//
// Bound of the remote copy: the edge block read once and the output
// written once, 2 x its bytes of device memory; across cards the block
// crosses the link once. The design moves 4 x its bytes (the slot is
// written and read too). Flags and waits are a few words. Between two
// processes on one card the card time-slices their contexts, so a wait
// may last a timeslice.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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

// ---------------------------------------------------------------------------
// The remote copy between ranks
// ---------------------------------------------------------------------------
namespace {

constexpr int kRemoteBlocks = 32;
constexpr int kSlotHeader = 1024;
// Error words the kernel writes into the own slot's header.
constexpr unsigned kErrPushWait = 1;   // the neighbour never consumed
constexpr unsigned kErrRecvWait = 2;   // the neighbour's stamp never came
constexpr unsigned kErrStamp = 3;      // a stamp of another call arrived

struct SlotHeader {
  unsigned long long flag[2][kRemoteBlocks];  // (use << 32) | call
  unsigned consumed[2][kRemoteBlocks];        // the last use read, by parity
  unsigned error;
};
static_assert(sizeof(SlotHeader) <= kSlotHeader, "slot header");

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void fail(SlotHeader* own, unsigned code) {
  atomicCAS(&own->error, 0u, code);
  __threadfence_system();
}

__device__ __forceinline__ uint4 load_l2(const uint4* p) { return __ldcg(p); }
__device__ __forceinline__ uint32_t load_l2(const uint32_t* p) {
  return __ldcg(reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ uint16_t load_l2(const uint16_t* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// One block per contiguous range [lo, hi) of the [rows, cols] block, in
// Units; thread 0 of a block does its waits.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
halo_remote_kernel(const Unit* __restrict__ send, long long send_stride,
                   char* peer, Unit* __restrict__ out, char* own,
                   int has_src, long long cols, long long n_units,
                   long long chunk, long long parity_bytes, unsigned use,
                   unsigned call, unsigned long long timeout_ns) {
  __shared__ int failed;
  const int b = blockIdx.x;
  const int p = use & 1;
  const long long lo = (long long)b * chunk;
  const long long hi = lo + chunk < n_units ? lo + chunk : n_units;
  const unsigned long long stamp =
      ((unsigned long long)use << 32) | (unsigned long long)call;
  SlotHeader* own_h = reinterpret_cast<SlotHeader*>(own);
  if (threadIdx.x == 0) failed = 0;
  __syncthreads();

  if (peer != nullptr) {
    SlotHeader* peer_h = reinterpret_cast<SlotHeader*>(peer);
    if (threadIdx.x == 0 && use > 2) {
      const unsigned long long start = now_ns();
      while (load_acquire(&peer_h->consumed[p][b]) < use - 2) {
        if (now_ns() - start > timeout_ns) {
          fail(own_h, kErrPushWait);
          failed = 1;
          break;
        }
      }
    }
    __syncthreads();
    if (!failed) {
      Unit* dst = reinterpret_cast<Unit*>(peer + kSlotHeader +
                                          p * parity_bytes);
      for (long long k = lo + threadIdx.x; k < hi; k += kThreads) {
        const long long row = k / cols;
        dst[k] = send[row * send_stride + (k - row * cols)];
      }
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) store_release(&peer_h->flag[p][b], stamp);
    }
  }

  if (has_src) {
    if (threadIdx.x == 0 && !failed) {
      const unsigned long long start = now_ns();
      while (true) {
        const unsigned long long v = load_acquire(&own_h->flag[p][b]);
        if (v == stamp) break;
        // An earlier use's stamp (or none yet) means the block is on its
        // way; this use's with another call, or a later use's, is a
        // mismatch.
        if ((v >> 32) >= use) {
          fail(own_h, kErrStamp);
          failed = 1;
          break;
        }
        if (now_ns() - start > timeout_ns) {
          fail(own_h, kErrRecvWait);
          failed = 1;
          break;
        }
      }
    }
    __syncthreads();
    if (failed) return;
    const Unit* src = reinterpret_cast<const Unit*>(own + kSlotHeader +
                                                    p * parity_bytes);
    for (long long k = lo + threadIdx.x; k < hi; k += kThreads)
      out[k] = load_l2(src + k);
  } else {
    const Unit zero{};
    for (long long k = lo + threadIdx.x; k < hi; k += kThreads) out[k] = zero;
  }
  __syncthreads();
  if (threadIdx.x == 0 && !failed) {
    __threadfence_system();
    store_release(&own_h->consumed[p][b], use);
  }
}

long long parity_bytes(long long nbytes) { return (nbytes + 255) / 256 * 256; }

}  // namespace

// A receive slot of `nbytes` per parity: cudaMalloc'd on the current
// device, zeroed, with its IPC handle (64 bytes) written to handle_out.
extern "C" int ddsp_halo_slot_alloc(long long nbytes, void** ptr_out,
                                    void* handle_out) {
  if (nbytes <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = kSlotHeader + 2 * parity_bytes(nbytes);
  void* ptr = nullptr;
  cudaError_t err = cudaMalloc(&ptr, total);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(ptr, 0, total);
  if (err == cudaSuccess) {
    cudaIpcMemHandle_t handle;
    err = cudaIpcGetMemHandle(&handle, ptr);
    if (err == cudaSuccess) std::memcpy(handle_out, &handle, sizeof(handle));
  }
  if (err != cudaSuccess) {
    cudaFree(ptr);
    return (int)err;
  }
  *ptr_out = ptr;
  return (int)cudaSuccess;
}

// Map another process's slot (its 64-byte handle) into this one.
extern "C" int ddsp_halo_slot_open(const void* handle, void** ptr_out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr_out, h,
                                   cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ddsp_halo_slot_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int ddsp_halo_slot_free(void* ptr) { return (int)cudaFree(ptr); }

// One rank's part of a shift between ranks.
//
// send: this rank's edge block, [rows, cols] with contiguous rows and row
// stride send_row_stride elements, pushed into `peer` (the neighbour's
// mapped slot), or null when no neighbour receives it. out: the contiguous
// [rows, cols] output, the own slot's block when has_src, else zeros.
// own: this rank's slot. use: the slot's use count (from 1), the same on
// every rank of the row; call: the row's call id, the same on every rank.
// The launch goes on `stream`, which is then synchronised to read the
// kernel's error word: *error_out gets 0 or kErrPushWait, kErrRecvWait,
// kErrStamp (and the word is cleared). Returns a cudaError_t
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int ddsp_halo_remote(const void* send, long long send_row_stride,
                                void* peer, void* out, void* own, int has_src,
                                int rows, long long cols, int elem_bytes,
                                unsigned use, unsigned call,
                                unsigned long long timeout_ns, void* stream,
                                int* error_out) {
  *error_out = 0;
  if (rows <= 0 || cols <= 0 || (elem_bytes != 4 && elem_bytes != 2) ||
      use == 0 || own == nullptr || out == nullptr ||
      (peer != nullptr && send == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nbytes = (long long)rows * cols * elem_bytes;
  const long long pb = parity_bytes(nbytes);
  // The unit follows the shape alone, so that both ends of a copy cut the
  // block into the same ranges; the caller aligns what the shape allows.
  const bool vec = (cols * elem_bytes) % 16 == 0;
  if (vec && (reinterpret_cast<uintptr_t>(out) % 16 ||
              (send != nullptr &&
               (reinterpret_cast<uintptr_t>(send) % 16 ||
                (send_row_stride * elem_bytes) % 16))))
    return (int)cudaErrorInvalidValue;
  const int per = vec ? 16 / elem_bytes : 1;
  const long long cols_u = cols / per;
  const long long n_units = rows * cols_u;
  const long long stride_u = send_row_stride / per;
  long long blocks = (n_units + kThreads * kUnitsPerThread - 1) /
                     (kThreads * kUnitsPerThread);
  if (blocks > kRemoteBlocks) blocks = kRemoteBlocks;
  if (blocks < 1) blocks = 1;
  const long long chunk = (n_units + blocks - 1) / blocks;
  const cudaStream_t s = (cudaStream_t)stream;
  char* own_c = static_cast<char*>(own);
  char* peer_c = static_cast<char*>(peer);
  if (vec) {
    halo_remote_kernel<uint4><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(send), stride_u, peer_c,
        static_cast<uint4*>(out), own_c, has_src, cols_u, n_units, chunk, pb,
        use, call, timeout_ns);
  } else if (elem_bytes == 4) {
    halo_remote_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(send), stride_u, peer_c,
        static_cast<uint32_t*>(out), own_c, has_src, cols_u, n_units, chunk,
        pb, use, call, timeout_ns);
  } else {
    halo_remote_kernel<uint16_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(send), stride_u, peer_c,
        static_cast<uint16_t*>(out), own_c, has_src, cols_u, n_units, chunk,
        pb, use, call, timeout_ns);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unsigned* err_word = &reinterpret_cast<SlotHeader*>(own)->error;
  unsigned word = 0;
  err = cudaMemcpyAsync(&word, err_word, sizeof(word), cudaMemcpyDeviceToHost,
                        s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return (int)err;
  if (word != 0) {
    *error_out = (int)word;
    err = cudaMemsetAsync(err_word, 0, sizeof(word), s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  }
  return (int)err;
}
