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
// The shards of one launch are a run of the mesh's row-major order: the
// whole mesh in one process, or one rank's shards of a mesh over ranks,
// which may start and end inside a data row. Local shard j sits at time
// (first_t + j) % n_time; where its source lies outside the run, the
// launch writes zeros and the remote copy below fills the shard.
//
//   grid.y  destination shard j of the run;
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
// counterpart of pallas_halo.py:88 _shift_kernel's make_async_remote_copy
// between neighbour barrier semaphores. Each rank allocates one receive slot
// per block size with cudaMalloc (IPC handles cover whole allocations),
// exchanges its cudaIpcMemHandle_t with every rank once and maps its
// neighbours' slots (kernels/halo.py): the ranks that hold the time shards
// just before and after its run, which may lie in two data rows. A slot is a header of flag words
// and two data parities. One shift on one rank is a sequence on its stream,
// with no host synchronisation:
//
//   1. wait (sender): the own header's word `consumed[side][p]` reaches
//      use - 2, where p = use & 1 is the parity and side the neighbour the
//      block goes to;
//   2. push kernel: the edge block into the neighbour's slot, parity p, with
//      16-byte stores where the rows allow them;
//   3. stamp: the neighbour's `flag[p]` = (use << 32) | (call << 1) |
//      (direction > 0), by a stream write whose memory barrier orders the
//      push before it;
//   4. wait (receiver): the own `flag[p]` reaches use << 32;
//   5. copy-out kernel: checks the exact stamp (the same use, call and
//      direction on both ends) and copies parity p into the output, or
//      writes zeros at an end of the time axis;
//   6. consumed: this rank's use is written into both neighbours' headers
//      (`consumed[1][p]` of the left one, `consumed[0][p]` of the right
//      one), since the next sender into this slot's parity p may be either.
//
// Each rank waits only on words in its own memory, and a rank that only
// sends never overwrites a parity that is still unread (step 1 takes the
// place of the TPU kernel's neighbour barrier). Steps 1 and 4 are stream
// memory operations (cuStreamWaitValue64; steps 3 and 6 cuStreamWriteValue64,
// reached through cudaGetDriverEntryPoint, no -lcuda): the card's front end
// waits, no SM is held, and another process's context runs meanwhile.
// (Polls in the kernels, thread 0 of each block with __nanosleep back-off,
// were measured beside them on one card and lost between processes;
// PERF.md.) A fault (a stamp of another call or direction, or a word that a wait
// should have settled) is written by the kernels into a block of pinned
// host memory mapped into the device (ddsp_halo_fault_block), with the
// launch's tag, call and use; the kernels also write there the last tag
// that passed each wait. The host reads it without waiting at every launch
// and raises at the points where it waits anyway; a stream wait has no
// timeout of its own, so the host bounds those waits (kernels/halo.py
// check) and names the wait that did not end from those tags.
//
// What the earlier design (commit 232c8fb) did and what replaced it: (1)
// the host copied the
// error word back and synchronised the stream after every shift: now the
// fault block is read without waiting; (2) thread 0 of each of at most 32
// blocks spun on system-scope acquire loads, holding SMs and its context on
// the card (between processes on one card a whole timeslice per wait), and
// 32 blocks could not keep a link's bytes in flight: now the waits are
// stream operations and the two kernels' grids follow the block and the
// card (up to kMaxRemoteBlocksPerSm blocks an SM, 16-byte units where the
// rows allow them); (3) the slot round trip moves 4 x the
// block's bytes (push, then copy out) and stays: at the long-audio carry
// ([2, 120000] float32, 960 KB) 3.84 MB, a floor of 0.00115 ms at 3.35 TB/s,
// far below what a shift's launches and waits take (PERF.md).
//
// Bound of the remote copy: the edge block read once and the output
// written once, 2 x its bytes of device memory (0.000573 ms for the carry
// at 3.35 TB/s); across cards the block crosses NVLink once (0.00213 ms at
// 450 GB/s each way). The design moves 4 x its bytes; flags and waits are
// a few words.

#include <cuda.h>
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
halo_shift_kernel(const ShiftTable table, int n_shards, int n_time,
                  int first_t, int direction, long long cols,
                  int chunks_per_row) {
  const int shard = blockIdx.y;
  const int t = (first_t + shard) % n_time;
  const int src_t = t - direction;
  // The source shard (d, t - direction) is shard - direction of the run.
  const int src_shard = shard - direction;
  const int row = blockIdx.x / chunks_per_row;
  const long long c0 = (long long)(blockIdx.x % chunks_per_row) *
                       (kThreads * kUnitsPerThread) + threadIdx.x;
  Unit* __restrict__ dst = static_cast<Unit*>(table.dst[shard]) +
                           (long long)row * cols;
  if (src_t < 0 || src_t >= n_time || src_shard < 0 ||
      src_shard >= n_shards) {
    const Unit zero{};
#pragma unroll
    for (int k = 0; k < kUnitsPerThread; ++k) {
      const long long c = c0 + (long long)k * kThreads;
      if (c < cols) dst[c] = zero;
    }
    return;
  }
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
                   int first_t, int direction, int rows, long long cols,
                   cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnitsPerThread;
  const long long chunks = (cols + per_block - 1) / per_block;
  if (chunks * rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(chunks * rows), n_shards);
  halo_shift_kernel<Unit><<<grid, kThreads, 0, stream>>>(
      table, n_shards, n_time, first_t, direction, cols, (int)chunks);
  return cudaGetLastError();
}

}  // namespace

// Shift the [rows, cols] block of every shard of a run of n_shards shards
// of a mesh with n_time time shards a row, by `direction` along 'time'.
//
// src[j], dst[j]: the run's shard j's source block (rows contiguous, row
// stride src_row_stride[j] elements) and its contiguous destination, at
// time (first_t + j) % n_time, all on the current device; elem_bytes 4
// (float32) or 2 (bfloat16); n_shards <= 64. A whole (n_data x n_time)
// mesh is the run of n_data * n_time shards from first_t = 0. Returns a
// cudaError_t (cudaErrorInvalidValue for arguments it does not take).
extern "C" int ddsp_halo_shift(const void* const* src, void* const* dst,
                               const long long* src_row_stride, int n_shards,
                               int n_time, int first_t, int direction,
                               int rows, long long cols, int elem_bytes,
                               void* stream) {
  if (n_shards < 1 || n_time < 1 || first_t < 0 || first_t >= n_time ||
      n_shards > kMaxShards || rows < 0 || cols < 0 ||
      (elem_bytes != 4 && elem_bytes != 2))
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
    return (int)launch<uint4>(table, n_shards, n_time, first_t, direction,
                              rows, cols / per, s);
  }
  if (elem_bytes == 4)
    return (int)launch<uint32_t>(table, n_shards, n_time, first_t, direction,
                                 rows, cols, s);
  return (int)launch<uint16_t>(table, n_shards, n_time, first_t, direction,
                               rows, cols, s);
}

// ---------------------------------------------------------------------------
// The remote copy between ranks
// ---------------------------------------------------------------------------
namespace {

constexpr int kSlotHeader = 1024;
constexpr int kMaxRemoteBlocksPerSm = 8;
// Fault codes the kernels write into the fault block.
constexpr unsigned kErrPushWait = 1;  // the neighbour had not consumed
constexpr unsigned kErrRecvWait = 2;  // the neighbour's block had not come
constexpr unsigned kErrStamp = 3;     // a stamp of another call arrived

// One slot's header, in the slot's device memory. flag[p] is written by the
// neighbour that pushes parity p; consumed[side][p] by the neighbour on
// `side` (0 left, 1 right) when it has read its own parity p.
struct SlotHeader {
  unsigned long long flag[2];
  unsigned long long pad[14];
  unsigned long long consumed[2][2];
};
static_assert(sizeof(SlotHeader) <= kSlotHeader, "slot header");

// The process's fault block, in pinned host memory mapped into the device.
// `code` is written last; `pushed` and `copied` are the last tags whose
// push and copy-out passed their waits.
struct FaultBlock {
  unsigned code;
  unsigned tag;
  unsigned call;
  unsigned use;
  unsigned long long seen;
  unsigned pushed;
  unsigned copied;
};

// The launch's ids, written into the fault block: the host's tag, the
// mesh's call, the slot's use, and the count of faults the host has
// reported (gen), which a fault must find in g_fault_claim to claim the
// block: a fault of a launch enqueued before the host reported the last
// one is not written over it.
struct Ids {
  unsigned tag, call, use, gen;
};

__device__ unsigned g_fault_claim;

// Acquire: what the writer published before this word is visible after
// it (the block's other threads read after the barrier that follows).
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ void fail(FaultBlock* f, unsigned code, const Ids& ids,
                     unsigned long long seen) {
  if (atomicCAS(&g_fault_claim, ids.gen, ids.gen + 1) != ids.gen) return;
  volatile FaultBlock* v = f;
  v->tag = ids.tag;
  v->call = ids.call;
  v->use = ids.use;
  v->seen = seen;
  __threadfence_system();
  store_release(&f->code, code);
}

__device__ __forceinline__ uint4 load_l2(const uint4* p) { return __ldcg(p); }
__device__ __forceinline__ uint32_t load_l2(const uint32_t* p) {
  return __ldcg(reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ uint16_t load_l2(const uint16_t* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// Step 2: grid.y the block's rows, grid.x a grid-stride loop over a row's
// Units. Thread 0 of each block checks the sender's condition (which the
// stream wait before the launch has settled) first.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
halo_push_kernel(const Unit* __restrict__ send, long long send_stride,
                 Unit* __restrict__ dst, long long cols,
                 const unsigned long long* consumed, unsigned long long need,
                 FaultBlock* fault, Ids ids) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    const unsigned long long c = load_acquire(consumed);
    ok = (long long)(c - need) >= 0;
    if (!ok) {
      fail(fault, kErrPushWait, ids, c);
    } else if (blockIdx.x == 0 && blockIdx.y == 0) {
      reinterpret_cast<volatile FaultBlock*>(fault)->pushed = ids.tag;
    }
  }
  __syncthreads();
  if (!ok) return;
  const Unit* __restrict__ src = send + (long long)blockIdx.y * send_stride;
  Unit* __restrict__ out = dst + (long long)blockIdx.y * cols;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
       k < cols; k += (long long)gridDim.x * kThreads)
    out[k] = src[k];
}

// Step 5 over the contiguous [rows * cols] output: the slot's parity (L2
// loads: the neighbour wrote it from another SM or card) or zeros.
template <typename Unit>
__global__ void __launch_bounds__(kThreads)
halo_copyout_kernel(const Unit* __restrict__ slot, Unit* __restrict__ out,
                    long long n_units, int has_src,
                    const unsigned long long* flag, unsigned long long stamp,
                    FaultBlock* fault, Ids ids) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = 1;
    if (has_src) {
      const unsigned long long v = load_acquire(flag);
      if (v != stamp) {
        ok = 0;
        fail(fault, (long long)(v - (stamp & ~0xffffffffULL)) < 0
                        ? kErrRecvWait : kErrStamp,
             ids, v);
      }
    }
    if (ok && blockIdx.x == 0)
      reinterpret_cast<volatile FaultBlock*>(fault)->copied = ids.tag;
  }
  __syncthreads();
  if (!ok) return;
  const long long step = (long long)gridDim.x * kThreads;
  long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (has_src) {
    for (; k < n_units; k += step) out[k] = load_l2(slot + k);
  } else {
    const Unit zero{};
    for (; k < n_units; k += step) out[k] = zero;
  }
}

long long parity_bytes(long long nbytes) { return (nbytes + 255) / 256 * 256; }

// The CUDA stream memory operations, reached through the runtime.
typedef CUresult (*WaitValue64Fn)(CUstream, CUdeviceptr, cuuint64_t,
                                  unsigned int);
typedef CUresult (*WriteValue64Fn)(CUstream, CUdeviceptr, cuuint64_t,
                                   unsigned int);
typedef CUresult (*DeviceAttributeFn)(int*, CUdevice_attribute, CUdevice);

cudaError_t entry_point(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      name, fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t e =
      cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &found);
#endif
  if (e != cudaSuccess) return e;
  if (found != cudaDriverEntryPointSuccess || *fn == nullptr)
    return cudaErrorNotSupported;
  return cudaSuccess;
}

struct MemOps {
  WaitValue64Fn wait = nullptr;
  WriteValue64Fn write = nullptr;
  int sms = 0;
  int device = -1;
};

// The entry points, and the current device's SM count, once a device;
// cudaErrorNotSupported where the device has no 64-bit stream memory
// operations or cannot map host memory.
cudaError_t mem_ops(MemOps** out) {
  static MemOps ops;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (ops.device != device) {
    void* p = nullptr;
    if ((e = entry_point("cuDeviceGetAttribute", &p)) != cudaSuccess)
      return e;
    int can = 0;
    if (reinterpret_cast<DeviceAttributeFn>(p)(
            &can, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
            (CUdevice)device) != CUDA_SUCCESS || !can)
      return cudaErrorNotSupported;
    int map = 0;
    e = cudaDeviceGetAttribute(&map, cudaDevAttrCanMapHostMemory, device);
    if (e != cudaSuccess) return e;
    if (!map) return cudaErrorNotSupported;
    if ((e = entry_point("cuStreamWaitValue64", &p)) != cudaSuccess)
      return e;
    ops.wait = reinterpret_cast<WaitValue64Fn>(p);
    if ((e = entry_point("cuStreamWriteValue64", &p)) != cudaSuccess)
      return e;
    ops.write = reinterpret_cast<WriteValue64Fn>(p);
    e = cudaDeviceGetAttribute(&ops.sms, cudaDevAttrMultiProcessorCount,
                               device);
    if (e != cudaSuccess) return e;
    ops.device = device;
  }
  *out = &ops;
  return cudaSuccess;
}

// CUresult and cudaError_t share the codes that these calls return.
cudaError_t cu_error(CUresult r) { return static_cast<cudaError_t>(r); }

FaultBlock* g_fault_host = nullptr;
FaultBlock* g_fault_device = nullptr;

cudaError_t fault_block() {
  if (g_fault_host != nullptr) return cudaSuccess;
  void* host = nullptr;
  cudaError_t e = cudaHostAlloc(&host, sizeof(FaultBlock),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return e;
  std::memset(host, 0, sizeof(FaultBlock));
  void* device = nullptr;
  e = cudaHostGetDevicePointer(&device, host, 0);
  if (e != cudaSuccess) {
    cudaFreeHost(host);
    return e;
  }
  g_fault_host = static_cast<FaultBlock*>(host);
  g_fault_device = static_cast<FaultBlock*>(device);
  return cudaSuccess;
}

// Steps 2 and 5 for one Unit: the push (when send is not null) and the
// copy-out, each launched after the stream operation before it.
template <typename Unit>
struct Remote {
  const MemOps* ops;
  cudaStream_t s;
  Ids ids;

  cudaError_t push(const void* send, long long send_stride, int rows,
                   long long cols, void* dst,
                   const unsigned long long* consumed,
                   unsigned long long need) const {
    const long long per_block = (long long)kThreads * kUnitsPerThread;
    long long x = (cols + per_block - 1) / per_block;
    long long cap = (long long)ops->sms * kMaxRemoteBlocksPerSm / rows;
    if (cap < 1) cap = 1;
    if (x > cap) x = cap;
    halo_push_kernel<Unit><<<dim3((unsigned)x, (unsigned)rows), kThreads, 0,
                             s>>>(
        static_cast<const Unit*>(send), send_stride, static_cast<Unit*>(dst),
        cols, consumed, need, g_fault_device, ids);
    return cudaGetLastError();
  }

  cudaError_t copy_out(const void* slot, void* out, long long n_units,
                       int has_src, const unsigned long long* flag,
                       unsigned long long stamp) const {
    const long long per_block = (long long)kThreads * kUnitsPerThread;
    long long x = (n_units + per_block - 1) / per_block;
    const long long cap = (long long)ops->sms * kMaxRemoteBlocksPerSm;
    if (x > cap) x = cap;
    halo_copyout_kernel<Unit><<<(unsigned)x, kThreads, 0, s>>>(
        static_cast<const Unit*>(slot), static_cast<Unit*>(out), n_units,
        has_src, flag, stamp, g_fault_device, ids);
    return cudaGetLastError();
  }
};

template <typename Unit>
cudaError_t remote_shift(const MemOps* ops, const void* send,
                         long long send_stride, SlotHeader* own,
                         SlotHeader* left, SlotHeader* right, void* out,
                         int has_src, int direction, int rows, long long cols,
                         long long parity, Ids ids, cudaStream_t s) {
  const Remote<Unit> r{ops, s, ids};
  const unsigned use = ids.use, call = ids.call;
  const CUstream cs = reinterpret_cast<CUstream>(s);
  const int p = use & 1;
  const int side = direction > 0 ? 1 : 0;
  const unsigned long long base = (unsigned long long)use << 32;
  const unsigned long long stamp =
      base | ((unsigned long long)(call & 0x7fffffffu) << 1) | side;
  cudaError_t e = cudaSuccess;
  if (send != nullptr) {
    SlotHeader* to = side ? right : left;
    const unsigned long long need = use > 2 ? use - 2 : 0;
    unsigned long long* consumed = &own->consumed[side][p];
    if (need > 0 &&
        (e = cu_error(ops->wait(cs, (CUdeviceptr)consumed, need,
                                    CU_STREAM_WAIT_VALUE_GEQ))) != cudaSuccess)
      return e;
    // A contiguous block is one row.
    const bool flat = send_stride == cols;
    if ((e = r.push(send, send_stride, flat ? 1 : rows,
                    flat ? rows * cols : cols,
                    reinterpret_cast<char*>(to) + kSlotHeader + p * parity,
                    consumed, need)) != cudaSuccess)
      return e;
    if ((e = cu_error(ops->write(cs, (CUdeviceptr)&to->flag[p], stamp,
                                     CU_STREAM_WRITE_VALUE_DEFAULT))) !=
        cudaSuccess)
      return e;
  }
  if (has_src &&
      (e = cu_error(ops->wait(cs, (CUdeviceptr)&own->flag[p], base,
                                  CU_STREAM_WAIT_VALUE_GEQ))) != cudaSuccess)
    return e;
  if ((e = r.copy_out(reinterpret_cast<char*>(own) + kSlotHeader + p * parity,
                      out, rows * cols, has_src, &own->flag[p], stamp)) !=
      cudaSuccess)
    return e;
  if (left != nullptr &&
      (e = cu_error(ops->write(cs, (CUdeviceptr)&left->consumed[1][p],
                                   use, CU_STREAM_WRITE_VALUE_DEFAULT))) !=
          cudaSuccess)
    return e;
  if (right != nullptr)
    e = cu_error(ops->write(cs, (CUdeviceptr)&right->consumed[0][p], use,
                                CU_STREAM_WRITE_VALUE_DEFAULT));
  return e;
}

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

// The process's fault block (struct FaultBlock: code, tag, call, use as
// 32-bit words, the stamp seen as a 64-bit word, then the tags `pushed`
// and `copied`), allocated at the first call: its host address to
// host_out.
extern "C" int ddsp_halo_fault_block(void** host_out) {
  const cudaError_t e = fault_block();
  if (e == cudaSuccess) *host_out = g_fault_host;
  return (int)e;
}

// One rank's part of a shift between ranks, enqueued on `stream` without
// synchronising it (the sequence in the note at the top).
//
// send: this rank's edge block, [rows, cols] with contiguous rows and row
// stride send_row_stride elements, pushed into the neighbour on
// `direction`'s side (right for +1), or null when no neighbour receives it.
// left, right: the neighbours' mapped slots (null where the rank's run
// starts or ends a data row);
// the loopback passes the own slot as both. out: the contiguous [rows, cols]
// output, the own slot's block when has_src, else zeros. own: this rank's
// slot. use: the slot's use count (from 1), the same on every rank of the
// mesh; call: the mesh's call id, the same on every rank; tag: the host's id
// of this launch, written into the fault block; fault_gen: the faults the
// host has reported so far (the host clears the block's code when it
// reports one; nothing on the device is reset). Returns a
// cudaError_t (cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported on a device without 64-bit stream memory
// operations or mapped host memory).
extern "C" int ddsp_halo_remote(const void* send, long long send_row_stride,
                                void* left, void* right, void* out, void* own,
                                int has_src, int direction, int rows,
                                long long cols, int elem_bytes, unsigned use,
                                unsigned call, unsigned tag,
                                unsigned fault_gen, void* stream) {
  if (rows <= 0 || cols <= 0 || (rows > 65535 && send_row_stride != cols) ||
      (elem_bytes != 4 && elem_bytes != 2) || use == 0 || own == nullptr ||
      out == nullptr || (direction != 1 && direction != -1) ||
      (send != nullptr && (direction > 0 ? right : left) == nullptr))
    return (int)cudaErrorInvalidValue;
  MemOps* ops = nullptr;
  cudaError_t err = mem_ops(&ops);
  if (err == cudaSuccess) err = fault_block();
  if (err != cudaSuccess) return (int)err;
  const long long pb = parity_bytes((long long)rows * cols * elem_bytes);
  // The unit follows the shape alone, so that both ends of a copy cut the
  // block alike; the caller aligns what the shape allows.
  const bool vec = (cols * elem_bytes) % 16 == 0;
  if (vec && (reinterpret_cast<uintptr_t>(out) % 16 ||
              (send != nullptr &&
               (reinterpret_cast<uintptr_t>(send) % 16 ||
                (send_row_stride * elem_bytes) % 16))))
    return (int)cudaErrorInvalidValue;
  const int per = vec ? 16 / elem_bytes : 1;
  auto* own_h = static_cast<SlotHeader*>(own);
  auto* left_h = static_cast<SlotHeader*>(left);
  auto* right_h = static_cast<SlotHeader*>(right);
  const cudaStream_t s = (cudaStream_t)stream;
  const Ids ids{tag, call, use, fault_gen};
  if (vec)
    return (int)remote_shift<uint4>(ops, send, send_row_stride / per, own_h,
                                    left_h, right_h, out, has_src, direction,
                                    rows, cols / per, pb, ids, s);
  if (elem_bytes == 4)
    return (int)remote_shift<uint32_t>(ops, send, send_row_stride, own_h,
                                       left_h, right_h, out, has_src,
                                       direction, rows, cols, pb, ids, s);
  return (int)remote_shift<uint16_t>(ops, send, send_row_stride, own_h,
                                     left_h, right_h, out, has_src, direction,
                                     rows, cols, pb, ids, s);
}
