// Ring all-reduce over CUDA IPC (K5), for Hopper.
//
// Replaces ecc_ldpc_tpu/dist/ring.py::_ring_allreduce_kernel (:27, reached
// through ring_allreduce :63, pallas_call :74): a ring all-gather of each
// rank's block into per-source slots, then a local sum of the slots in the
// order 0, 1, ..., D-1. At ring step i (0 <= i < D-1) rank r copies slot
// (r - i) mod D of its own slot buffer into the SAME slot of rank
// (r + 1) mod D's buffer; every slot is written exactly once, so no slot is
// reused within a call (the reference's note at :33-35). The sum adds the
// slots in slot order, so every rank gets the same bits and f32 results
// equal the JAX kernel's to the bit. The caller is
// ecc_ldpc_tpu_torch/dist/ring.py (ring_allreduce_cuda, class Ring); its
// plain PyTorch twin, ring_allreduce_plain, is the reference.
//
// The TPU kernel's remote DMA becomes a store into another process's
// memory: each rank maps its right neighbour's slot buffer with
// cudaIpcOpenMemHandle and ring_copy writes through that pointer with
// 16-byte vector stores. An IPC handle names a whole cudaMalloc allocation,
// while PyTorch's caching allocator sub-allocates (and with
// expandable_segments maps VMM memory, which cudaIpcGetMemHandle rejects),
// so the slot buffer is this library's own cudaMalloc (ring_alloc): the one
// allocation a kernel library of this repository makes. A process cannot
// open its own handle; each rank opens only its neighbour's.
//
// Ordering between ring steps is on the host: the wrapper launches a copy,
// synchronises its stream, then waits at a gloo barrier. Without MPS the
// kernels of different processes on one card time-slice rather than run
// together, so a kernel that spun on a flag written by another process's
// kernel would advance only at timeslice boundaries; no kernel here waits
// on another process.
//
// What bounds it on this card: at the sweep counters' size (a few hundred
// bytes) the D-1 host round trips (stream sync plus a barrier) and the
// launches, not the device; at large sizes HBM bytes, shared by all D ranks
// of the one card: per rank 2 S for the local copy, 2 (D-1) S for the ring
// copies and (D+1) S for the sum. With one rank on each card of a host the
// IPC mapping points at the peer card's memory, and the same code is a
// peer-to-peer ring between the cards (over NVLink where the cards have it;
// bench/ring.py on four ranks checks it there as on one card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Copies `bytes` from src to dst: 16-byte vectors for the aligned bulk
// (the wrapper checks that both pointers are 16-byte aligned), bytes for a
// ragged tail.
__global__ void copy_kernel(const int4* __restrict__ src, int4* __restrict__ dst,
                            size_t n16, const uint8_t* __restrict__ src_tail,
                            uint8_t* __restrict__ dst_tail, int tail) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride)
    dst[i] = src[i];
  if (blockIdx.x == 0 && (int)threadIdx.x < tail)
    dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

// out[j] = ((slot_0[j] + slot_1[j]) + ...) + slot_{D-1}[j], slot d at
// slots + d * stride elements.
template <typename T>
__global__ void sum_kernel(const T* __restrict__ slots, T* __restrict__ out,
                           int D, size_t n, size_t stride) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += step) {
    T acc = slots[j];
    for (int d = 1; d < D; ++d) acc = acc + slots[(size_t)d * stride + j];
    out[j] = acc;
  }
}

constexpr int kThreads = 256;

int blocks_for(size_t n) {
  size_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > 4 * 132) b = 4 * 132;  // grid-stride beyond four blocks per SM
  return (int)b;
}

// Makes `device` the calling thread's current card for its lifetime and
// then restores the one before, so that a call leaves the caller's device
// as it found it. It switches only when the two differ: since CUDA 12
// cudaSetDevice opens the card's context, and a rank should open none but
// its own.
struct DeviceGuard {
  int before = -1;
  bool switched = false;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&before);
    if (err == cudaSuccess && before != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(before);
  }
};

}  // namespace

extern "C" {

// The slot buffer: `bytes` of zeroed device memory from cudaMalloc on card
// `device`, its address in *ptr.
int ring_alloc(int device, size_t bytes, void** ptr) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(*ptr, 0, bytes);
}

int ring_free(void* ptr) { return (int)cudaFree(ptr); }

// sizeof(cudaIpcMemHandle_t): 64 bytes.
int ring_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

// Writes the IPC handle of the allocation at ptr to handle.
int ring_get_handle(void* ptr, void* handle) {
  return (int)cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

// Maps another process's allocation named by handle into card `device`;
// its address in *ptr.
int ring_open_handle(int device, const void* handle, void** ptr) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaIpcMemHandle_t h = *static_cast<const cudaIpcMemHandle_t*>(handle);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ring_close_handle(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// One copy of `bytes` from src to dst on the stream (either may be an
// IPC-mapped pointer); returns cudaGetLastError() (0 on a successful
// launch).
int ring_copy(const void* src, void* dst, size_t bytes, void* stream) {
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t n16 = bytes / 16;
  const int tail = (int)(bytes % 16);
  const uint8_t* s8 = static_cast<const uint8_t*>(src) + n16 * 16;
  uint8_t* d8 = static_cast<uint8_t*>(dst) + n16 * 16;
  copy_kernel<<<blocks_for(n16 > 0 ? n16 : 1), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), n16, s8, d8,
      tail);
  return (int)cudaGetLastError();
}

// out = the sum of D slots of n elements each, stride elements apart, in
// slot order; dtype 0 = float32, 1 = int64.
int ring_sum(const void* slots, void* out, int D, size_t n, size_t stride,
             int dtype, void* stream) {
  if (D < 1 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (dtype == 0)
    sum_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(slots), static_cast<float*>(out), D, n,
        stride);
  else
    sum_kernel<long long><<<blocks, kThreads, 0, st>>>(
        static_cast<const long long*>(slots), static_cast<long long*>(out), D,
        n, stride);
  return (int)cudaGetLastError();
}

const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
