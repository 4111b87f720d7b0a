// All-reduce over CUDA IPC (K5), for Hopper: one push to every peer, the
// order kept on the device.
//
// Replaces ecc_ldpc_tpu/dist/ring.py::_ring_allreduce_kernel (:27, reached
// through ring_allreduce :63, pallas_call :74): a ring all-gather of each
// rank's block into per-source slots, then a local sum of the slots in the
// order 0, 1, ..., D-1. The D-1 hops are the TPU's ring topology, not the
// function, which is the sum of D blocks in slot order. Here each rank maps
// every peer's slot buffer (cudaIpcOpenMemHandle, once, at Ring creation)
// and a call is two launches on the caller's stream:
//   push  one kernel stores the rank's block into slot `rank` of every
//         rank's buffer, its own included (16-byte vector stores, a ragged
//         tail of bytes);
//   sum   after the peers' pushes, one kernel adds slots 0..D-1 of its own
//         buffer in slot order, so every rank gets the same bits and f32
//         results equal the JAX kernel's to the bit.
// Calls alternate between two halves of each buffer (call k uses half
// k % 2). The caller is ecc_ldpc_tpu_torch/dist/ring.py (ring_allreduce_cuda,
// class Ring); its plain PyTorch twin, ring_allreduce_plain, is the
// reference.
//
// Ordering on the device. Each rank owns two interprocess events
// (cudaEventInterprocess | cudaEventDisableTiming), E_r[0] and E_r[1], and
// every peer opens both (cudaIpcOpenEventHandle, once). Call k of rank r:
//   1. push(k); record E_r[k % 2];
//   2. publish k + 1 in r's word of a host shared-memory segment (one
//      counter per rank, mapped by every rank at Ring creation);
//   3. spin on the host until every peer's word reads >= k + 1 (no device
//      work is waited for: only that the peers have issued their records);
//   4. cudaStreamWaitEvent on every peer's E_p[k % 2]; sum(k).
// No stream synchronisation and no process-group call: ring_call returns
// once its work is enqueued.
//
// Hazard 1, which record a wait binds to. cudaStreamWaitEvent binds to the
// event's most recent record at the time of the call. r enqueues its wait
// on E_p[k % 2] after seeing p's word >= k + 1, and p publishes that after
// recording E_p[k % 2] for call k: the wait binds to call k's record or a
// later one. The next record of E_p[k % 2] is p's call k + 2, which p
// issues only after its call k + 1 spin saw r's word >= k + 2; r publishes
// that in call k + 1, after it enqueued call k's waits. So each wait binds
// to exactly call k's record. (With one event a rank, p's call k + 1
// record may come first, and the wait would bind to it: safe, since it
// follows p's push(k), but not the record meant; tests/test_torch_ring.py
// models both.)
//
// Hazard 2, reuse of a half. p's push(k) writes half k % 2 of r's buffer,
// which r's sum(k - 2) read. p's push(k) follows p's sum(k - 1) on p's
// stream; that sum waited on E_r[(k - 1) % 2] as recorded in call k - 1,
// after r's push(k - 1), which follows r's sum(k - 2) on r's stream. So
// the stream order alone keeps the writer behind the last reader, and a
// call's slots are each written exactly once (by their owner's push).
//
// Hazard 3, spinning across processes. Without MPS the kernels of the
// processes sharing one card time-slice rather than run together, so a
// kernel that polled a flag written by another process's kernel would
// advance only at time-slice boundaries. No kernel here waits on another
// process: the waits are the stream's (cudaStreamWaitEvent), and the only
// spin is on the host, over the peers having issued their records.
//
// An IPC handle names a whole cudaMalloc allocation, while PyTorch's
// caching allocator sub-allocates (and with expandable_segments maps VMM
// memory, which cudaIpcGetMemHandle rejects), so the slot buffer is this
// library's own cudaMalloc: the one allocation a kernel library of this
// repository makes.
//
// What bounds it on this card: at the sweep counters' size (a few hundred
// bytes) the two launches and the host's spin for the slowest peer's
// record; at large sizes HBM bytes, shared by all D ranks of the one card:
// per rank S read and D S written by the push, D S read and S written by
// the sum. With one rank on each card of a host the IPC mappings point at
// the peer cards' memory and the push writes over peer-to-peer (NVLink
// where the cards have it).

#include <cuda_runtime.h>
#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <time.h>
#include <unistd.h>

#include <new>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kThreads = 256;
constexpr int kWordStride = 16;  // int64 words between ranks' counters
constexpr double kSpinSeconds = 120.0;

struct Dests {
  int4* p[kMaxRanks];  // slot `rank` of the current half, on every rank
};

// Copies `bytes` from src to slot `rank` of every rank's buffer: 16-byte
// vectors for the aligned bulk (src and the slots are 16-byte aligned),
// bytes for a ragged tail.
__global__ void push_kernel(const int4* __restrict__ src, Dests dst, int D,
                            size_t n16, int tail) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    const int4 v = src[i];
    for (int d = 0; d < D; ++d) dst.p[d][i] = v;
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const uint8_t b = reinterpret_cast<const uint8_t*>(src + n16)[threadIdx.x];
    for (int d = 0; d < D; ++d)
      reinterpret_cast<uint8_t*>(dst.p[d] + n16)[threadIdx.x] = b;
  }
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

// One rank's side of the communicator.
struct Ring {
  int device, D, rank;
  size_t stride;                   // bytes a slot (a multiple of 16)
  char* buf[kMaxRanks] = {};       // every rank's slot buffer, here
  cudaEvent_t ev[kMaxRanks][2] = {};  // every rank's two events
  int64_t* words = nullptr;        // the host segment: D counters
  size_t words_bytes = 0;
  int64_t calls = 0;
};

size_t buffer_bytes(const Ring* r) { return 2 * (size_t)r->D * r->stride; }

double now() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

}  // namespace

extern "C" {

// Bytes of one rank's handles: its buffer's cudaIpcMemHandle_t, then its
// two events' cudaIpcEventHandle_t.
int ring_handles_size() {
  return (int)(sizeof(cudaIpcMemHandle_t) + 2 * sizeof(cudaIpcEventHandle_t));
}

// Rank `rank` of D on card `device`: its zeroed slot buffer of 2 D slots of
// `stride` bytes (a multiple of 16) and its two interprocess events; *out
// the handle the other functions take, *handles (ring_handles_size bytes)
// what the peers need to open them.
int ring_create(int device, int D, int rank, size_t stride, void** out,
                void* handles) {
  *out = nullptr;
  if (D < 2 || D > kMaxRanks || rank < 0 || rank >= D || stride % 16)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Ring* r = new (std::nothrow) Ring;
  if (!r) return (int)cudaErrorMemoryAllocation;
  r->device = device; r->D = D; r->rank = rank; r->stride = stride;
  void* own = nullptr;
  cudaError_t e = cudaMalloc(&own, buffer_bytes(r));
  if (e == cudaSuccess) e = cudaMemset(own, 0, buffer_bytes(r));
  r->buf[rank] = static_cast<char*>(own);
  for (int h = 0; h < 2 && e == cudaSuccess; ++h)
    e = cudaEventCreateWithFlags(&r->ev[rank][h], cudaEventInterprocess |
                                                      cudaEventDisableTiming);
  char* out_h = static_cast<char*>(handles);
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(reinterpret_cast<cudaIpcMemHandle_t*>(out_h), own);
  for (int h = 0; h < 2 && e == cudaSuccess; ++h)
    e = cudaIpcGetEventHandle(
        reinterpret_cast<cudaIpcEventHandle_t*>(
            out_h + sizeof(cudaIpcMemHandle_t) +
            h * sizeof(cudaIpcEventHandle_t)),
        r->ev[rank][h]);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();  // the memset
  *out = r;  // freed by ring_destroy, also after a failure here
  return (int)e;
}

// Opens every peer's buffer and events from all_handles, the D ranks'
// handles back to back (rank order), and maps the host segment, a file of
// D * 128 bytes at `path` (made and zeroed by one rank before any maps it).
int ring_open(void* ring, const void* all_handles, const char* path) {
  Ring* r = static_cast<Ring*>(ring);
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const char* h = static_cast<const char*>(all_handles);
  const size_t each = (size_t)ring_handles_size();
  cudaError_t e = cudaSuccess;
  for (int p = 0; p < r->D && e == cudaSuccess; ++p) {
    if (p == r->rank) continue;
    const char* hp = h + p * each;
    cudaIpcMemHandle_t mh;
    memcpy(&mh, hp, sizeof mh);
    void* ptr = nullptr;
    e = cudaIpcOpenMemHandle(&ptr, mh, cudaIpcMemLazyEnablePeerAccess);
    r->buf[p] = static_cast<char*>(ptr);
    for (int k = 0; k < 2 && e == cudaSuccess; ++k) {
      cudaIpcEventHandle_t eh;
      memcpy(&eh, hp + sizeof mh + k * sizeof eh, sizeof eh);
      e = cudaIpcOpenEventHandle(&r->ev[p][k], eh);
    }
  }
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)r->D * kWordStride * sizeof(int64_t);
  const int fd = open(path, O_RDWR);
  if (fd < 0) return (int)cudaErrorFileNotFound;
  void* m = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return (int)cudaErrorMemoryAllocation;
  r->words = static_cast<int64_t*>(m);
  r->words_bytes = bytes;
  return (int)cudaSuccess;
}

// One all-reduce of n elements (dtype 0 = float32, 1 = int64) at x into
// out, on `stream` of the Ring's card: push, record, publish, spin, waits,
// sum (see the header). Returns a cudaError_t (0 once the work is
// enqueued); cudaErrorTimeout if a peer issued no record within 120 s.
int ring_call(void* ring, const void* x, void* out, size_t n, int dtype,
              void* stream) {
  Ring* r = static_cast<Ring*>(ring);
  const size_t esize = dtype == 0 ? 4 : 8;
  const size_t bytes = n * esize;
  if (dtype < 0 || dtype > 1 || bytes > r->stride || !r->words ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int h = (int)(r->calls % 2);
  const size_t half = (size_t)h * r->D * r->stride;
  Dests dst;
  for (int p = 0; p < r->D; ++p)
    dst.p[p] = reinterpret_cast<int4*>(r->buf[p] + half + r->rank * r->stride);
  const size_t n16 = bytes / 16;
  push_kernel<<<blocks_for(n16), kThreads, 0, st>>>(
      static_cast<const int4*>(x), dst, r->D, n16, (int)(bytes % 16));
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(r->ev[r->rank][h], st);
  if (e != cudaSuccess) return (int)e;
  const int64_t want = r->calls + 1;
  __atomic_store_n(r->words + r->rank * kWordStride, want, __ATOMIC_RELEASE);
  double t0 = 0.0;
  for (int p = 0; p < r->D; ++p) {
    for (long spins = 0; __atomic_load_n(r->words + p * kWordStride,
                                         __ATOMIC_ACQUIRE) < want; ++spins) {
      if ((spins & 1023) == 1023) {
        if (t0 == 0.0) t0 = now();
        if (now() - t0 > kSpinSeconds) return (int)cudaErrorTimeout;
      }
    }
  }
  for (int p = 0; p < r->D && e == cudaSuccess; ++p)
    if (p != r->rank) e = cudaStreamWaitEvent(st, r->ev[p][h], 0);
  if (e != cudaSuccess) return (int)e;
  const char* slots = r->buf[r->rank] + half;
  if (dtype == 0)
    sum_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
        reinterpret_cast<const float*>(slots), static_cast<float*>(out), r->D,
        n, r->stride / esize);
  else
    sum_kernel<long long><<<blocks_for(n), kThreads, 0, st>>>(
        reinterpret_cast<const long long*>(slots),
        static_cast<long long*>(out), r->D, n, r->stride / esize);
  r->calls += 1;
  return (int)cudaGetLastError();
}

// Unmaps the peers' buffers and closes their events (collective: call it
// once no rank's work on them is pending).
int ring_close_peers(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  DeviceGuard guard(r->device);
  cudaError_t e = guard.err;
  for (int p = 0; p < r->D; ++p) {
    if (p == r->rank) continue;
    for (int k = 0; k < 2; ++k) {
      if (r->ev[p][k]) {
        const cudaError_t f = cudaEventDestroy(r->ev[p][k]);
        if (e == cudaSuccess) e = f;
        r->ev[p][k] = nullptr;
      }
    }
    if (r->buf[p]) {
      const cudaError_t f = cudaIpcCloseMemHandle(r->buf[p]);
      if (e == cudaSuccess) e = f;
      r->buf[p] = nullptr;
    }
  }
  return (int)e;
}

// Frees this rank's buffer, events and mapping, and the handle (after
// every peer has closed its mappings of them); a null handle is a no-op.
int ring_destroy(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r) return (int)cudaSuccess;
  cudaError_t e = (cudaError_t)ring_close_peers(ring);
  {
    DeviceGuard guard(r->device);
    if (e == cudaSuccess) e = guard.err;
    for (int k = 0; k < 2; ++k)
      if (r->ev[r->rank][k]) cudaEventDestroy(r->ev[r->rank][k]);
    if (r->buf[r->rank]) {
      const cudaError_t f = cudaFree(r->buf[r->rank]);
      if (e == cudaSuccess) e = f;
    }
  }
  if (r->words) munmap(r->words, r->words_bytes);
  delete r;
  return (int)e;
}

const char* ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
