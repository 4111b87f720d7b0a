// All-reduce over CUDA IPC and, across nodes, host memory (K5), for Hopper:
// one push to every peer of the node, the order kept on the device.
//
// Replaces ecc_ldpc_tpu/dist/ring.py::_ring_allreduce_kernel (:27, reached
// through ring_allreduce :63, pallas_call :74): a ring all-gather of each
// rank's block into per-source slots, then a local sum of the slots in the
// order 0, 1, ..., D-1. The D-1 hops are the TPU's ring topology, not the
// function, which is the sum of D blocks in slot order. Each rank holds a
// buffer of 2 x D slots (calls alternate between its two halves: call k
// uses half k % 2) and a call fills the D slots of the current half, then
// adds them:
//   push  one kernel stores the rank's block into slot `rank` of every
//         buffer of its node (the ranks given at ring_create, its own
//         included; peers' buffers mapped by cudaIpcOpenMemHandle once, at
//         Ring creation), 16-byte vector stores and a ragged tail of bytes;
//   put   (ranks of other nodes only) the caller stages its block to host
//         memory, exchanges it with the other nodes over its process group,
//         and ring_put copies each remote rank's block into that rank's
//         slot of its own buffer, host to device on the Ring's stream;
//   sum   after the node peers' pushes, one kernel adds slots 0..D-1 of its
//         own buffer in slot order, so every rank gets the same bits and
//         f32 results equal the JAX kernel's to the bit.
// A node that holds every rank calls ring_call: push and sum, two launches,
// no stream synchronisation and no process-group call. A rank with peers on
// other nodes calls ring_push, its exchange, ring_put for each remote rank
// and ring_sum; the exchange synchronises its stream once (the staged block
// must be on the host before it is sent). The caller is
// ecc_ldpc_tpu_torch/dist/ring.py (ring_allreduce_cuda, class Ring, which
// computes the node plan); its plain PyTorch twin, ring_allreduce_plain,
// is the reference.
//
// Ordering on the device. Each rank owns two interprocess events
// (cudaEventInterprocess | cudaEventDisableTiming), E_r[0] and E_r[1], and
// every peer of its node opens both (cudaIpcOpenEventHandle, once). Call k
// of rank r:
//   1. push(k); record E_r[k % 2];
//   2. publish k + 1 in r's word of a host shared-memory segment (one
//      counter per rank of the node, a file made by the node's leader and
//      mapped by the node's ranks at Ring creation);
//   (with ranks on other nodes: stage, exchange, put(k) of every remote
//      slot into half k % 2, on r's stream)
//   3. spin on the host until every node peer's word reads >= k + 1 (no
//      device work is waited for: only that the peers have issued their
//      records);
//   4. cudaStreamWaitEvent on every node peer's E_p[k % 2]; sum(k).
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
// models both.) Only node peers are waited on, and the argument is the
// same whichever route a rank takes: its publish of k + 2 comes in call
// k + 1's push, after call k's waits.
//
// Hazard 2, reuse of a half. p's push(k) writes half k % 2 of r's buffer,
// which r's sum(k - 2) read. p's push(k) follows p's sum(k - 1) on p's
// stream; that sum waited on E_r[(k - 1) % 2] as recorded in call k - 1,
// after r's push(k - 1), which follows r's sum(k - 2) on r's stream. A
// remote rank's slot is written by r's own put(k), which r enqueues on its
// stream after its sum(k - 2), and before its sum(k). So the stream order
// alone keeps every writer behind the last reader and ahead of the next,
// and a call's slots are each written exactly once: a node rank's by its
// owner's push, a remote rank's by the one put of the receiver (ring_put
// refuses a node rank's slot, ring_sum a call without its push).
//
// Hazard 3, spinning across processes. Without MPS the kernels of the
// processes sharing one card time-slice rather than run together, so a
// kernel that polled a flag written by another process's kernel would
// advance only at time-slice boundaries. No kernel here waits on another
// process: the waits are the stream's (cudaStreamWaitEvent), and the only
// spin is on the host, over the node peers having issued their records.
// The exchange across nodes is the caller's process-group call: every
// rank publishes before it, so the spin after it finds every word set.
//
// An IPC handle names a whole cudaMalloc allocation, while PyTorch's
// caching allocator sub-allocates (and with expandable_segments maps VMM
// memory, which cudaIpcGetMemHandle rejects), so the slot buffer is this
// library's own cudaMalloc: the one allocation a kernel library of this
// repository makes.
//
// What bounds it on this card: at the sweep counters' size (a few hundred
// bytes) the two launches and the host's spin for the slowest peer's
// record, and across nodes the process group's exchange (a host round
// trip); at large sizes HBM bytes, shared by all ranks of the one card: per
// rank S read and L S written by the push (L ranks on the node), (D - L) S
// copied in, D S read and S written by the sum. With one rank on each card
// of a host the IPC mappings point at the peer cards' memory and the push
// writes over peer-to-peer (NVLink where the cards have it).

#include <cuda_runtime.h>
#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <time.h>
#include <unistd.h>

#include <new>

namespace {

constexpr int kMaxNode = 16;     // ranks of one node (D is not capped)
constexpr int kThreads = 256;
constexpr int kWordStride = 16;  // int64 words between ranks' counters
constexpr double kSpinSeconds = 120.0;

struct Dests {
  int4* p[kMaxNode];  // slot `rank` of the current half, on every node rank
};

// Copies `bytes` from src to slot `rank` of every node rank's buffer:
// 16-byte vectors for the aligned bulk (src and the slots are 16-byte
// aligned), bytes for a ragged tail.
__global__ void push_kernel(const int4* __restrict__ src, Dests dst, int L,
                            size_t n16, int tail) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    const int4 v = src[i];
    for (int d = 0; d < L; ++d) dst.p[d][i] = v;
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const uint8_t b = reinterpret_cast<const uint8_t*>(src + n16)[threadIdx.x];
    for (int d = 0; d < L; ++d)
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

// One rank's side of the communicator. Its node's ranks are node[0..L-1]
// (ascending, node[me] == rank); buf, ev and the words are indexed by the
// position in that list.
struct Ring {
  int device, D, rank, L, me;
  int node[kMaxNode];
  size_t stride;                     // bytes a slot (a multiple of 16)
  char* buf[kMaxNode] = {};          // the node ranks' slot buffers, here
  cudaEvent_t ev[kMaxNode][2] = {};  // the node ranks' two events
  int64_t* words = nullptr;          // the host segment: L counters
  size_t words_bytes = 0;
  int64_t calls = 0;
  bool pushed = false;               // this call's push is enqueued
};

size_t buffer_bytes(const Ring* r) { return 2 * (size_t)r->D * r->stride; }

size_t half_offset(const Ring* r) {
  return (size_t)(r->calls % 2) * r->D * r->stride;
}

double now() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

bool call_ok(const Ring* r, const void* x, size_t n, int dtype) {
  const size_t esize = dtype == 0 ? 4 : 8;
  return dtype >= 0 && dtype <= 1 && n * esize <= r->stride && r->words &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Steps 1-2 of the header: push into every node rank's slot `rank` of the
// current half, record this rank's event, publish.
cudaError_t push_step(Ring* r, const void* x, size_t bytes, cudaStream_t st) {
  const int h = (int)(r->calls % 2);
  const size_t half = half_offset(r);
  Dests dst;
  for (int i = 0; i < r->L; ++i)
    dst.p[i] = reinterpret_cast<int4*>(r->buf[i] + half + r->rank * r->stride);
  const size_t n16 = bytes / 16;
  push_kernel<<<blocks_for(n16), kThreads, 0, st>>>(
      static_cast<const int4*>(x), dst, r->L, n16, (int)(bytes % 16));
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(r->ev[r->me][h], st);
  if (e != cudaSuccess) return e;
  __atomic_store_n(r->words + r->me * kWordStride, r->calls + 1,
                   __ATOMIC_RELEASE);
  r->pushed = true;
  return cudaSuccess;
}

// Steps 3-4: spin until every node peer has recorded, wait on their events,
// sum the D slots; the call ends.
cudaError_t sum_step(Ring* r, void* out, size_t n, int dtype, cudaStream_t st) {
  const int h = (int)(r->calls % 2);
  const int64_t want = r->calls + 1;
  double t0 = 0.0;
  for (int i = 0; i < r->L; ++i) {
    for (long spins = 0; __atomic_load_n(r->words + i * kWordStride,
                                         __ATOMIC_ACQUIRE) < want; ++spins) {
      if ((spins & 1023) == 1023) {
        if (t0 == 0.0) t0 = now();
        if (now() - t0 > kSpinSeconds) return cudaErrorTimeout;
      }
    }
  }
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < r->L && e == cudaSuccess; ++i)
    if (i != r->me) e = cudaStreamWaitEvent(st, r->ev[i][h], 0);
  if (e != cudaSuccess) return e;
  const char* slots = r->buf[r->me] + half_offset(r);
  const size_t esize = dtype == 0 ? 4 : 8;
  if (dtype == 0)
    sum_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(
        reinterpret_cast<const float*>(slots), static_cast<float*>(out), r->D,
        n, r->stride / esize);
  else
    sum_kernel<long long><<<blocks_for(n), kThreads, 0, st>>>(
        reinterpret_cast<const long long*>(slots),
        static_cast<long long*>(out), r->D, n, r->stride / esize);
  r->calls += 1;
  r->pushed = false;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one rank's handles: its buffer's cudaIpcMemHandle_t, then its
// two events' cudaIpcEventHandle_t.
int ring_handles_size() {
  return (int)(sizeof(cudaIpcMemHandle_t) + 2 * sizeof(cudaIpcEventHandle_t));
}

// Rank `rank` of D on card `device`, its node the L ranks node[0..L-1]
// (ascending, `rank` among them): its zeroed slot buffer of 2 D slots of
// `stride` bytes (a multiple of 16) and its two interprocess events; *out
// the handle the other functions take, *handles (ring_handles_size bytes)
// what the node peers need to open them.
int ring_create(int device, int D, int rank, size_t stride, const int* node,
                int L, void** out, void* handles) {
  *out = nullptr;
  if (D < 2 || rank < 0 || rank >= D || stride % 16 || L < 1 ||
      L > kMaxNode || L > D)
    return (int)cudaErrorInvalidValue;
  int me = -1;
  for (int i = 0; i < L; ++i) {
    if (node[i] < 0 || node[i] >= D || (i && node[i] <= node[i - 1]))
      return (int)cudaErrorInvalidValue;
    if (node[i] == rank) me = i;
  }
  if (me < 0) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Ring* r = new (std::nothrow) Ring;
  if (!r) return (int)cudaErrorMemoryAllocation;
  r->device = device; r->D = D; r->rank = rank; r->stride = stride;
  r->L = L; r->me = me;
  memcpy(r->node, node, L * sizeof(int));
  void* own = nullptr;
  cudaError_t e = cudaMalloc(&own, buffer_bytes(r));
  if (e == cudaSuccess) e = cudaMemset(own, 0, buffer_bytes(r));
  r->buf[me] = static_cast<char*>(own);
  for (int h = 0; h < 2 && e == cudaSuccess; ++h)
    e = cudaEventCreateWithFlags(&r->ev[me][h], cudaEventInterprocess |
                                                    cudaEventDisableTiming);
  char* out_h = static_cast<char*>(handles);
  if (e == cudaSuccess)
    e = cudaIpcGetMemHandle(reinterpret_cast<cudaIpcMemHandle_t*>(out_h), own);
  for (int h = 0; h < 2 && e == cudaSuccess; ++h)
    e = cudaIpcGetEventHandle(
        reinterpret_cast<cudaIpcEventHandle_t*>(
            out_h + sizeof(cudaIpcMemHandle_t) +
            h * sizeof(cudaIpcEventHandle_t)),
        r->ev[me][h]);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();  // the memset
  *out = r;  // freed by ring_destroy, also after a failure here
  return (int)e;
}

// Opens every node peer's buffer and events from all_handles, the D
// ranks' handles back to back (rank order; only the node's are read), and
// maps the host segment, a file of L * 128 bytes at `path` (made and zeroed
// by the node's leader before any maps it).
int ring_open(void* ring, const void* all_handles, const char* path) {
  Ring* r = static_cast<Ring*>(ring);
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const char* h = static_cast<const char*>(all_handles);
  const size_t each = (size_t)ring_handles_size();
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < r->L && e == cudaSuccess; ++i) {
    if (i == r->me) continue;
    const char* hp = h + r->node[i] * each;
    cudaIpcMemHandle_t mh;
    memcpy(&mh, hp, sizeof mh);
    void* ptr = nullptr;
    e = cudaIpcOpenMemHandle(&ptr, mh, cudaIpcMemLazyEnablePeerAccess);
    r->buf[i] = static_cast<char*>(ptr);
    for (int k = 0; k < 2 && e == cudaSuccess; ++k) {
      cudaIpcEventHandle_t eh;
      memcpy(&eh, hp + sizeof mh + k * sizeof eh, sizeof eh);
      e = cudaIpcOpenEventHandle(&r->ev[i][k], eh);
    }
  }
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)r->L * kWordStride * sizeof(int64_t);
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
// out, on `stream` of the Ring's card, for a node that holds all D ranks:
// push, record, publish, spin, waits, sum (see the header). Returns a
// cudaError_t (0 once the work is enqueued); cudaErrorTimeout if a peer
// issued no record within 120 s.
int ring_call(void* ring, const void* x, void* out, size_t n, int dtype,
              void* stream) {
  Ring* r = static_cast<Ring*>(ring);
  if (!call_ok(r, x, n, dtype) || r->L != r->D || r->pushed)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = push_step(r, x, n * (dtype == 0 ? 4 : 8), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_step(r, out, n, dtype, st);
}

// The first part of a call with ranks on other nodes: push into the node's
// buffers, record, publish.
int ring_push(void* ring, const void* x, size_t n, int dtype, void* stream) {
  Ring* r = static_cast<Ring*>(ring);
  if (!call_ok(r, x, n, dtype) || r->pushed) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)push_step(r, x, n * (dtype == 0 ? 4 : 8),
                        static_cast<cudaStream_t>(stream));
}

// Copies `bytes` of host memory at `host` (pinned, for an asynchronous
// copy) into slot `slot` of the current half of this rank's buffer, on
// `stream`: the block of rank `slot`, which is not on this node.
int ring_put(void* ring, const void* host, int slot, size_t bytes,
             void* stream) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r->pushed || slot < 0 || slot >= r->D || bytes > r->stride)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < r->L; ++i)
    if (r->node[i] == slot) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  char* dst = r->buf[r->me] + half_offset(r) + (size_t)slot * r->stride;
  return (int)cudaMemcpyAsync(dst, host, bytes, cudaMemcpyHostToDevice,
                              static_cast<cudaStream_t>(stream));
}

// The last part of a call with ranks on other nodes, after every remote
// slot's ring_put: spin, waits on the node peers, sum.
int ring_sum(void* ring, void* out, size_t n, int dtype, void* stream) {
  Ring* r = static_cast<Ring*>(ring);
  if (!call_ok(r, out, n, dtype) || !r->pushed)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(r->device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)sum_step(r, out, n, dtype, static_cast<cudaStream_t>(stream));
}

// Unmaps the node peers' buffers and closes their events (collective: call
// it once no rank's work on them is pending).
int ring_close_peers(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  DeviceGuard guard(r->device);
  cudaError_t e = guard.err;
  for (int i = 0; i < r->L; ++i) {
    if (i == r->me) continue;
    for (int k = 0; k < 2; ++k) {
      if (r->ev[i][k]) {
        const cudaError_t f = cudaEventDestroy(r->ev[i][k]);
        if (e == cudaSuccess) e = f;
        r->ev[i][k] = nullptr;
      }
    }
    if (r->buf[i]) {
      const cudaError_t f = cudaIpcCloseMemHandle(r->buf[i]);
      if (e == cudaSuccess) e = f;
      r->buf[i] = nullptr;
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
      if (r->ev[r->me][k]) cudaEventDestroy(r->ev[r->me][k]);
    if (r->buf[r->me]) {
      const cudaError_t f = cudaFree(r->buf[r->me]);
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
