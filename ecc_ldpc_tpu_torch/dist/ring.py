"""All-reduce of the sharded sweep's counters: the plain PyTorch version and
the wrapper of its CUDA kernels (csrc/ring.cu, K5).

`ring_allreduce_plain` is the sum the JAX package's
ecc_ldpc_tpu/dist/ring.py::ring_allreduce computes: every rank's block
gathered into per-source slots (a gloo all_gather, staged through host
memory), then added in slot order 0, 1, ..., D-1, so every rank holds the
same bits. It is the CPU path and the card's yardstick.

`ring_allreduce_cuda` replaces ecc_ldpc_tpu/dist/ring.py::
_ring_allreduce_kernel: the ranks of a `Ring` share one card (or the cards
of one host), every rank maps every peer's slot buffer through CUDA IPC,
one push kernel stores the rank's block into its slot on every rank, and
after the peers' pushes (interprocess CUDA events, waited on by the
stream) a sum kernel adds the slots in slot order: two launches a call,
ordered on the device, with no stream synchronisation and no process-group
call. D = 1 launches nothing and returns the input, as the reference does.

On one card a mesh of several ranks is several processes sharing the
device. NCCL refuses two ranks on one GPU, so the process group is gloo
(rendezvous, the handle exchange at Ring creation, the plain version) and
the counter sum on the card is this kernel pair.
"""
from __future__ import annotations

import ctypes
import os
import tempfile

import torch
import torch.distributed as dist

from ..device import resolve_device

_DTYPES = {torch.float32: 0, torch.int64: 1}
_ALIGN = 16  # the push kernel's vector width in bytes


def _lib():
    """The built ring library with its signatures set."""
    from .. import _build

    lib = _build.load("ring")
    if lib.ring_call.argtypes is None:
        ptr, size = ctypes.c_void_p, ctypes.c_size_t
        sigs = {
            "ring_handles_size": [],
            "ring_create": [ctypes.c_int, ctypes.c_int, ctypes.c_int, size,
                            ctypes.POINTER(ptr), ctypes.c_char_p],
            "ring_open": [ptr, ctypes.c_char_p, ctypes.c_char_p],
            "ring_call": [ptr, ptr, ptr, size, ctypes.c_int, ptr],
            "ring_close_peers": [ptr],
            "ring_destroy": [ptr],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.ring_error_string.argtypes = [ctypes.c_int]
        lib.ring_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, what: str, rc: int) -> None:
    if rc != 0:
        err = lib.ring_error_string(rc).decode()
        raise RuntimeError(f"ring {what} failed: cudaError {rc} ({err})")


def group_size_rank(group=None) -> tuple:
    """(D, rank) of `group` (the default group when None); (1, 0) when no
    process group is initialised."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


class Ring:
    """K5's communicator over the ranks of `group` on `device`.

    On a card with D > 1 ranks each rank holds a slot buffer, made by the
    library with cudaMalloc (an IPC handle names a whole allocation, which
    PyTorch's caching allocator does not give), of 2 x D slots of `nbytes`
    rounded up to 16 B (calls alternate between the two halves), and two
    interprocess CUDA events. Their IPC handles are exchanged once with
    all_gather_object, and each rank maps every peer's buffer and opens
    every peer's events. The ranks also map one host file of D counters,
    made by rank 0 in the temporary directory and removed once every rank
    has mapped it, through which each call learns that its peers have
    recorded their events (csrc/ring.cu's header). close() unmaps and frees
    them (the Ring is also a context manager). On the CPU it holds only the
    group."""

    def __init__(self, group=None, device="cuda", nbytes: int = 0):
        self.group = group
        self.size, self.rank = group_size_rank(group)
        self.device = resolve_device(device)
        self.stride = -(-max(int(nbytes), 1) // _ALIGN) * _ALIGN
        self._state = None
        if self.device.type != "cuda" or self.size == 1:
            return
        lib = _lib()
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        state = ctypes.c_void_p()
        handles = ctypes.create_string_buffer(lib.ring_handles_size())
        rc = lib.ring_create(self.device.index, self.size, self.rank,
                             self.stride, ctypes.byref(state), handles)
        if rc != 0:
            lib.ring_destroy(state.value)
            _check(lib, "create", rc)
        self._state = state.value
        path = None
        if self.rank == 0:
            fd, path = tempfile.mkstemp(prefix="ecc_ring_")
            os.ftruncate(fd, self.size * 128)  # csrc/ring.cu: 16 int64 a rank
            os.close(fd)
        shared = [None] * self.size
        dist.all_gather_object(shared, (handles.raw, path), group=group)
        path = shared[0][1]
        rc = lib.ring_open(self._state, b"".join(h for h, _ in shared),
                           path.encode())
        dist.barrier(group=group)  # every rank has mapped the file
        if self.rank == 0:
            os.unlink(path)
        _check(lib, "open", rc)

    def close(self) -> None:
        """Unmap the peers' buffers and events, then free this rank's, once
        every rank is done with them (collective: every rank calls it)."""
        if self._state is None:
            return
        lib = _lib()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        rc = lib.ring_close_peers(self._state)
        dist.barrier(group=self.group)
        rc = lib.ring_destroy(self._state) or rc
        self._state = None
        _check(lib, "close", rc)

    def __enter__(self) -> "Ring":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def ring_allreduce_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of `group` of x (same shape and type on every
    rank), added in rank order 0, 1, ..., D-1: all_gather over gloo (staged
    through host memory), then the sum on x's device."""
    D, _ = group_size_rank(group)
    if D == 1:
        return x
    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(D)]
    dist.all_gather(parts, host, group=group)
    acc = parts[0].to(x.device)
    for p in parts[1:]:
        acc = acc + p.to(x.device)
    return acc


def ring_allreduce_cuda(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The same sum by K5 on x's card: the push into every rank's slot and,
    after the peers' pushes, the sum, two launches on the current stream
    (calls of one Ring use one stream), ordered on the device; returns once
    they are enqueued. Raises on anything the kernels do not take; never
    falls back to the plain version."""
    if x.device.type != "cuda":
        raise ValueError("ring_allreduce_cuda takes a CUDA tensor; "
                         "ring_allreduce_plain is the CPU path")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ring_allreduce_cuda sums {sorted(map(str, _DTYPES))},"
                         f" not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % _ALIGN:
        raise ValueError("ring_allreduce_cuda takes a contiguous tensor "
                         "aligned to 16 bytes")
    if ring.size == 1:
        return x
    if ring._state is None or x.device != ring.device:
        raise ValueError(f"this Ring has no slot buffer on {x.device}")
    nbytes = x.numel() * x.element_size()
    if nbytes > ring.stride:
        raise ValueError(f"{nbytes} bytes exceed the Ring's slots of "
                         f"{ring.stride}")
    out = torch.empty_like(x)
    lib = _lib()
    rc = lib.ring_call(ring._state, x.data_ptr(), out.data_ptr(), x.numel(),
                       _DTYPES[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, "call", rc)
    ring_allreduce_cuda.launches += 2
    return out


ring_allreduce_cuda.launches = 0


def ring_allreduce(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Sum x over the Ring's ranks: the plain version for a CPU tensor, K5
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return ring_allreduce_plain(x, ring.group)
    return ring_allreduce_cuda(x, ring)
