"""Ring all-reduce of the sharded sweep's counters: the plain PyTorch
version and the wrapper of its CUDA kernel (csrc/ring.cu, K5).

`ring_allreduce_plain` is the sum the JAX package's
ecc_ldpc_tpu/dist/ring.py::ring_allreduce computes: every rank's block
gathered into per-source slots (a gloo all_gather, staged through host
memory), then added in slot order 0, 1, ..., D-1, so every rank holds the
same bits. It is the CPU path and the card's yardstick.

`ring_allreduce_cuda` launches the kernel that replaces
ecc_ldpc_tpu/dist/ring.py::_ring_allreduce_kernel: the ranks of a `Ring`
share one card (or the cards of one host), each rank's slot buffer is
mapped into its left neighbour through CUDA IPC, ring step i copies slot
(rank - i) mod D into the same slot of the right neighbour, and a sum kernel
adds the slots in slot order. The steps are ordered on the host (stream
sync, then a gloo barrier); D = 1 launches nothing and returns the input,
as the reference does.

On one card a mesh of several ranks is several processes sharing the
device. NCCL refuses two ranks on one GPU, so the process group is gloo
(rendezvous, barriers, the handle exchange) and the counter sum on the card
is this kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..device import resolve_device

_DTYPES = {torch.float32: 0, torch.int64: 1}
_ALIGN = 16  # the copy kernel's vector width in bytes


def _lib():
    """The built ring library with its signatures set."""
    from .. import _build

    lib = _build.load("ring")
    if lib.ring_copy.argtypes is None:
        ptr, size = ctypes.c_void_p, ctypes.c_size_t
        sigs = {
            "ring_alloc": [ctypes.c_int, size, ctypes.POINTER(ptr)],
            "ring_free": [ptr],
            "ring_handle_size": [],
            "ring_get_handle": [ptr, ctypes.c_char_p],
            "ring_open_handle": [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.POINTER(ptr)],
            "ring_close_handle": [ptr],
            "ring_copy": [ptr, ptr, size, ptr],
            "ring_sum": [ptr, ptr, ctypes.c_int, size, size, ctypes.c_int, ptr],
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

    On a card with D > 1 ranks it holds one slot buffer per rank, made by
    the library with cudaMalloc (an IPC handle names a whole allocation,
    which PyTorch's caching allocator does not give), of 2 x D slots of
    `nbytes` rounded up to 16 B: calls alternate between the two halves, so
    a rank may start the next call while its neighbour still sums the last.
    Its IPC handle is exchanged once with all_gather_object; each rank maps
    its right neighbour's buffer. close() unmaps and frees it (the Ring is
    also a context manager). On the CPU it holds only the group."""

    def __init__(self, group=None, device="cuda", nbytes: int = 0):
        self.group = group
        self.size, self.rank = group_size_rank(group)
        self.device = resolve_device(device)
        self.stride = -(-max(int(nbytes), 1) // _ALIGN) * _ALIGN
        self.calls = 0
        self._own = self._peer = None
        if self.device.type != "cuda" or self.size == 1:
            return
        lib = _lib()
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        index = self.device.index
        own, peer = ctypes.c_void_p(), ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.ring_handle_size())
        with torch.cuda.device(self.device):
            _check(lib, "alloc", lib.ring_alloc(
                index, 2 * self.size * self.stride, ctypes.byref(own)))
            self._own = own.value
            _check(lib, "IPC handle", lib.ring_get_handle(self._own, handle))
        handles = [None] * self.size
        dist.all_gather_object(handles, handle.raw, group=group)
        with torch.cuda.device(self.device):
            _check(lib, "IPC open", lib.ring_open_handle(
                index, handles[(self.rank + 1) % self.size],
                ctypes.byref(peer)))
        self._peer = peer.value

    def close(self) -> None:
        """Unmap the neighbour's buffer and free this rank's, once every
        rank is done with both (collective: every rank calls it)."""
        if self._own is None:
            return
        lib = _lib()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            _check(lib, "IPC close", lib.ring_close_handle(self._peer))
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            _check(lib, "free", lib.ring_free(self._own))
        self._own = self._peer = None

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
    """The same sum by K5 on x's card: the local copy, D - 1 ring copies
    through the IPC mapping and the sum, launched on the current stream
    (calls of one Ring use one stream). Raises on anything the kernel does
    not take; never falls back to the plain version."""
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
    if ring._own is None or x.device != ring.device:
        raise ValueError(f"this Ring has no slot buffer on {x.device}")
    nbytes = x.numel() * x.element_size()
    if nbytes > ring.stride:
        raise ValueError(f"{nbytes} bytes exceed the Ring's slots of "
                         f"{ring.stride}")
    lib = _lib()
    D, r, stride = ring.size, ring.rank, ring.stride
    base = ring._own + (ring.calls % 2) * D * stride
    peer = ring._peer + (ring.calls % 2) * D * stride
    ring.calls += 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        sp = stream.cuda_stream
        _check(lib, "copy", lib.ring_copy(x.data_ptr(), base + r * stride,
                                          nbytes, sp))
        ring_allreduce_cuda.launches += 1
        for i in range(D - 1):
            slot = (r - i) % D * stride
            _check(lib, "copy", lib.ring_copy(base + slot, peer + slot,
                                              stride, sp))
            ring_allreduce_cuda.launches += 1
            stream.synchronize()
            dist.barrier(group=ring.group)
        out = torch.empty_like(x)
        _check(lib, "sum", lib.ring_sum(base, out.data_ptr(), D, x.numel(),
                                        stride // x.element_size(),
                                        _DTYPES[x.dtype], sp))
        ring_allreduce_cuda.launches += 1
    return out


ring_allreduce_cuda.launches = 0


def ring_allreduce(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Sum x over the Ring's ranks: the plain version for a CPU tensor, K5
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return ring_allreduce_plain(x, ring.group)
    return ring_allreduce_cuda(x, ring)
