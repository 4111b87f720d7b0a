"""All-reduce of the sharded sweep's counters: the plain PyTorch version and
the wrapper of its CUDA kernels (csrc/ring.cu, K5).

`ring_allreduce_plain` is the sum the JAX package's
ecc_ldpc_tpu/dist/ring.py::ring_allreduce computes: every rank's block
gathered into per-source slots (a gloo all_gather, staged through host
memory), then added in slot order 0, 1, ..., D-1, so every rank holds the
same bits. It is the CPU path and the card's yardstick.

`ring_allreduce_cuda` replaces ecc_ldpc_tpu/dist/ring.py::
_ring_allreduce_kernel. A `Ring` knows which of its ranks share its node
(`node_plan`, from the launcher's node identity: dist/mesh.node_key). The
ranks of one node map each other's slot buffers through CUDA IPC: one push
kernel stores the rank's block into its slot on every rank of the node,
and after the node peers' pushes (interprocess CUDA events, waited on by
the stream) a sum kernel adds the slots in slot order. A node that holds
every rank does only that: two launches a call, ordered on the device,
with no stream synchronisation and no process-group call. The blocks of
ranks on other nodes reach a rank's slots through host memory: it stages
its own block to a pinned buffer, the ranks exchange their blocks over the
gloo group (the reference's DCN hop), and it copies each remote block into
its slot on its stream before the sum, so the sum and its bits are the
same on every route. D = 1 launches nothing and returns the input, as the
reference does.

On one card a mesh of several ranks is several processes sharing the
device. NCCL refuses two ranks on one GPU, so the process group is gloo
(rendezvous, the handle exchange at Ring creation, the exchange across
nodes, the plain version).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import gather_node_keys, node_key, node_leaders

_DTYPES = {torch.float32: 0, torch.int64: 1}
_ALIGN = 16  # the push kernel's vector width in bytes
_MAX_NODE = 16  # csrc/ring.cu kMaxNode: ranks of one node


def _lib():
    """The built ring library with its signatures set."""
    from .. import _build

    lib = _build.load("ring")
    if lib.ring_call.argtypes is None:
        ptr, size, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        sigs = {
            "ring_handles_size": [],
            "ring_create": [i, i, i, size, ctypes.POINTER(i), i,
                            ctypes.POINTER(ptr), ctypes.c_char_p],
            "ring_open": [ptr, ctypes.c_char_p, ctypes.c_char_p],
            "ring_call": [ptr, ptr, ptr, size, i, ptr],
            "ring_push": [ptr, ptr, size, i, ptr],
            "ring_put": [ptr, ptr, i, size, ptr],
            "ring_sum": [ptr, ptr, size, i, ptr],
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


def _say(line: str) -> None:
    """`line` to stderr in one write, so that the ranks sharing a launch's
    output cannot splice their lines (print writes the newline apart)."""
    sys.stderr.write(f"{line}\n")
    sys.stderr.flush()


def group_size_rank(group=None) -> tuple:
    """(D, rank) of `group` (the default group when None); (1, 0) when no
    process group is initialised."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


@dataclasses.dataclass(frozen=True)
class NodePlan:
    """Which ranks of a Ring a rank reaches how: `ipc`, the ranks of its
    node (itself included, ascending), through CUDA IPC; `host`, every
    other rank, through host memory. Nodes are numbered in the order of
    their leaders (lowest ranks)."""

    rank: int
    size: int
    node: int
    nodes: int
    ipc: tuple
    host: tuple

    @property
    def leader(self) -> int:
        return self.ipc[0]

    def line(self) -> str:
        """The plan as the launch output carries it."""
        return (f"ring: rank {self.rank} D={self.size} node {self.node}/"
                f"{self.nodes} ipc=[{','.join(map(str, self.ipc))}] "
                f"host=[{','.join(map(str, self.host))}]")


def node_plan(keys: list, rank: int) -> NodePlan:
    """The NodePlan of `rank` from every rank's node key (rank order)."""
    leaders = node_leaders(keys)
    order = sorted(set(leaders))
    ipc = tuple(r for r, k in enumerate(keys) if k == keys[rank])
    host = tuple(r for r in range(len(keys)) if r not in ipc)
    return NodePlan(rank=rank, size=len(keys),
                    node=order.index(leaders[rank]), nodes=len(order),
                    ipc=ipc, host=host)


class Ring:
    """K5's communicator over the ranks of `group` on `device`.

    Creating one is collective: the ranks gather their node keys and each
    computes its NodePlan (`plan`, on every device; a Ring of D > 1 prints
    `plan.line()` to stderr, and its close a line of `launches`, the K5
    launches ring_allreduce_cuda made on it; `Ring.last_plan` is the plan
    of the last Ring this process made). On a
    card each rank then holds a slot buffer, made by the library with
    cudaMalloc (an IPC handle names a whole allocation, which PyTorch's
    caching allocator does not give), of 2 x D slots of `nbytes` rounded up
    to 16 B (calls alternate between the two halves), and two interprocess
    events. Each node's leader makes sure the ring library is built, before
    a barrier, and makes a host file of a counter a node rank in its
    temporary directory, through which each call learns that its node
    peers have recorded their events (csrc/ring.cu's header). The handles
    and the file's path are exchanged with all_gather_object; each rank
    maps its node peers' buffers, opens their events and maps its leader's
    file, which the leader removes once its node has mapped it. A rank with
    ranks on other nodes also holds pinned host buffers: one slot to stage
    its block, D to receive. close() unmaps and frees them (the Ring is
    also a context manager). On the CPU it holds the group and the plan."""

    last_plan = None

    def __init__(self, group=None, device="cuda", nbytes: int = 0):
        self.group = group
        self.size, self.rank = group_size_rank(group)
        self.device = resolve_device(device)
        self.stride = -(-max(int(nbytes), 1) // _ALIGN) * _ALIGN
        self.launches = 0
        self._state = self._stage = self._parts = None
        keys = gather_node_keys(group) if self.size > 1 else [node_key()]
        self.plan = Ring.last_plan = node_plan(keys, self.rank)
        if self.size == 1:
            return
        _say(self.plan.line())
        if self.device.type != "cuda":
            return
        widest = max(keys.count(k) for k in keys)  # alike on every rank
        if widest > _MAX_NODE:
            raise ValueError(f"{widest} ranks on one node; K5 takes at most "
                             f"{_MAX_NODE}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        leader = self.plan.leader == self.rank
        path = None
        if leader:
            _lib()  # the node's build of the ring library, if it has none
            fd, path = tempfile.mkstemp(prefix="ecc_ring_")
            os.ftruncate(fd, len(self.plan.ipc) * 128)  # 16 int64 a rank
            os.close(fd)
        dist.barrier(group=group)
        lib = _lib()
        state = ctypes.c_void_p()
        handles = ctypes.create_string_buffer(lib.ring_handles_size())
        node = (ctypes.c_int * len(self.plan.ipc))(*self.plan.ipc)
        rc = lib.ring_create(self.device.index, self.size, self.rank,
                             self.stride, node, len(self.plan.ipc),
                             ctypes.byref(state), handles)
        if rc != 0:
            lib.ring_destroy(state.value)
            _check(lib, "create", rc)
        self._state = state.value
        shared = [None] * self.size
        dist.all_gather_object(shared, (handles.raw, path), group=group)
        path = shared[self.plan.leader][1]
        rc = lib.ring_open(self._state, b"".join(h for h, _ in shared),
                           path.encode())
        dist.barrier(group=group)  # every rank has mapped its node's file
        if leader:
            os.unlink(path)
        _check(lib, "open", rc)

    def host_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The exchange across nodes (collective): x staged to this rank's
        host buffer (on a card: copied on the current stream, which is then
        synchronised, so that the block is on the host before gloo sends
        it, and the last call's copies out of the receive buffers have
        run), then all_gather over the group. Returns [D, bytes of x] uint8
        on the host, row p rank p's block; the rows of `plan.host` are what
        the call uses."""
        nbytes = x.numel() * x.element_size()
        if self._parts is None or self._parts.shape[1] < nbytes:
            if x.device.type == "cuda":  # the last call's puts out of them
                torch.cuda.current_stream(x.device).synchronize()
            width, pin = max(self.stride, nbytes), self.device.type == "cuda"
            self._stage = torch.empty(width, dtype=torch.uint8,
                                      pin_memory=pin)
            self._parts = torch.empty((self.size, width), dtype=torch.uint8,
                                      pin_memory=pin)
        stage = self._stage[:nbytes]
        stage.copy_(x.reshape(-1).view(torch.uint8), non_blocking=True)
        if x.device.type == "cuda":
            torch.cuda.current_stream(x.device).synchronize()
        parts = self._parts[:, :nbytes]
        dist.all_gather(list(parts), stage, group=self.group)
        return parts

    def close(self) -> None:
        """Unmap the peers' buffers and events, then free this rank's, once
        every rank is done with them (collective: every rank calls it)."""
        if self.size > 1:
            _say(f"ring: rank {self.rank} D={self.size} closed after "
                 f"{self.launches} K5 launches")
        if self._state is None:
            self._stage = self._parts = None
            return
        lib = _lib()
        torch.cuda.synchronize(self.device)  # before the pinned buffers go
        self._stage = self._parts = None
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
    """The same sum by K5 on x's card, on the current stream (calls of one
    Ring use one stream), ordered on the device: on a Ring whose node holds
    every rank the push and the sum (ring_call), returning once they are
    enqueued; with ranks on other nodes the push, the exchange of blocks
    through host memory (Ring.host_blocks), a copy of each remote block
    into its slot and the sum. Two launches either way. Raises on anything
    the kernels do not take; never falls back to the plain version."""
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.numel(), _DTYPES[x.dtype], stream)
    if not ring.plan.host:
        _check(lib, "call", lib.ring_call(ring._state, x.data_ptr(),
                                          out.data_ptr(), *args))
    else:
        _check(lib, "push", lib.ring_push(ring._state, x.data_ptr(), *args))
        parts = ring.host_blocks(x)
        for p in ring.plan.host:
            _check(lib, "put", lib.ring_put(ring._state, parts[p].data_ptr(),
                                            p, nbytes, stream))
        _check(lib, "sum", lib.ring_sum(ring._state, out.data_ptr(), *args))
    ring.launches += 2
    ring_allreduce_cuda.launches += 2
    return out


ring_allreduce_cuda.launches = 0


def ring_allreduce(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Sum x over the Ring's ranks: the plain version for a CPU tensor, K5
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return ring_allreduce_plain(x, ring.group)
    return ring_allreduce_cuda(x, ring)
