"""The rank grid of the sharded sweep (port of ecc_ldpc_tpu/dist/mesh.py).

The JAX package lays devices onto a ('batch', 'snr') mesh; here the ranks
of the default torch.distributed group are laid out the same way, in the
same row-major order: rank r sits at batch_shard = r // snr and
snr_shard = r % snr. Axes:

  'batch' — data-parallel codeword axis
  'snr'   — Eb/N0 grid axis

The counters are summed over every rank at once (dist/ring.py, K5), each
rank having zero-padded its own grid points into the full grid: that gives
the integers the reference's psum over 'batch' and all_gather over 'snr'
give, so no sub-group is needed. The process group is gloo: NCCL refuses
two ranks on one card, which is what a mesh larger than 1x1 is on a
one-card host.

The ranks may sit on several nodes (the reference's DCN hosts). A rank's
node is what its launcher says: torch.distributed.run gives each agent a
node rank (GROUP_RANK), so two agents started on one host are two nodes;
with no launcher (a manual maybe_init_distributed(coordinator, ...)) it is
the host. K5 reaches the ranks of its own node through CUDA IPC and the
others through host memory (dist/ring.py), and each node's leader, its
lowest rank, builds the kernels for the node (build_per_node).
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to lay devices onto ('batch', 'snr')."""

    batch: int = -1  # -1: all remaining devices
    snr: int = 1

    def resolve(self, n_devices: int) -> tuple:
        snr = self.snr
        batch = self.batch if self.batch != -1 else n_devices // snr
        if batch * snr != n_devices:
            raise ValueError(
                f"mesh {batch}x{snr} != {n_devices} devices; adjust MeshSpec"
            )
        return batch, snr


def rank_device(device="cuda") -> torch.device:
    """`device` resolved for this rank: a CUDA request becomes
    cuda:{LOCAL_RANK % device_count} (several ranks share a card when there
    are more ranks than cards); "cpu" stays the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def node_key() -> str:
    """This rank's node: "host#GROUP_RANK" where torch.distributed.run set
    GROUP_RANK (its agent's node rank), else the hostname alone."""
    group_rank = os.environ.get("GROUP_RANK")
    host = socket.gethostname()
    return host if group_rank is None else f"{host}#{group_rank}"


def node_leaders(keys: list) -> list:
    """For each rank of `keys` (one node key a rank, in rank order), the
    lowest rank with the same key: its node's leader."""
    first = {}
    return [first.setdefault(k, r) for r, k in enumerate(keys)]


def gather_node_keys(group=None) -> list:
    """Every rank's node_key() in rank order (collective over `group`)."""
    keys = [None] * dist.get_world_size(group)
    dist.all_gather_object(keys, node_key(), group=group)
    return keys


def build_per_node(group=None, names=None) -> None:
    """Build the kernel libraries (`names`, default all) once a node before
    a collective: each node's leader builds while its node's other ranks
    wait at the barrier that follows, so that no rank builds inside a
    collective and one nvcc runs per source and node (collective over
    `group`)."""
    from .. import _build

    rank = dist.get_rank(group)
    if node_leaders(gather_node_keys(group))[rank] == rank:
        _build.build_all(tuple(_build.LIBRARIES if names is None else names))
    dist.barrier(group=group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in a (batch, snr) grid of ranks, the device it runs
    on (by default rank_device(): a card, raising when there is none; the
    plain path on the host needs device=torch.device("cpu")), and the
    process group its counters are summed over (None: a single process, or
    a virtual rank that a test runs in turn with the others)."""

    batch: int
    snr: int
    rank: int = 0
    device: torch.device = dataclasses.field(default_factory=rank_device)
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.batch * self.snr

    @property
    def batch_shard(self) -> int:
        return self.rank // self.snr

    @property
    def snr_shard(self) -> int:
        return self.rank % self.snr


def make_mesh(spec: MeshSpec = MeshSpec(), device="cuda") -> Mesh:
    """This rank's Mesh over the default process group (world 1 when none
    is initialised), on rank_device(device); a card becomes this process's
    current device, so that every launch and allocation of the rank lands
    on it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    b, s = spec.resolve(world)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(batch=b, snr=s, rank=rank, device=dev,
                group=dist.group.WORLD if world > 1 else None)


def maybe_init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Rendezvous of the ranks: a gloo process group. With no arguments it
    reads the environment torch.distributed.run sets (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT); explicit arguments are for manual launches,
    coordinator being "host:port" or an init_method URL (tcp://...,
    file://...). A no-op when already initialised or single-process.
    Returns whether it initialised the group."""
    if dist.is_initialized():
        return False
    if coordinator is None and num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        dist.init_process_group("gloo", init_method="env://")
        return True
    if num_processes is not None and num_processes <= 1 and coordinator is None:
        return False
    if coordinator is None:
        raise ValueError("num_processes > 1 needs a coordinator address")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes,
                            rank=process_id)
    return True
