"""Graph-parallel decoding: one codeword's Tanner graph split across the
ranks of a process group (port of ecc_ldpc_tpu/dist/graph_parallel.py).

Each rank holds a part of every frame's decoder state and the ranks
exchange what the others need each iteration through K5 (dist/ring.py:
csrc/ring.cu on the card, ring_allreduce_plain on the CPU), the
all-reduce the JAX package's psum lowers to. The ranks are the gloo group
of dist/mesh.py: on a one-card host D processes time-sliced on cuda:0,
the way the sharded sweep runs. Every rank calls decode with the same LLRs
(replicated), as the JAX tiers take them.

Two tiers, as there:

1. make_qc_graph_parallel_decoder: QC codes. Rank r owns the Z-slice
   z in [r Z/D, (r + 1) Z/D) of every block: those checks of every
   block-row and those variables of every block-column. An iteration is
   the QC flooding decode of decode/flooding_qc.py with its state cut so:
   each rank runs the check rule on its checks (reading the replicated
   stale posteriors), the messages are exchanged, each rank rebuilds its
   variables' posteriors (llr + its messages, in the single-rank order:
   block-rows in layer_order, edges in edge-id order), and the posteriors
   are exchanged. An exchange is a K5 sum of tensors that are zero
   outside the sender's slice: it moves values, never partial sums, so
   every sum keeps the single-rank order, and adding zeros is exact but
   for the sign of a -0.0, which the count-sign rules do not read. So
   bits, ok and iterations are the single-rank decode's (K3 on the card,
   its plain version on the CPU, JAX's decode_flooding_qc) for every D.
   Track mode folds each rank's stale-parity flags into the message
   exchange (one more row): two K5 calls an iteration, one more at the
   start (track mode) and one at the end (the syndrome of ok).
   Z % D == 0 and circulant blocks, as in the JAX package.

2. make_graph_parallel_decoder (with shard_graph): any code. Rank r owns
   the checks [r ceil(m/D), (r + 1) ceil(m/D)) of the expanded graph and
   their messages; each iteration it runs the rule on them, sums its
   messages into a partial [n, B] posterior update, the partials are
   all-reduced in f32 by K5, and each rank forms llr + the sum and the
   new extrinsics of its checks; the syndrome's per-rank flags are
   all-reduced too (int64). A fixed max_iters with per-frame freeze, as
   the JAX tier runs it: a frame whose post-sweep syndrome passes keeps
   that state. The sums run in another order than the single-rank
   decoder's, so the results agree with it on frames both decode.

Per iteration the work on a rank is tensor ops (the JAX tiers are XLA,
with no Pallas kernel); K5 is the kernel on this path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..decode.cn_ops import CN_KINDS, get_rule
from ..decode.flooding_qc import _parity_fail, _plain_tables
from ..decode.types import DecodeResult
from ..device import resolve_device
from ..graph.compile import CompiledGraph, compile_graph
from ..graph.qc import QCGraph, compile_qc_graph
from .ring import Ring, group_size_rank, ring_allreduce


class _Exchange:
    """K5 over `group` on `device`, its Ring sized for the largest tensor
    asked so far (a larger one makes a new Ring, a collective step every
    rank takes at the same call). `calls` counts the all-reduces."""

    def __init__(self, group, device):
        self.group, self.device = group, device
        self.ring, self.nbytes, self.calls = None, 0, 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        nbytes = x.numel() * x.element_size()
        if self.ring is None or nbytes > self.nbytes:
            self.close()
            self.ring = Ring(self.group, self.device, nbytes)
            self.nbytes = nbytes
        self.calls += 1
        return ring_allreduce(x.contiguous(), self.ring)

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()
            self.ring = None


def _check_kind(kind: str, alpha, beta) -> None:
    if kind not in CN_KINDS:
        raise KeyError(f"graph-parallel kind must be one of {CN_KINDS}, "
                       f"got {kind!r}")
    if np.ndim(alpha) != 0 or np.ndim(beta) != 0:
        raise ValueError("graph-parallel decoders take scalar alpha/beta")


def make_qc_graph_parallel_decoder(spec_or_graph, group=None, *,
                                   kind: str = "minsum", alpha=1.0,
                                   beta=0.0, max_iters: int = 25,
                                   early_term: bool = True, device="cuda"):
    """decode(llr [B, n]) -> DecodeResult with the circulant (Z) axis of
    the decoder state split over the ranks of `group` (None: the default
    group, or one rank when none is initialised); tier 1 of the module
    docstring. Raises where Z % D != 0 or the blocks are not circulants.
    `decode.exchange.calls` counts its K5 all-reduces; `decode.close()`
    frees K5's buffers (collective: every rank calls it)."""
    graph = (spec_or_graph if isinstance(spec_or_graph, QCGraph)
             else compile_qc_graph(spec_or_graph))
    _check_kind(kind, alpha, beta)
    D, rank = group_size_rank(group)
    if graph.Z % D:
        raise ValueError(f"Z={graph.Z} does not divide over {D} ranks")
    if graph.perm != "roll":
        raise ValueError(
            f"graph-parallel Z-sharding assumes circulant blocks; "
            f"{graph.name} lifts with perm={graph.perm!r} (xor-perm codes "
            f"are small: use the batch-parallel sweep)")
    dev = resolve_device(device)
    Z, nb, BE = graph.Z, graph.nb, graph.num_block_edges
    zs = Z // D
    lo = rank * zs
    # the plain QC flooding decoder's tables, cut to this rank's Z-slice
    groups, gathers = _plain_tables(graph, dev, lo, zs)
    rule = get_rule(kind, float(alpha), float(beta))
    exchange = _Exchange(group, dev)

    def parity_fail(total: torch.Tensor) -> torch.Tensor:
        """bool [B]: a check of any rank fails on total < 0."""
        return exchange(_parity_fail(groups, total).to(torch.int64)) > 0

    def decode(llr: torch.Tensor) -> DecodeResult:
        B = llr.shape[0]
        llr_t = llr.to(torch.float32).t().contiguous()  # [n, B]
        own = llr_t.view(nb, Z, B)[:, lo:lo + zs].reshape(nb * zs, B)
        total = llr_t
        C = torch.zeros((BE, zs, B), dtype=torch.float32, device=llr.device)

        def sweep(total, frozen):
            """One flooding iteration: (the new posteriors, the stale
            posteriors' parity failure), C updated in place."""
            fail = torch.zeros(B, dtype=torch.bool, device=llr.device)
            for d, eids, vidx in groups:
                rolled = total[vidx].view(d, -1, B)
                if frozen is not None:
                    fail |= ((rolled < 0).sum(0) % 2 != 0).any(0)
                Cold = C[eids].view(d, -1, B)
                Cnew = rule(rolled - Cold, None, 0)
                if frozen is not None:
                    Cnew = torch.where(frozen.view(1, 1, B), Cold, Cnew)
                C[eids] = Cnew.view(eids.shape + (zs, B))
            # the messages (and the flags) to every rank, values alone
            out = torch.zeros((BE * Z + 1, B), dtype=torch.float32,
                              device=llr.device)
            out[:BE * Z].view(BE, Z, B)[:, lo:lo + zs] = C
            out[BE * Z] = fail.to(torch.float32)
            full = exchange(out)
            Cflat = full[:BE * Z]
            acc = own
            for idx, has in gathers:
                acc = torch.where(has, acc + Cflat[idx], acc)
            post = torch.zeros((nb, Z, B), dtype=torch.float32,
                               device=llr.device)
            post[:, lo:lo + zs] = acc.view(nb, zs, B)
            return exchange(post).view(nb * Z, B), full[BE * Z] > 0

        if early_term:
            done = ~parity_fail(total)
            iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
            for _ in range(max_iters):
                if bool(done.all()):
                    break
                new_total, fail = sweep(total, done)
                done = done | ~fail
                total = torch.where(done.view(1, B), total, new_total)
                iters += (~done).to(torch.int32)
        else:
            for _ in range(max_iters):
                total, _ = sweep(total, None)
            iters = torch.full((B,), max_iters, dtype=torch.int32,
                               device=llr.device)
        bits = (total < 0).to(torch.uint8).t().contiguous()
        ok = ~parity_fail(total)
        return DecodeResult(bits=bits, ok=ok, iterations=iters)

    decode.exchange = exchange
    decode.close = exchange.close
    return decode


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Per-rank check shards of an expanded graph, stacked on a leading
    axis (padded rows all masked)."""

    n: int
    m: int
    num_shards: int
    dc_max: int
    cn_vn: np.ndarray    # int32 [D, m_shard, dc_max]
    cn_mask: np.ndarray  # bool [D, m_shard, dc_max]


def shard_graph(spec, num_shards: int) -> ShardedGraph:
    """Cut the expanded graph of `spec` (a CodeSpec or a CompiledGraph)
    into num_shards shards of ceil(m / num_shards) checks, in check
    order."""
    g = spec if isinstance(spec, CompiledGraph) else compile_graph(spec)
    m_shard = -(-g.m // num_shards)
    cn_vn = np.zeros((num_shards, m_shard, g.dc_max), np.int32)
    cn_mask = np.zeros((num_shards, m_shard, g.dc_max), bool)
    gv, gm = np.asarray(g.cn_vn), np.asarray(g.cn_mask)
    for d in range(num_shards):
        lo = d * m_shard
        hi = min(lo + m_shard, g.m)
        if hi > lo:
            cn_vn[d, :hi - lo] = gv[lo:hi]
            cn_mask[d, :hi - lo] = gm[lo:hi]
    return ShardedGraph(n=g.n, m=g.m, num_shards=num_shards, dc_max=g.dc_max,
                        cn_vn=cn_vn, cn_mask=cn_mask)


def _shard_tables(sg: ShardedGraph, rank: int, device):
    """(cn_vn long [m_shard, dc], mask bool [m_shard, dc, 1], adds): the
    rank's checks, and per k (idx long [n], has bool [n, 1]) the k-th of
    a variable's edges among them (in check, then slot order) as a flat
    index into the shard's messages [m_shard * dc]."""
    cn_vn, mask = sg.cn_vn[rank], sg.cn_mask[rank]
    lists = [[] for _ in range(sg.n)]
    for i, j in zip(*np.nonzero(mask)):
        lists[cn_vn[i, j]].append(i * sg.dc_max + j)
    adds = []
    for k in range(max((len(x) for x in lists), default=0)):
        idx = np.array([x[k] if k < len(x) else 0 for x in lists], np.int64)
        has = np.array([k < len(x) for x in lists])
        adds.append((torch.as_tensor(idx, device=device),
                     torch.as_tensor(has.reshape(-1, 1), device=device)))
    return (torch.as_tensor(cn_vn.astype(np.int64), device=device),
            torch.as_tensor(mask[:, :, None], device=device), adds)


def make_graph_parallel_decoder(spec, group=None, *, kind: str = "minsum",
                                alpha=1.0, beta=0.0, max_iters: int = 25,
                                device="cuda"):
    """decode(llr [B, n]) -> DecodeResult with the checks of `spec`'s
    expanded graph sharded over the ranks of `group` (tier 2 of the module
    docstring): min-sum (alpha, beta) or spa, max_iters iterations with
    per-frame freeze. `decode.exchange.calls` counts its K5 all-reduces;
    `decode.close()` frees K5's buffers (collective)."""
    if kind not in ("minsum", "spa"):
        raise KeyError(f"the check-sharded tier runs minsum or spa (the JAX "
                       f"tier's cn_minsum and cn_spa), not {kind!r}")
    _check_kind(kind, alpha, beta)
    D, rank = group_size_rank(group)
    sg = shard_graph(spec, D)
    dev = resolve_device(device)
    cn_vn, mask3, adds = _shard_tables(sg, rank, dev)
    rule = get_rule(kind, float(alpha), float(beta))
    exchange = _Exchange(group, dev)
    m_shard = cn_vn.shape[0]

    def syndrome_fail(total: torch.Tensor) -> torch.Tensor:
        at = (total < 0).to(torch.int64)[cn_vn]  # [m_shard, dc, B]
        par = torch.where(mask3, at, 0).sum(1) & 1
        return exchange((par != 0).any(0).to(torch.int64)) > 0

    def decode(llr: torch.Tensor) -> DecodeResult:
        B = llr.shape[0]
        llr_t = llr.to(torch.float32).t().contiguous()  # [n, B]
        V = torch.where(mask3, llr_t[cn_vn], 0.0)
        total = llr_t
        done = ~syndrome_fail(total)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        for _ in range(max_iters):
            C = rule(V, mask3, 1)
            Cflat = C.reshape(m_shard * sg.dc_max, B)
            partial = torch.zeros_like(llr_t)
            for idx, has in adds:
                partial = torch.where(has, partial + Cflat[idx], partial)
            new_total = llr_t + exchange(partial)
            newV = torch.where(mask3, new_total[cn_vn] - C, 0.0)
            fail = syndrome_fail(new_total)
            keep = done.view(1, B)
            V = torch.where(keep.view(1, 1, B), V, newV)
            total = torch.where(keep, total, new_total)
            iters += (~done).to(torch.int32)
            done = done | ~fail
        bits = (total < 0).to(torch.uint8).t().contiguous()
        return DecodeResult(bits=bits, ok=done, iterations=iters)

    decode.exchange = exchange
    decode.close = exchange.close
    return decode
