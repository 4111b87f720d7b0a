"""Flooding BP on QC graphs: the plain PyTorch version and the wrapper of
its CUDA kernel (csrc/flooding_qc.cu, K3). Check z of a block reads
variable graph/qc.var_index(z, s, Z, perm): (z + s) % Z on circulant
graphs, z ^ s on XOR-permutation graphs, the kernel's xor instantiation.

`flooding_qc_decode_plain` ports ecc_ldpc_tpu/decode/xla/flooding_qc.py::
decode_flooding_qc for the kinds minsum, spa and minstar: every block-row
(in QCGraph.layer_order) reads the same stale posteriors, its rule runs on
the rolled extrinsics [d, Z, B] (decode/cn_ops.py), and the posteriors are
rebuilt as llr + the rolled-back messages, added in sweep order (rows in
layer_order, edges in edge-id order). Track mode takes the parity of the
PRE-sweep posteriors, and a frame that passes keeps that verified state
(the fault class that once gave spa/50 FER 1.3e-3 against 0). It is the
CPU path and the card's yardstick.

`flooding_qc_decode_cuda` launches the kernel that replaces
ecc_ldpc_tpu/decode/pallas/flooding_qc.py::_kernel (and, on XOR graphs,
ecc_ldpc_tpu/decode/pallas/layered_xor.py::_kernel's flooding mode, K4),
the same operations in the same order: bit-identical with the plain
version on the card. The kernel holds a tile's whole decoder state on chip
(csrc/state_tile.cuh) by the plan layered_qc.tile_plan(..., form=
"flooding") gives (a dvbs2/64800 frame over a cluster of 8 SMs, several
802.3an frames an SM), and reads llr [B, n] and writes [B, n] directly;
`flooding_qc_decode_cuda.last_plan` is its last launch's plan and the
clusters resident.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..graph.qc import PERMS, QCGraph, check_index, var_index
from .cn_ops import CN_KINDS, get_rule
from .layered_qc import (
    _check_llr,
    _device_tables,
    _kernel_table,
    _lib,
    _plan_launch,
    _ptr,
    _raise_launch,
)
from .types import DecodeResult

MAX_DEG = 32     # the kernel's largest row degree
_RULE_IDS = {k: i for i, k in enumerate(CN_KINDS)}  # csrc/bp_rules.cuh
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
         + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def check_args(graph: QCGraph, kind: str, alpha, beta) -> None:
    """Raise on what the flooding QC decoders do not take."""
    if not isinstance(graph, QCGraph):
        raise TypeError("QC flooding decoding needs the port's QCGraph "
                        "(graph.qc.compile_qc_graph)")
    if kind not in CN_KINDS:
        raise KeyError(f"flooding kind must be one of {CN_KINDS}, got {kind!r}")
    if np.ndim(alpha) != 0 or np.ndim(beta) != 0:
        raise ValueError("flooding decoders take scalar alpha/beta only")


def _plain_tables(graph: QCGraph, device):
    """(groups, gathers) for the plain version. groups: per run of
    equal-degree rows in layer_order, (d, eids long [d, R] — slot j's edge
    in each row —, vidx long [d*R*Z] — the variable that check z of slot j
    of row r reads, at j*R*Z + r*Z + z). gathers: per k, (idx long [n],
    has bool [n, 1]) — the k-th message each variable adds, as a flat index
    into C [BE*Z], in sweep order (rows in layer_order, edges in edge-id
    order)."""
    Z, perm = graph.Z, graph.perm
    z = np.arange(Z)
    groups = []
    for d, rows in graph.layer_groups:
        edges = [graph.layer_edges(i) for i in rows]
        eids = np.array([[e for e, _, _ in r] for r in edges]).T.copy()
        vidx = np.stack([np.concatenate([c * Z + var_index(z, s, Z, perm)
                                         for _, c, s in (r[j] for r in edges)])
                         for j in range(d)])
        groups.append((d, torch.as_tensor(eids, device=device),
                       torch.as_tensor(vidx.ravel(), device=device)))
    cols = [[] for _ in range(graph.nb)]
    for i in graph.layer_order:
        for e, c, s in graph.layer_edges(i):
            cols[c].append((e, s))
    gathers = []
    for k in range(max(len(c) for c in cols)):
        idx = np.zeros((graph.nb, Z), np.int64)
        has = np.zeros((graph.nb, Z), bool)
        for c, lst in enumerate(cols):
            if k < len(lst):
                e, s = lst[k]
                idx[c] = e * Z + check_index(z, s, Z, perm)
                has[c] = True
        gathers.append((torch.as_tensor(idx.ravel(), device=device),
                        torch.as_tensor(has.reshape(-1, 1), device=device)))
    return groups, gathers


def _parity_fail(groups, total: torch.Tensor) -> torch.Tensor:
    """bool [B]: some check of the hard decisions (total < 0) fails."""
    B = total.shape[1]
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    for d, _, vidx in groups:
        par = (total[vidx] < 0).view(d, -1, B).sum(0) % 2
        fail |= (par != 0).any(0)
    return fail


def flooding_qc_with_posteriors_plain(graph: QCGraph, llr: torch.Tensor, *,
                                      kind: str = "minsum", alpha=1.0,
                                      beta=0.0, max_iters: int = 25,
                                      early_term: bool = True):
    """(DecodeResult, posteriors f32 [B, n]) of the plain QC flooding decode
    of llr f32 [B, n], on llr's device. The rows of one degree run as one
    batch (they are independent within a sweep); each variable adds its
    messages one gather at a time, in the oracle's order."""
    check_args(graph, kind, alpha, beta)
    rule = get_rule(kind, float(alpha), float(beta))
    groups, gathers = _device_tables(graph, llr.device, "flooding_plain",
                                     _plain_tables)
    B, Z = llr.shape[0], graph.Z
    llr_t = llr.to(torch.float32).t().contiguous()  # [n, B]
    total = llr_t
    C = torch.zeros((graph.num_block_edges, Z, B), dtype=torch.float32,
                    device=llr.device)
    Cflat = C.view(-1, B)

    def sweep(total, frozen):
        """One flooding iteration from the stale `total`: C updated in place
        (frames in `frozen` keep theirs). Returns (new posteriors, parity
        failure of the stale posteriors)."""
        fail = torch.zeros(B, dtype=torch.bool, device=llr.device)
        for d, eids, vidx in groups:
            rolled = total[vidx].view(d, -1, B)
            if frozen is not None:
                fail |= ((rolled < 0).sum(0) % 2 != 0).any(0)
            Cold = C[eids].view(d, -1, B)
            Cnew = rule(rolled - Cold, None, 0)
            if frozen is not None:
                Cnew = torch.where(frozen.view(1, 1, B), Cold, Cnew)
            C[eids] = Cnew.view(eids.shape + (Z, B))
        acc = llr_t
        for idx, has in gathers:
            acc = torch.where(has, acc + Cflat[idx], acc)
        return acc, fail

    if early_term:
        done = ~_parity_fail(groups, total)
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
    ok = ~_parity_fail(groups, total)
    return DecodeResult(bits=bits, ok=ok, iterations=iters), total.t()


def flooding_qc_decode_plain(graph: QCGraph, llr: torch.Tensor, *,
                             kind: str = "minsum", alpha=1.0, beta=0.0,
                             max_iters: int = 25,
                             early_term: bool = True) -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    return flooding_qc_with_posteriors_plain(
        graph, llr, kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
        early_term=early_term)[0]


def _flooding_table(graph: QCGraph, device):
    """int32: K1a's sweep table (row pointers in layer_order, each slot's
    column and shift), then per block-column the pointer, slot and shift
    of its edges in the same sweep order (shifts read by graph.perm)."""
    cols = [[] for _ in range(graph.nb)]
    p = 0
    for i in graph.layer_order:
        for _, c, s in graph.layer_edges(i):
            cols[c].append((p, s))
            p += 1
    ptr = np.cumsum([0] + [len(c) for c in cols])
    slot = [q for c in cols for q, _ in c]
    shift = [s for c in cols for _, s in c]
    tab = np.concatenate([_kernel_table(graph, "cpu").numpy(),
                          np.asarray(list(ptr) + slot + shift, np.int32)])
    return torch.as_tensor(tab.astype(np.int32), device=device)


def _launch(graph: QCGraph, llr: torch.Tensor, kind: str, alpha, beta,
            max_iters: int, early_term: bool, with_posteriors: bool = False):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch."""
    check_args(graph, kind, alpha, beta)
    _check_llr(llr, graph.n, max_iters, "flooding_qc_decode_cuda",
               "flooding_qc_decode_plain")
    if graph.dcb_max > MAX_DEG:
        raise ValueError(f"{graph.name}: row degree {graph.dcb_max} exceeds "
                         f"the flooding kernel's limit {MAX_DEG}")
    dev, B = llr.device, llr.shape[0]
    tab = _device_tables(graph, dev, "flooding_kernel", _flooding_table)
    inst = (graph.dcb_max, _RULE_IDS[kind], int(early_term),
            int(graph.perm == "xor"))
    plan, clusters, scratch, ptrs, bits, post, ok, iters = _plan_launch(
        "flooding_qc", inst, graph, llr, kind, early_term, with_posteriors,
        "flooding")
    lib = _lib("flooding_qc", "flooding_qc_decode", _ARGS)
    with torch.cuda.device(dev):
        rc = lib.flooding_qc_decode(
            llr.data_ptr(), bits.data_ptr(), _ptr(post), ok.data_ptr(),
            iters.data_ptr(), *ptrs, tab.data_ptr(),
            graph.Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, inst[1], float(alpha), float(beta), *inst[2:],
            plan.cluster, plan.lg_cluster, plan.frames, plan.tiles,
            int(plan.llr_chip), plan.threads, plan.smem, clusters,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, "flooding_qc", rc)
    flooding_qc_decode_cuda.launches += 1
    flooding_qc_decode_cuda.frames += B
    flooding_qc_decode_cuda.launches_by_perm[graph.perm] += 1
    flooding_qc_decode_cuda.frames_by_perm[graph.perm] += B
    flooding_qc_decode_cuda.last_plan = plan, clusters
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters), post


def flooding_qc_decode_cuda(graph: QCGraph, llr: torch.Tensor, *,
                            kind: str = "minsum", alpha=1.0, beta=0.0,
                            max_iters: int = 25,
                            early_term: bool = True) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the QC flooding kernel on the current stream. Raises on anything the
    kernel does not take, a plan that does not fit included; never falls
    back to the plain version."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term)[0]


def flooding_qc_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                                     kind: str = "minsum", alpha=1.0,
                                     beta=0.0, max_iters: int = 25,
                                     early_term: bool = True):
    """(DecodeResult, posteriors f32 [B, n]) of one launch: for holding the
    kernel against flooding_qc_with_posteriors_plain."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term,
                   with_posteriors=True)


flooding_qc_decode_cuda.launches = 0
flooding_qc_decode_cuda.frames = 0  # frames decoded: the retry fallback's load
# per block permutation: the roll and xor instantiations are kernels apart
flooding_qc_decode_cuda.launches_by_perm = dict.fromkeys(PERMS, 0)
flooding_qc_decode_cuda.frames_by_perm = dict.fromkeys(PERMS, 0)
# the last launch's (TilePlan, clusters resident), for printing
flooding_qc_decode_cuda.last_plan = None


def make_flooding_qc_decoder(graph: QCGraph, *, kind: str = "minsum",
                             alpha=1.0, beta=0.0, max_iters: int = 25,
                             early_term: bool = True, device="cuda"):
    """decode(llr [B, n]) -> DecodeResult: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors; `device` (default "cuda",
    which raises when CUDA is absent) is where its tables are built."""
    check_args(graph, kind, alpha, beta)
    dev = resolve_device(device)
    kw = dict(kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term)
    if dev.type == "cuda":
        _device_tables(graph, dev, "flooding_kernel", _flooding_table)
    else:
        _device_tables(graph, dev, "flooding_plain", _plain_tables)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return flooding_qc_decode_plain(graph, llr, **kw)
        return flooding_qc_decode_cuda(graph, llr, **kw)

    return decode
