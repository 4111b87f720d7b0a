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

Precision (decode/quant.py), the TPU kernels' roundings under `/pallas`:
("bf16",) is K3's bf16 storage (ecc_ldpc_tpu/decode/pallas/flooding_qc.py
with msg, total, llr and acc dtypes bf16, which loop.py:69-78 picks where
the f32 state does not fit VMEM: tpu_flooding_precision): the LLRs, every
stored message and every partial posterior sum (acc = bf16(acc + Cq),
edge by edge in the sweep order, :201-206) rounded; ("bf16-perm",) is
K4's flooding mode (layered_xor.py:195-254, a permutation one bf16 matmul
pass): every posterior a check reads, and every message a variable adds,
rounded, the sums and the messages kept f32. Both read the stale
posteriors rounded, so the parity and the syndrome see bf16(x) < 0.

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

import collections
import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..graph.qc import PERMS, QCGraph, check_index, var_index
from .cn_ops import CN_KINDS, get_rule
from .layered_qc import (
    FLOODING_MAX_DEG,
    _check_llr,
    _device_tables,
    _kernel_table,
    _lib,
    _plan_launch,
    _ptr,
    _raise_launch,
    wide_scratch,
    xor_kernel_fits,
)
from .quant import BF16, PERM, check_precision, describe, round_bf16
from .types import DecodeResult

# the kernel's widest register build (csrc/flooding_qc.cu); wider rows take
# its wide build
MAX_DEG = FLOODING_MAX_DEG
_RULE_IDS = {k: i for i, k in enumerate(CN_KINDS)}  # csrc/bp_rules.cuh
_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
         + [ctypes.c_int] * 11 + [ctypes.c_void_p])
# the kernel's precision argument (csrc/flooding_qc.cu): 0 f32 (the f32
# library), 1 bf16 storage, 3 bf16 permutations (the precision library)
_PREC_IDS = {None: 0, BF16: 1, PERM: 3}


def _identity(x):
    return x


def check_args(graph: QCGraph, kind: str, alpha, beta,
               precision=None) -> None:
    """Raise on what the flooding QC decoders do not take: a precision
    other than f32 on a xor graph is min-sum's only (K4's)."""
    if not isinstance(graph, QCGraph):
        raise TypeError("QC flooding decoding needs the port's QCGraph "
                        "(graph.qc.compile_qc_graph)")
    if kind not in CN_KINDS:
        raise KeyError(f"flooding kind must be one of {CN_KINDS}, got {kind!r}")
    if np.ndim(alpha) != 0 or np.ndim(beta) != 0:
        raise ValueError("flooding decoders take scalar alpha/beta only")
    if check_precision(precision) not in (None, BF16, PERM):
        raise ValueError(f"the QC flooding decoders store f32, bf16 or "
                         f"round at the permutations, not {precision!r}")
    if precision is not None and graph.perm == "xor" and kind != "minsum":
        raise ValueError(f"{graph.name}: the bf16 roundings on a xor graph "
                         f"are the TPU's XOR min-sum kernel's, not {kind!r}'s")


def tpu_flooding_precision(graph: QCGraph, kind: str = "minsum"):
    """The precision of the JAX package's Pallas flooding decoder for a QC
    graph on the TPU (`/pallas`; decode/pallas/loop.py:25-78 there): on a
    xor graph its XOR kernel's bf16 permutations where that kernel takes
    it (min-sum, layered_qc.xor_kernel_fits), on a circulant graph K3's
    bf16 storage where its state fits VMEM at 2 bytes and not at 4
    (supports_tpu). The JAX package refuses the rest (Z % 8 != 0, Z * R >
    1024, the 84 MiB cap, xor graphs with spa or minstar); the port
    decodes them in f32."""
    if graph.perm == "xor":
        return PERM if xor_kernel_fits(graph, kind, "flooding") else None
    if supports_tpu(graph, 2, kind) and not supports_tpu(graph, 4, kind):
        return BF16
    return None


def supports_tpu(graph: QCGraph, nbytes: int = 2,
                 kind: str = "minsum") -> bool:
    """The JAX package's ecc_ldpc_tpu/decode/pallas/flooding_qc.py
    `supports(graph, batch_tile=128, msg_bytes=total_bytes=acc_bytes=
    llr_bytes=nbytes, kind)`: a circulant graph with Z % 8 == 0, Z <= 1024
    (its padded sublane dim) and at most 84 MiB of state a 128-frame
    tile."""
    if graph.perm != "roll":
        return False
    if graph.Z * (8 // int(np.gcd(graph.Z, 8))) > 1024:
        return False
    state = graph.Z * 128 * (
        nbytes * graph.num_block_edges + 3 * nbytes * graph.nb + graph.nb
        + (4 * graph.dcb_max if kind == "minstar" else 0))
    return graph.Z % 8 == 0 and state <= 84 * 1024 * 1024


def _plain_tables(graph: QCGraph, device, lo: int = 0, zs: int = None):
    """(groups, gathers) for the plain version, of the checks and
    variables z in [lo, lo + zs) of every block (all Z by default; a rank's
    Z-slice in dist/graph_parallel.py). groups: per run of equal-degree
    rows in layer_order, (d, eids long [d, R] — slot j's edge in each row
    —, vidx long [d*R*zs] — the variable that check z of slot j of row r
    reads, at j*R*zs + r*zs + z - lo). gathers: per k, (idx long [nb*zs],
    has bool [nb*zs, 1]) — the k-th message each variable adds, as a flat
    index into C [BE*Z], in sweep order (rows in layer_order, edges in
    edge-id order)."""
    Z, perm = graph.Z, graph.perm
    zs = Z if zs is None else zs
    z = np.arange(lo, lo + zs)
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
        idx = np.zeros((graph.nb, zs), np.int64)
        has = np.zeros((graph.nb, zs), bool)
        for c, lst in enumerate(cols):
            if k < len(lst):
                e, s = lst[k]
                idx[c] = e * Z + check_index(z, s, Z, perm)
                has[c] = True
        gathers.append((torch.as_tensor(idx.ravel(), device=device),
                        torch.as_tensor(has.reshape(-1, 1), device=device)))
    return groups, gathers


def _parity_fail(groups, total: torch.Tensor, rd=_identity) -> torch.Tensor:
    """bool [B]: some check of the hard decisions (rd(total) < 0) fails."""
    B = total.shape[1]
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    for d, _, vidx in groups:
        par = (rd(total[vidx]) < 0).view(d, -1, B).sum(0) % 2
        fail |= (par != 0).any(0)
    return fail


def flooding_qc_with_posteriors_plain(graph: QCGraph, llr: torch.Tensor, *,
                                      kind: str = "minsum", alpha=1.0,
                                      beta=0.0, max_iters: int = 25,
                                      early_term: bool = True,
                                      precision=None):
    """(DecodeResult, posteriors f32 [B, n]) of the plain QC flooding decode
    of llr f32 [B, n], on llr's device. The rows of one degree run as one
    batch (they are independent within a sweep); each variable adds its
    messages one gather at a time, in the oracle's order. `precision`:
    None, ("bf16",) or ("bf16-perm",) (the module docstring)."""
    precision = check_precision(precision)
    check_args(graph, kind, alpha, beta, precision)
    rule = get_rule(kind, float(alpha), float(beta))
    groups, gathers = _device_tables(graph, llr.device, "flooding_plain",
                                     _plain_tables)
    B, Z = llr.shape[0], graph.Z
    # rd: a permutation's operand (both); st: what bf16 storage stores
    rd = _identity if precision is None else round_bf16
    st = round_bf16 if precision == BF16 else _identity
    llr_t = st(llr.to(torch.float32).t().contiguous())  # [n, B]
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
            rolled = rd(total[vidx]).view(d, -1, B)
            if frozen is not None:
                fail |= ((rolled < 0).sum(0) % 2 != 0).any(0)
            Cold = C[eids].view(d, -1, B)
            Cnew = rule(rolled - Cold, None, 0)
            if frozen is not None:
                Cnew = torch.where(frozen.view(1, 1, B), Cold, Cnew)
            C[eids] = st(Cnew).view(eids.shape + (Z, B))
        acc = llr_t
        for idx, has in gathers:
            acc = torch.where(has, st(acc + rd(Cflat[idx])), acc)
        return acc, fail

    if early_term:
        done = ~_parity_fail(groups, total, rd)
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
    ok = ~_parity_fail(groups, total, rd)
    return DecodeResult(bits=bits, ok=ok, iterations=iters), total.t()


def flooding_qc_decode_plain(graph: QCGraph, llr: torch.Tensor, *,
                             kind: str = "minsum", alpha=1.0, beta=0.0,
                             max_iters: int = 25, early_term: bool = True,
                             precision=None) -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    return flooding_qc_with_posteriors_plain(
        graph, llr, kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
        early_term=early_term, precision=precision)[0]


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
            max_iters: int, early_term: bool, with_posteriors: bool = False,
            precision=None):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch."""
    precision = check_precision(precision)
    check_args(graph, kind, alpha, beta, precision)
    _check_llr(llr, graph.n, max_iters, "flooding_qc_decode_cuda",
               "flooding_qc_decode_plain")
    dev, B = llr.device, llr.shape[0]
    tab = _device_tables(graph, dev, "flooding_kernel", _flooding_table)
    inst = (graph.dcb_max, _RULE_IDS[kind], int(early_term),
            int(graph.perm == "xor"))
    name = "flooding_qc" if precision is None else "flooding_qc_prec"
    plan, clusters, scratch, ptrs, bits, post, ok, iters = _plan_launch(
        name, inst, graph, llr, kind, early_term, with_posteriors,
        "flooding")
    wide = wide_scratch(graph.dcb_max, kind,
                        clusters * plan.cluster * plan.threads, dev)
    lib = _lib(name, "flooding_qc_decode", _ARGS)
    with torch.cuda.device(dev):
        rc = lib.flooding_qc_decode(
            llr.data_ptr(), bits.data_ptr(), _ptr(post), ok.data_ptr(),
            iters.data_ptr(), *ptrs, tab.data_ptr(), _ptr(wide),
            graph.Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, inst[1], float(alpha), float(beta), *inst[2:],
            plan.cluster, plan.lg_cluster, plan.frames, plan.tiles,
            int(plan.llr_chip), plan.threads, plan.smem, clusters,
            _PREC_IDS[precision], torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, name, rc)
    flooding_qc_decode_cuda.launches += 1
    flooding_qc_decode_cuda.frames += B
    flooding_qc_decode_cuda.launches_by_perm[graph.perm] += 1
    flooding_qc_decode_cuda.frames_by_perm[graph.perm] += B
    flooding_qc_decode_cuda.launches_by_precision[describe(precision)] += 1
    flooding_qc_decode_cuda.last_plan = plan, clusters
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters), post


def flooding_qc_decode_cuda(graph: QCGraph, llr: torch.Tensor, *,
                            kind: str = "minsum", alpha=1.0, beta=0.0,
                            max_iters: int = 25, early_term: bool = True,
                            precision=None) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the QC flooding kernel on the current stream (the f32 library, or for
    `precision` ("bf16",) or ("bf16-perm",) the precision library,
    csrc/flooding_qc.cu built with -DLAYERED_PREC=1). Raises on anything
    the kernel does not take, a plan that does not fit included; never
    falls back to the plain version."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term,
                   precision=precision)[0]


def flooding_qc_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                                     kind: str = "minsum", alpha=1.0,
                                     beta=0.0, max_iters: int = 25,
                                     early_term: bool = True,
                                     precision=None):
    """(DecodeResult, posteriors f32 [B, n]) of one launch: for holding the
    kernel against flooding_qc_with_posteriors_plain."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term,
                   with_posteriors=True, precision=precision)


flooding_qc_decode_cuda.launches = 0
flooding_qc_decode_cuda.frames = 0  # frames decoded: the retry fallback's load
# per block permutation: the roll and xor instantiations are kernels apart
flooding_qc_decode_cuda.launches_by_perm = dict.fromkeys(PERMS, 0)
flooding_qc_decode_cuda.frames_by_perm = dict.fromkeys(PERMS, 0)
# per precision ("f32", "bf16", "bf16-perm"): the libraries are apart
flooding_qc_decode_cuda.launches_by_precision = collections.Counter()
# the last launch's (TilePlan, clusters resident), for printing
flooding_qc_decode_cuda.last_plan = None


def make_flooding_qc_decoder(graph: QCGraph, *, kind: str = "minsum",
                             alpha=1.0, beta=0.0, max_iters: int = 25,
                             early_term: bool = True, device="cuda",
                             precision=None):
    """decode(llr [B, n]) -> DecodeResult: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors; `device` (default "cuda",
    which raises when CUDA is absent) is where its tables are built.
    `precision`: None, ("bf16",) or ("bf16-perm",) (the module
    docstring; tpu_flooding_precision gives the TPU's)."""
    precision = check_precision(precision)
    check_args(graph, kind, alpha, beta, precision)
    dev = resolve_device(device)
    kw = dict(kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term, precision=precision)
    if dev.type == "cuda":
        _device_tables(graph, dev, "flooding_kernel", _flooding_table)
    else:
        _device_tables(graph, dev, "flooding_plain", _plain_tables)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return flooding_qc_decode_plain(graph, llr, **kw)
        return flooding_qc_decode_cuda(graph, llr, **kw)

    return decode
