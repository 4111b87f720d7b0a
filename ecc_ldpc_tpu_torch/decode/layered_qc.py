"""Layered normalized/offset min-sum on circulant QC graphs: the plain
PyTorch version and the wrapper of its CUDA kernel (csrc/layered_qc.cu).

`layered_decode_plain` ports ecc_ldpc_tpu/decode/xla/layered.py::
decode_layered for the min-sum rule with signbit sign semantics on graphs
with no duplicate column inside a layer (every DVB-S2, 802.11n, WiMAX and
5G NR table): fixed-iteration mode (`early_term=False`, exactly max_iters
sweeps) and track mode (per-frame freeze on the exact "every layer parity
passed and no posterior changed sign" rule), with scalar or per-iteration
alpha/beta. It is the CPU path and the card's yardstick.

`layered_decode_cuda` launches the kernel that replaces
ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel. Both give bit-identical
bits, ok and iterations in f32: the same operations in the same order, no
fused multiply-add, no reduction across frames.

Both visit block-rows in QCGraph.layer_order and each row's edges in
layer_edges order, as the JAX package does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..graph.qc import QCGraph
from .types import DecodeResult

_MAG_CAP = 1e12
MAX_DEG = 32    # the kernel's largest row degree (csrc/layered_qc.cu)
_FT = 8         # frames per CUDA block, the kernel's FT
_THREADS = 512  # threads per CUDA block at most (__launch_bounds__)


def _schedule(alpha, beta, max_iters: int):
    """(alphas f32 [T], betas f32 [T], per_iter): alpha_t/beta_t of every
    iteration, and whether either was given per iteration."""
    per_iter = np.ndim(alpha) != 0 or np.ndim(beta) != 0
    alphas = np.broadcast_to(np.asarray(alpha, np.float32), (max_iters,))
    betas = np.broadcast_to(np.asarray(beta, np.float32), (max_iters,))
    return alphas, betas, per_iter


def check_graph(graph: QCGraph) -> None:
    """Raise on graphs this module does not decode."""
    if not isinstance(graph, QCGraph):
        raise TypeError("layered decoding needs the port's QCGraph "
                        "(graph.qc.compile_qc_graph)")
    if not graph.intra_layer_dup_free:
        raise NotImplementedError(
            f"{graph.name}: a layer touches one block-column twice; the "
            f"accumulate form waits for ROADMAP.md Queue 2 K1b")
    if graph.dcb_max > MAX_DEG:
        raise ValueError(f"{graph.name}: row degree {graph.dcb_max} exceeds "
                         f"the layered kernel's limit {MAX_DEG}")


def _device_tables(graph: QCGraph, device: torch.device, kind: str, build):
    """Tables of `kind` for `device`, built once per graph."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (kind, str(device))
    if key not in graph.device_cache:
        graph.device_cache[key] = build(graph, device)
    return graph.device_cache[key]


def _plain_layers(graph: QCGraph, device):
    """Per layer in layer_order: (var_idx long [d*Z], edge ids long [d], d).
    var_idx[j*Z + z] is the variable that check z of slot j reads."""
    Z = graph.Z
    z = np.arange(Z)
    layers = []
    for i in graph.layer_order:
        edges = graph.layer_edges(i)
        idx = np.concatenate([col * Z + (z + s) % Z for _, col, s in edges])
        eids = np.asarray([e for e, _, _ in edges], np.int64)
        layers.append((torch.as_tensor(idx, dtype=torch.long, device=device),
                       torch.as_tensor(eids, device=device), len(edges)))
    return layers


def _cn_minsum(V: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Leave-one-out two-min check update over axis 0 of V [d, Z, B], sign
    bits XOR-ed (-0.0 is negative), magnitude max(a*min(m, cap) - b, 0)."""
    negb = torch.signbit(V)
    neg_out = (negb.sum(0, keepdim=True) % 2 == 1) ^ negb
    A = V.abs()
    min1 = A.amin(0, keepdim=True)
    is_min = A == min1
    count_min = is_min.sum(0, keepdim=True)
    min2 = torch.where(is_min, torch.inf, A).amin(0, keepdim=True)
    mag = torch.where(is_min & (count_min == 1), min2, min1)
    mag = torch.clamp_max(mag, _MAG_CAP)
    mag = torch.clamp_min(a * mag - b, 0.0)
    return torch.where(neg_out, -mag, mag)


def _syndrome_fail_plain(layers, total: torch.Tensor, Z: int) -> torch.Tensor:
    """bool [B]: some check of the hard decisions (x < 0) fails."""
    B = total.shape[1]
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    for idx, _, d in layers:
        par = (total[idx] < 0).view(d, Z, B).sum(0) % 2
        fail |= (par != 0).any(0)
    return fail


def _sweep_plain(layers, total, C, Z, a, b, frozen):
    """One layered iteration, in place on total [n, B] and C [BE, Z, B].
    With `frozen` (bool [B], track mode) frozen frames keep their state and
    the on-the-fly fail flag (layer parity or a sign flip) is returned."""
    B = total.shape[1]
    track = frozen is not None
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    if track:
        keep = frozen.view(1, 1, B)
    for idx, eids, d in layers:
        rolled = total[idx].view(d, Z, B)
        if track:
            par = (rolled < 0).sum(0) % 2
            fail |= (par != 0).any(0)
        Cold = C[eids]
        V = rolled - Cold
        Cnew = _cn_minsum(V, a, b)
        if track:
            Cnew = torch.where(keep, Cold, Cnew)
            new = torch.where(keep, rolled, V + Cnew)
            fail |= (torch.signbit(new) != torch.signbit(rolled)).any(0).any(0)
        else:
            new = V + Cnew
        total[idx] = new.view(d * Z, B)
        C[eids] = Cnew
    return fail


def layered_decode_plain(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                         beta=0.0, max_iters: int = 25,
                         early_term: bool = True) -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    check_graph(graph)
    B = llr.shape[0]
    Z = graph.Z
    alphas, betas, _ = _schedule(alpha, beta, max_iters)
    layers = _device_tables(graph, llr.device, "plain", _plain_layers)
    total = llr.to(torch.float32).t().contiguous()  # [n, B]
    C = torch.zeros((graph.num_block_edges, Z, B), dtype=torch.float32,
                    device=llr.device)
    if early_term:
        done = ~_syndrome_fail_plain(layers, total, Z)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        for t in range(max_iters):
            if bool(done.all()):
                break
            fail = _sweep_plain(layers, total, C, Z, float(alphas[t]),
                                float(betas[t]), done)
            iters += (~done).to(torch.int32)
            done = done | ~fail
    else:
        for t in range(max_iters):
            _sweep_plain(layers, total, C, Z, float(alphas[t]),
                         float(betas[t]), None)
        iters = torch.full((B,), max_iters, dtype=torch.int32,
                           device=llr.device)
    bits = (total < 0).to(torch.uint8).t().contiguous()
    ok = ~_syndrome_fail_plain(layers, total, Z)
    return DecodeResult(bits=bits, ok=ok, iterations=iters)


def _kernel_table(graph: QCGraph, device):
    """int32 [mb+1 + 2*BE]: layer_ptr, then the column and shift of every
    sweep slot (layer_order, then layer_edges order)."""
    ptr, col, shift = [0], [], []
    for i in graph.layer_order:
        for _, c, s in graph.layer_edges(i):
            col.append(c)
            shift.append(s)
        ptr.append(len(col))
    tab = np.asarray(ptr + col + shift, np.int32)
    return torch.as_tensor(tab, device=device)


def threads_z(Z: int) -> int:
    """Threads along z per block: all Z checks when they fit, else the
    largest divisor of Z that fits the block (no idle z-round), unless
    that wastes over half the block."""
    cap = _THREADS // _FT
    if Z <= cap:
        return Z
    best = max(d for d in range(1, cap + 1) if Z % d == 0)
    return best if 2 * best > cap else cap


def _lib():
    from .. import _build

    lib = _build.load("layered_qc")
    fn = lib.layered_qc_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.layered_qc_error_string.argtypes = [ctypes.c_int]
        lib.layered_qc_error_string.restype = ctypes.c_char_p
    return lib


def layered_decode_cuda(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                        beta=0.0, max_iters: int = 25,
                        early_term: bool = True) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the layered kernel on the current stream. Raises on anything the
    kernel does not take; never falls back to the plain version."""
    if llr.device.type != "cuda":
        raise ValueError(
            f"layered_decode_cuda needs a CUDA tensor, got {llr.device}; "
            f"the plain version is layered_decode_plain")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != graph.n or llr.shape[0] < 1:
        raise ValueError(f"llr must be [B, {graph.n}], got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    check_graph(graph)
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")
    dev = llr.device
    B, Z, n = llr.shape[0], graph.Z, graph.n
    tiles = -(-B // _FT)
    alphas, betas, per_iter = _schedule(alpha, beta, max_iters)
    min_deg = min(d for d, _ in graph.layer_groups)
    fast_mag = not per_iter and float(betas[0]) == 0.0 and not early_term \
        and min_deg >= 2
    tab = _device_tables(graph, dev, "kernel", _kernel_table)
    ab = (torch.as_tensor(np.stack([alphas, betas]), device=dev)
          if per_iter else None)
    x = llr if tiles * _FT == B else torch.cat(
        [llr, llr.new_zeros((tiles * _FT - B, n))])
    # [tiles, n, FT]: in LLRs, out posteriors; each tile contiguous
    total = x.view(tiles, _FT, n).transpose(1, 2).contiguous()
    # per check: mag1, mag2, sign bits, min slot (csrc/layered_qc.cu)
    cs = torch.empty((tiles, graph.m * 4, _FT), dtype=torch.int32,
                     device=dev)
    bits = torch.empty((tiles, n, _FT), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.layered_qc_decode(
            total.data_ptr(), cs.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            iters.data_ptr(), tab.data_ptr(),
            None if ab is None else ab.data_ptr(),
            Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, float(alphas[0]), float(betas[0]),
            int(early_term), int(fast_mag), threads_z(Z),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"layered_qc kernel launch failed: cudaError {rc} "
            f"({lib.layered_qc_error_string(rc).decode()})")
    layered_decode_cuda.launches += 1
    bits = bits.transpose(1, 2).reshape(tiles * _FT, n)[:B].contiguous()
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters)


layered_decode_cuda.launches = 0


def make_layered_decoder(graph: QCGraph, *, alpha=1.0, beta=0.0,
                         max_iters: int = 25, early_term: bool = True,
                         device="cuda"):
    """decode(llr [B, n]) -> DecodeResult. The decoder runs the plain
    version on CPU tensors and the CUDA kernel on CUDA tensors; `device`
    (default "cuda", which raises when CUDA is absent) is where its tables
    are built up front."""
    check_graph(graph)
    dev = resolve_device(device)
    kw = dict(alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term)
    if dev.type == "cuda":
        _device_tables(graph, dev, "kernel", _kernel_table)
    else:
        _device_tables(graph, dev, "plain", _plain_layers)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return layered_decode_plain(graph, llr, **kw)
        return layered_decode_cuda(graph, llr, **kw)

    return decode
