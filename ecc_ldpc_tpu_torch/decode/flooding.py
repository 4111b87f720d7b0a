"""Flooding BP on unstructured graphs: the plain PyTorch version and the
wrapper of its CUDA kernel (csrc/flooding.cu, K2).

`flooding_decode_plain` ports ecc_ldpc_tpu/decode/xla/flooding.py::
decode_flooding: messages in the padded check view [m, dc, B]; per
iteration every check fires (decode/cn_ops.py), then every variable sums
its check messages in slot order. Track mode (`early_term=True`) takes the
syndrome of the post-sweep posteriors, keeps the state of a frame that was
done before the sweep, and counts the sweeps of frames not yet done;
fixed mode runs exactly max_iters sweeps. It is the CPU path and the
card's yardstick.

`flooding_decode_cuda` launches the kernel that replaces
ecc_ldpc_tpu/decode/pallas/fused_mm.py::_kernel (and serves minstar too),
the same operations in the same order: bit-identical with the plain
version on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..graph.compile import CompiledGraph
from .cn_ops import CN_KINDS, get_rule
from .layered_qc import _check_llr, _device_tables, _lib, _raise_launch
from .types import DecodeResult

MAX_DC = 32     # the kernel's largest row degree
_FT = 8          # frames per block (csrc/flooding.cu's FT)
_THREADS_Y = 64  # rows of threads per block (8 frames each)
_RULE_IDS = {k: i for i, k in enumerate(CN_KINDS)}  # csrc/bp_rules.cuh
_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def check_args(graph: CompiledGraph, kind: str, alpha, beta) -> None:
    """Raise on what the flooding decoders do not take."""
    if not isinstance(graph, CompiledGraph):
        raise TypeError("flooding decoding of an unstructured code needs the "
                        "port's CompiledGraph (graph.compile.compile_graph)")
    if kind not in CN_KINDS:
        raise KeyError(f"flooding kind must be one of {CN_KINDS}, got {kind!r}")
    if np.ndim(alpha) != 0 or np.ndim(beta) != 0:
        raise ValueError("flooding decoders take scalar alpha/beta only")


def _to_tiles(llr: torch.Tensor) -> torch.Tensor:
    """llr [B, n] -> f32 [tiles, n, FT], frames innermost, the last tile
    padded with zero LLRs (its extra lanes are never written back)."""
    B, n = llr.shape
    tiles = -(-B // _FT)
    x = llr if tiles * _FT == B else torch.cat(
        [llr, llr.new_zeros((tiles * _FT - B, n))])
    return x.view(tiles, _FT, n).transpose(1, 2).contiguous()


def _from_tiles(x: torch.Tensor, B: int) -> torch.Tensor:
    """[tiles, n, FT] -> [B, n], the inverse of _to_tiles."""
    tiles, n, _ = x.shape
    return x.transpose(1, 2).reshape(tiles * _FT, n)[:B].contiguous()




def _plain_tables(graph: CompiledGraph, device):
    t = graph.to(device)
    return (t.cn_vn.long(), t.cn_mask.unsqueeze(-1), t.vn_edge.long(),
            t.vn_mask.unsqueeze(-1))


def _syndrome_fail(cn_vn, mask3, total: torch.Tensor) -> torch.Tensor:
    """bool [B]: some check of the hard decisions (total < 0) fails."""
    at_checks = (total < 0).to(torch.int32)[cn_vn]  # [m, dc, B]
    par = torch.where(mask3, at_checks, 0).sum(1) & 1
    return (par != 0).any(0)


def flooding_with_posteriors_plain(graph: CompiledGraph, llr: torch.Tensor, *,
                                   kind: str = "minsum", alpha=1.0, beta=0.0,
                                   max_iters: int = 25,
                                   early_term: bool = True):
    """(DecodeResult, posteriors f32 [B, n]) of the plain flooding decode of
    llr f32 [B, n], on llr's device."""
    check_args(graph, kind, alpha, beta)
    rule = get_rule(kind, float(alpha), float(beta))
    cn_vn, mask3, vn_edge, vn_mask = _device_tables(graph, llr.device, "plain",
                                                    _plain_tables)
    B = llr.shape[0]
    llr_t = llr.to(torch.float32).t().contiguous()  # [n, B]
    V = torch.where(mask3, llr_t[cn_vn], 0.0)
    total = llr_t

    def sweep(V):
        C = rule(V, mask3, 1)
        Cv = C.reshape(graph.m * graph.dc_max, B)[vn_edge]  # [n, dv, B]
        s = torch.zeros_like(llr_t)
        for j in range(graph.dv_max):  # the oracle's masked sum, in order
            s = s + torch.where(vn_mask[:, j], Cv[:, j], 0.0)
        new_total = llr_t + s
        return torch.where(mask3, new_total[cn_vn] - C, 0.0), new_total

    if early_term:
        done = ~_syndrome_fail(cn_vn, mask3, total)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        for _ in range(max_iters):
            if bool(done.all()):
                break
            newV, new_total = sweep(V)
            fail = _syndrome_fail(cn_vn, mask3, new_total)
            V = torch.where(done.view(1, 1, B), V, newV)
            total = torch.where(done.view(1, B), total, new_total)
            iters += (~done).to(torch.int32)
            done = done | ~fail
        ok = done
    else:
        for _ in range(max_iters):
            V, total = sweep(V)
        ok = ~_syndrome_fail(cn_vn, mask3, total)
        iters = torch.full((B,), max_iters, dtype=torch.int32,
                           device=llr.device)
    bits = (total < 0).to(torch.uint8).t().contiguous()
    return DecodeResult(bits=bits, ok=ok, iterations=iters), total.t()


def flooding_decode_plain(graph: CompiledGraph, llr: torch.Tensor, *,
                          kind: str = "minsum", alpha=1.0, beta=0.0,
                          max_iters: int = 25,
                          early_term: bool = True) -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    return flooding_with_posteriors_plain(
        graph, llr, kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
        early_term=early_term)[0]


def _kernel_tables(graph: CompiledGraph, device):
    """(cn int32 [m*dc], vn int32 [n*dv]): each check slot's variable and
    each variable slot's edge, -1 where padded."""
    cn = np.where(graph.cn_mask, graph.cn_vn, -1).astype(np.int32)
    vn = np.where(graph.vn_mask, graph.vn_edge, -1).astype(np.int32)
    return (torch.as_tensor(cn.ravel(), device=device),
            torch.as_tensor(vn.ravel(), device=device))


def _launch(graph: CompiledGraph, llr: torch.Tensor, kind: str, alpha, beta,
            max_iters: int, early_term: bool):
    """(DecodeResult, posteriors f32 [tiles, n, FT]) of one launch."""
    check_args(graph, kind, alpha, beta)
    _check_llr(llr, graph.n, max_iters, "flooding_decode_cuda",
               "flooding_decode_plain")
    if graph.dc_max > MAX_DC:
        raise ValueError(f"{graph.name}: row degree {graph.dc_max} exceeds "
                         f"the flooding kernel's limit {MAX_DC}")
    dev = llr.device
    B, n = llr.shape
    cn, vn = _device_tables(graph, dev, "kernel", _kernel_tables)
    L = _to_tiles(llr)
    tiles, _, ft = L.shape
    total = torch.empty_like(L)
    C = torch.empty((tiles, graph.m * graph.dc_max, ft), dtype=torch.float32,
                    device=dev)
    bits = torch.empty((tiles, n, ft), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib("flooding", "flooding_decode", _ARGS)
    with torch.cuda.device(dev):
        rc = lib.flooding_decode(
            L.data_ptr(), total.data_ptr(), C.data_ptr(), bits.data_ptr(),
            ok.data_ptr(), iters.data_ptr(), cn.data_ptr(), vn.data_ptr(),
            n, graph.m, graph.dc_max, graph.dv_max, B, max_iters,
            _RULE_IDS[kind], float(alpha), float(beta), int(early_term),
            _THREADS_Y, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, "flooding", rc)
    flooding_decode_cuda.launches += 1
    flooding_decode_cuda.frames += B
    res = DecodeResult(bits=_from_tiles(bits, B), ok=ok.bool(),
                       iterations=iters)
    return res, total


def flooding_decode_cuda(graph: CompiledGraph, llr: torch.Tensor, *,
                         kind: str = "minsum", alpha=1.0, beta=0.0,
                         max_iters: int = 25,
                         early_term: bool = True) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the flooding kernel on the current stream. Raises on anything the
    kernel does not take; never falls back to the plain version."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term)[0]


def flooding_with_posteriors_cuda(graph: CompiledGraph, llr: torch.Tensor, *,
                                  kind: str = "minsum", alpha=1.0, beta=0.0,
                                  max_iters: int = 25,
                                  early_term: bool = True):
    """(DecodeResult, posteriors f32 [B, n]) of one launch: for holding the
    kernel against flooding_with_posteriors_plain."""
    res, total = _launch(graph, llr, kind, alpha, beta, max_iters, early_term)
    return res, _from_tiles(total, llr.shape[0])


flooding_decode_cuda.launches = 0
flooding_decode_cuda.frames = 0


def make_flooding_decoder(graph: CompiledGraph, *, kind: str = "minsum",
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
        _device_tables(graph, dev, "kernel", _kernel_tables)
    else:
        _device_tables(graph, dev, "plain", _plain_tables)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return flooding_decode_plain(graph, llr, **kw)
        return flooding_decode_cuda(graph, llr, **kw)

    return decode
