"""Post-decode bit-flip cleanup for QC graphs (port of
ecc_ldpc_tpu/decode/xla/cleanup.py).

The deep-FER tail of min-sum and BP on these codes is dominated by frames
stuck with one to three wrong bits whose neighbouring checks all fail. The
classic hardware remedy is a Gallager-B-style pass after the decoder:
flip every variable of degree >= 2 all of whose checks are unsatisfied,
`rounds` times, then report the true syndrome. A frame the decoder
validated has no failing check, so the pass leaves it as it is.

The JAX package rolls [nb, Z, B] slabs; here a circulant (or XOR) block
is index arithmetic on the layered decoder's tables
(decode/layered_qc._plain_layers: per layer the variable each check of
each slot reads), over hard decisions held as [n, B] on the bits' device.
Every sum is an integer count, so the result does not depend on the order
of the adds and the card's pass equals the CPU's bit for bit. There is no
kernel: the JAX package has no Pallas kernel for it either.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.qc import QCGraph
from .layered_qc import _device_tables, _plain_layers
from .types import DecodeResult


def _variable_degrees(graph: QCGraph, device) -> torch.Tensor:
    """int32 [n, 1]: each variable's degree, its block-column's count of
    block-edges (a column repeated in a layer counts twice, as the JAX
    package counts it)."""
    col_deg = np.bincount(np.asarray(graph.be_col), minlength=graph.nb)
    deg = np.repeat(col_deg.astype(np.int32), graph.Z)[:, None]
    return torch.as_tensor(deg, device=device)


def layer_parities(layers, x: torch.Tensor, Z: int):
    """Per layer (its tables, the parity int32 [Z, B] of each check) of
    hard decisions x uint8 [n, B]."""
    B = x.shape[1]
    for idx, eids, d in layers:
        par = x[idx].view(d, Z, B).sum(0, dtype=torch.int32) & 1
        yield (idx, eids, d), par


def syndrome_fail(layers, x: torch.Tensor, Z: int) -> torch.Tensor:
    """bool [B]: some check of hard decisions x uint8 [n, B] fails."""
    fail = torch.zeros(x.shape[1], dtype=torch.bool, device=x.device)
    for _, par in layer_parities(layers, x, Z):
        fail |= (par != 0).any(0)
    return fail


def bitflip_cleanup(graph: QCGraph, bits: torch.Tensor, rounds: int = 2):
    """bits uint8 [B, n] -> (bits uint8 [B, n], ok bool [B]) on bits'
    device: `rounds` times, flip every variable of degree >= 2 whose
    unsatisfied-check count equals its degree (a degree-1 variable, such
    as an NR extension parity, is ambiguous and never flips); ok is the
    true syndrome of the result."""
    if not isinstance(graph, QCGraph):
        raise TypeError("bitflip_cleanup needs a QCGraph (compile with "
                        "graph.qc.compile_qc_graph)")
    dev, Z = bits.device, graph.Z
    layers = _device_tables(graph, dev, "plain", _plain_layers)
    deg = _device_tables(graph, dev, "variable_degrees", _variable_degrees)
    x = bits.t().contiguous()  # [n, B]
    for _ in range(rounds):
        cnt = torch.zeros(x.shape, dtype=torch.int32, device=dev)
        for (idx, _, d), par in layer_parities(layers, x, Z):
            cnt.index_add_(0, idx, par.repeat(d, 1))
        x = x ^ ((cnt >= deg) & (deg >= 2)).to(torch.uint8)
    ok = ~syndrome_fail(layers, x, Z)
    return x.t().contiguous(), ok


def with_cleanup(decode_fn, graph: QCGraph, rounds: int = 2):
    """Wrap decode(llr) -> DecodeResult with the cleanup pass: frames the
    decoder validated pass through untouched (no check fails, so nothing
    flips), failed frames get the repair; iterations are the decoder's."""

    def decode(llr: torch.Tensor) -> DecodeResult:
        res = decode_fn(llr)
        bits, ok = bitflip_cleanup(graph, res.bits, rounds=rounds)
        return DecodeResult(bits=bits, ok=ok, iterations=res.iterations)

    return decode
