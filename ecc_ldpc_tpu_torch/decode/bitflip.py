"""Hard-decision bit-flipping decoders: majority BF and GDBF (port of
ecc_ldpc_tpu/decode/xla/bitflip.py).

  'bitflip' (variant "maj") — parallel majority bit flipping (Gallager's
    BF): each iteration flips every variable whose unsatisfied-check count
    exceeds half its degree (2 * cnt > deg). It reads only the LLR signs.
  'gdbf' — multi-bit gradient-descent bit flipping (Wadayama et al.): the
    inversion metric E_k = w * x~_k * y_k + sum over k's checks of s~_i
    (x~, s~ bipolar: 1 - 2x and 1 - 2 * parity) with the per-frame
    channel weight w = 1 / max(mean |llr|, 1e-9); every variable with
    E_k < theta flips.

Both forms keep the JAX package's iteration semantics: with early
termination a frame whose hard decisions satisfy H is frozen (from the
start, and after each iteration), the loop runs while some frame is live
and fewer than max_iters iterations have run, and ok is the frozen flag;
without it the loop runs max_iters times from no frame frozen, a frame
still freezes once its syndrome is satisfied, and ok is the true syndrome.

The QC form works on the layered decoder's tables (a circulant or XOR
block is index arithmetic: decode/layered_qc._plain_layers); GDBF adds
each block-edge's check term to its variables in the JAX package's order
(layers in layer_order, slots in layer_edges order), so its float sums
are the JAX package's. The unstructured form works on the CompiledGraph's
edges (check slot -> variable), its check sums by index_add_; the JAX
package's dense-operator size gate there (the TPU's incidence-matmul
memory) does not apply. Majority flipping counts integers, exact in any
order, so the card equals the CPU and the JAX package bit for bit. GDBF's
w is a mean whose summation order differs between backends by ulps, so a
frame whose metric comes within that of theta may flip differently; the
decoders can report each frame's closest approach (`margin`). There is no
kernel: the JAX package has no Pallas kernel for either.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..graph.qc import QCGraph
from .cleanup import _variable_degrees, layer_parities
from .layered_qc import _device_tables, _plain_layers
from .types import DecodeResult

VARIANTS = ("maj", "gdbf")


def _qc_form(graph: QCGraph, dev):
    """(parities(x) -> [per layer parity int32 [Z, B]],
    add_to_variables(out [n, B], [per layer check values [Z, B]]) -> out
    with each block-edge's values added to its variables in the JAX
    package's edge order, degrees int32 [n, 1]) of a QCGraph."""
    layers = _device_tables(graph, dev, "plain", _plain_layers)
    deg = _device_tables(graph, dev, "variable_degrees", _variable_degrees)
    Z = graph.Z

    def parities(x):
        return [par for _, par in layer_parities(layers, x, Z)]

    def add_to_variables(out, per_layer):
        for (idx, _, d), v in zip(layers, per_layer):
            for j in range(d):
                out.index_add_(0, idx[j * Z:(j + 1) * Z], v)
        return out

    return parities, add_to_variables, deg


def _edge_tables(graph, device):
    """(check of each edge long [E], variable of each edge long [E],
    degrees int32 [n, 1]) of a CompiledGraph, edges in check-slot order."""
    mask = np.asarray(graph.cn_mask, bool)
    checks, slots = np.nonzero(mask)
    var = np.asarray(graph.cn_vn)[checks, slots]
    deg = np.bincount(var, minlength=graph.n).astype(np.int32)[:, None]
    return (torch.as_tensor(checks, dtype=torch.long, device=device),
            torch.as_tensor(var, dtype=torch.long, device=device),
            torch.as_tensor(deg, device=device))


def _edge_form(graph, dev):
    """The same three functions as _qc_form, over a CompiledGraph's
    edges: one parity slab [m, B], and each variable's check sum formed
    alone by index_add_ (integer-valued, so exact in any order) and then
    added once, as the JAX package adds its H^T product."""
    check, var, deg = _device_tables(graph, dev, "bitflip_edges",
                                     _edge_tables)
    m = graph.m

    def parities(x):
        par = torch.zeros((m, x.shape[1]), dtype=torch.int32, device=x.device)
        par.index_add_(0, check, x[var].to(torch.int32))
        return [par & 1]

    def add_to_variables(out, per_check):
        (v,) = per_check
        return out + torch.zeros_like(out).index_add_(0, var, v[check])

    return parities, add_to_variables, deg


def decode_bitflip(graph, llr: torch.Tensor, *, variant: str = "maj",
                   theta: float = 0.0, max_iters: int = 50,
                   early_term: bool = True, margin: bool = False):
    """llr f32 [B, n] -> DecodeResult on llr's device (QCGraph: the QC
    form; CompiledGraph: the edge form). With `margin`, (DecodeResult,
    f32 [B]): for GDBF each frame's smallest |E - theta| over the
    iterations it ran (inf for majority flipping and for frames that ran
    none)."""
    if variant not in VARIANTS:
        raise KeyError(f"unknown bit-flip variant {variant!r}")
    dev, B = llr.device, llr.shape[0]
    form = _qc_form if isinstance(graph, QCGraph) else _edge_form
    parities, add_to_variables, deg = form(graph, dev)
    y = llr.to(torch.float32).t().contiguous()  # [n, B]
    x = (y < 0).to(torch.uint8)
    closest = torch.full((B,), float("inf"), device=dev)

    def fails(x):
        fail = torch.zeros(B, dtype=torch.bool, device=dev)
        for par in parities(x):
            fail |= (par != 0).any(0)
        return fail

    if variant == "gdbf":
        # per-frame channel weight: the metric in unit-energy BPSK units
        w = 1.0 / torch.clamp_min(y.abs().mean(0), 1e-9)
        wy = w * y

    def sweep(x, live):
        par = parities(x)
        if variant == "maj":
            cnt = add_to_variables(
                torch.zeros(x.shape, dtype=torch.int32, device=dev), par)
            flips = 2 * cnt > deg
        else:
            E = (1.0 - 2.0 * x.to(torch.float32)) * wy
            E = add_to_variables(E, [(1 - 2 * p).to(torch.float32)
                                     for p in par])
            flips = E < theta
            if margin:
                gap = (E - theta).abs().amin(0)
                closest.copy_(torch.where(live, torch.minimum(closest, gap),
                                          closest))
        return x ^ flips.to(torch.uint8)

    done = ~fails(x) if early_term else torch.zeros(B, dtype=torch.bool,
                                                    device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        if early_term and bool(done.all()):
            break
        x = torch.where(done, x, sweep(x, ~done))
        iters += (~done).to(torch.int32)
        done = done | ~fails(x)
    ok = done if early_term else ~fails(x)
    res = DecodeResult(bits=x.t().contiguous(), ok=ok, iterations=iters)
    return (res, closest) if margin else res


def make_bitflip_decoder(graph, *, variant: str = "maj", theta: float = 0.0,
                         max_iters: int = 50, early_term: bool = True,
                         device="cuda"):
    """decode(llr [B, n]) -> DecodeResult by majority flipping ("maj") or
    GDBF on either graph form, on the LLRs' device. `device` (default
    "cuda", which raises when CUDA is absent) is where its tables are
    built up front."""
    if variant not in VARIANTS:
        raise KeyError(f"unknown bit-flip variant {variant!r}")
    dev = resolve_device(device)
    (_qc_form if isinstance(graph, QCGraph) else _edge_form)(graph, dev)

    def decode(llr: torch.Tensor) -> DecodeResult:
        return decode_bitflip(graph, llr, variant=variant, theta=theta,
                              max_iters=max_iters, early_term=early_term)

    return decode
