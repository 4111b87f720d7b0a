"""Plain layered decoding in float32: the yardstick the decoders under test
are held to, bit for bit.

A frozen copy of the layered decoder's definition (check rules, schedule,
stop rule and retry wrapper) in plain PyTorch, working only from a frozen
H table (reference/qc.py). It covers the decoder specs the benchmark's
traffic uses:

  layered/norm:ALPHA/T[/noet]   normalised min-sum, T iterations; with
                                /noet exactly T sweeps, else each frame
                                stops on the exact rule (every layer's
                                parity held and no posterior changed sign
                                in a sweep)
  layered/spa/T[/noet]          sum-product (tanh rule)
  PRIMARY;retry=FALLBACK        the frames PRIMARY leaves with a failed
                                syndrome are decoded again from their
                                LLRs by FALLBACK, which gives their bits
                                and ok flag; their iterations are the sum

Each layer visits the block rows stably sorted by degree, reads its
posteriors, subtracts the stored check messages, applies the rule over the
row, and writes V + Cnew back (no block column repeats inside a row in the
codes this covers; that is checked). Signs follow the f32 sign bits, so
-0.0 counts as negative. Frames are independent: a track-mode decode works
only on the frames still running, and a batch may be decoded in blocks of
frames, without changing any frame's arithmetic.

`precision="bf16"` is the control: every stored posterior and message (and
the loaded LLRs) rounded to bfloat16, the arithmetic between in float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .qc import QCTable

_MAG_CAP = 1e12
_SPA_TANH_CLIP = 1.0 - 1e-7
_SIGN = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class Spec:
    rule: str           # "minsum" or "spa"
    alpha: float
    iters: int
    early_term: bool
    fallback: "Spec | None" = None


def parse(spec: str) -> Spec:
    """The reference's reading of a decoder spec (module docstring)."""
    if ";retry=" in spec:
        primary, fallback = spec.split(";retry=", 1)
        return dataclasses.replace(parse(primary), fallback=parse(fallback))
    parts = spec.split("/")
    if parts[0] != "layered":
        raise ValueError(f"the reference decodes layered specs, not {spec!r}")
    rule, alpha, iters, early_term = "minsum", 1.0, None, True
    for p in parts[1:]:
        if p.startswith("norm:"):
            alpha = float(p[5:])
        elif p == "spa":
            rule = "spa"
        elif p == "noet":
            early_term = False
        elif p.isdigit():
            iters = int(p)
        else:
            raise ValueError(f"the reference has no {p!r} (in {spec!r})")
    if iters is None:
        raise ValueError(f"{spec!r}: no iteration count")
    return Spec(rule, alpha, iters, early_term)


def _store(precision: str):
    if precision == "f32":
        return lambda x: x
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision must be f32 or bf16, got {precision!r}")


def _layers(table: QCTable, device) -> list:
    out = []
    for _, edges in table.rows():
        cols = [c for _, c, _ in edges]
        if len(set(cols)) != len(cols):
            raise ValueError("a block row repeats a block column: the "
                             "reference has only the set form")
        eids = torch.as_tensor([e for e, _, _ in edges], device=device)
        out.append((table.var_index(edges, device), eids, len(edges)))
    return out


def _minsum(V: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Leave-one-out two-min rule over axis 0 of V [d, Z, B]: magnitude
    max(a * min(m, cap) - b, 0), sign the XOR of the other sign bits."""
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


def _spa(V: torch.Tensor) -> torch.Tensor:
    """Sum-product over axis 0 of V [d, Z, B]: log|tanh| summed in slot
    order, magnitude 2 atanh(t) = log1p(t) - log1p(-t), and the XOR of the
    other slots' sign bits OR-ed onto it."""
    lt = torch.log(torch.tanh(torch.clamp(V.abs(), 1e-10, 40.0) * 0.5))
    acc = lt[0]
    for j in range(1, V.shape[0]):
        acc = acc + lt[j]
    t = torch.clamp_max(torch.exp(acc - lt), _SPA_TANH_CLIP)
    mag = torch.log1p(t) - torch.log1p(-t)
    sb = V.view(torch.int32)
    sg = sb[0]
    for j in range(1, V.shape[0]):
        sg = sg ^ sb[j]
    flip = (sg ^ sb) & _SIGN
    return (mag.view(torch.int32) | flip).view(torch.float32)


def _syndrome_fail(layers, total: torch.Tensor, Z: int) -> torch.Tensor:
    B = total.shape[1]
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    for idx, _, d in layers:
        par = (total[idx] < 0).view(d, Z, B).sum(0) % 2
        fail |= (par != 0).any(0)
    return fail


def _sweep(layers, total, C, Z, rule, track: bool, store):
    """One layered iteration in place on total [n, B] and C [E, Z, B]; in
    track mode returns the frames that saw a failed layer parity or a sign
    change."""
    B = total.shape[1]
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    for idx, eids, d in layers:
        rolled = total[idx].view(d, Z, B)
        if track:
            par = (rolled < 0).sum(0) % 2
            fail |= (par != 0).any(0)
        V = rolled - C[eids]
        Cnew = rule(V)
        new = V + Cnew
        if track:
            fail |= (torch.signbit(new) != torch.signbit(rolled)).any(0).any(0)
        total[idx] = store(new).view(d * Z, B)
        C[eids] = store(Cnew)
    return fail


def _decode_block(table: QCTable, layers, llr: torch.Tensor, spec: Spec,
                  store):
    Z, B = table.Z, llr.shape[0]
    a = float(np.float32(spec.alpha))
    if spec.rule == "spa":
        rule = _spa
    else:
        def rule(V):
            return _minsum(V, a, 0.0)
    total = store(llr.to(torch.float32).t().contiguous())
    C = torch.zeros((len(table.edges), Z, B), dtype=torch.float32,
                    device=llr.device)
    if spec.early_term:
        done = ~_syndrome_fail(layers, total, Z)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        for _ in range(spec.iters):
            act = torch.nonzero(~done).squeeze(1)
            if act.numel() == 0:
                break
            sub_total, sub_C = total[:, act], C[:, :, act]
            fail = _sweep(layers, sub_total, sub_C, Z, rule, True, store)
            total[:, act] = sub_total
            C[:, :, act] = sub_C
            iters[act] += 1
            done[act] = ~fail
    else:
        for _ in range(spec.iters):
            _sweep(layers, total, C, Z, rule, False, store)
        iters = torch.full((B,), spec.iters, dtype=torch.int32,
                           device=llr.device)
    bits = (total < 0).to(torch.uint8).t().contiguous()
    ok = ~_syndrome_fail(layers, total, Z)
    return bits, ok, iters


def decode(table: QCTable, llr: torch.Tensor, spec: Spec,
           precision: str = "f32", block: int = 4096):
    """(bits uint8 [B, n], ok bool [B], iterations int32 [B]) of llr f32
    [B, n], decoded in blocks of `block` frames on llr's device, with the
    retry wrapper where the spec has a fallback."""
    store = _store(precision)
    layers = _layers(table, llr.device)
    outs = [_decode_block(table, layers, llr[i:i + block], spec, store)
            for i in range(0, llr.shape[0], block)]
    bits, ok, iters = (torch.cat(x) for x in zip(*outs))
    if spec.fallback is not None:
        bad = torch.nonzero(~ok).squeeze(1)
        if bad.numel():
            fb, fok, fit = decode(table, llr[bad], spec.fallback, precision,
                                  block)
            bits[bad] = fb
            ok[bad] = fok
            iters[bad] += fit
    return bits, ok, iters
