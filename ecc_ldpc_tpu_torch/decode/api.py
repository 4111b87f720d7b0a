"""Decoder construction + compact decoder-spec strings (port of
ecc_ldpc_tpu/decode/api.py for the layered and flooding families).

  layered/norm:0.8125/25/noet        fixed 25 iterations, alpha 0.8125
  layered/norm:0.8125/25             early termination (exact stop rule)
  layered/offset:0.15/25             offset min-sum
  layered/sched:dvbs2_64800_12_T25_op2   learned per-iteration schedule
  layered/spa/50, layered/minstar/25 layered exact BP (tanh rule, box-plus)
  minsum/norm:0.8125/25              flooding normalized min-sum
  spa/50, minstar/25                 flooding exact BP
  layered/norm:0.8125/50;retry=spa/50
                                     frames the primary fails are decoded
                                     again by the fallback (with_retry)

The port has one decoder per device and no backend choice: a CUDA tensor
goes through the CUDA kernels, a CPU tensor through the plain version. The
spec parts `pallas`, `xla` and `auto` are parsed and have no effect;
`xla-mm` (the incidence-matmul form) exists only for the TPU and raises.
Flooding kinds decode a QCGraph with decode/flooding_qc (K3) and a
CompiledGraph with decode/flooding (K2).
"""
from __future__ import annotations

import numpy as np
import torch

from .cn_ops import CN_KINDS
from .layered_qc import make_layered_decoder
from .types import DecodeResult

# decoder-spec parts the JAX package has and the port does not yet
_WAITING = {
    "cleanup": "ROADMAP.md Queue 1 step 10 (post-processing: cleanup)",
    "q:": "ROADMAP.md Queue 1 step 11 (quantization emulation)",
    "kind": "ROADMAP.md Queue 1 step 10 (bit flipping)",
}


def _waiting(what: str, spec: str):
    return NotImplementedError(
        f"{spec!r}: {what} is not ported yet; it waits for {_WAITING[what]}")


def parse_decoder_spec(spec: str) -> dict:
    """Parse a compact decoder-spec string into make_decoder kwargs.

    'sched:NAME' loads a shipped learned schedule as per-iteration
    alpha/beta arrays; an explicit iteration count may truncate it. A
    ';retry=FALLBACK' suffix is handled by get_decoder; here it is
    stripped, so callers that only inspect the spec see the PRIMARY's
    kwargs."""
    parts = spec.split(";retry=")[0].split("/")
    kind = parts[0]
    kw: dict = {"kind": kind}
    sched = None
    for p in parts[1:]:
        if p.startswith("norm:"):
            kw["alpha"] = float(p[5:])
        elif p.startswith("offset:"):
            kw["beta"] = float(p[7:])
        elif p.startswith("theta:"):
            kw["theta"] = float(p[6:])  # gdbf flip threshold
        elif p.startswith("q:"):
            raise _waiting("q:", spec)
        elif p.startswith("sched:"):
            sched = p[6:]
        elif p in ("spa", "minstar", "minsum") and kind == "layered":
            kw["cn"] = p  # layered sweep with this check-node rule
        elif p == "noet":
            kw["early_term"] = False
        elif p == "cleanup":
            raise _waiting("cleanup", spec)
        elif p in ("pallas", "xla", "xla-mm", "auto"):
            kw["backend"] = p
        elif p.isdigit():
            kw["max_iters"] = int(p)
        else:
            raise ValueError(f"bad decoder-spec component {p!r} in {spec!r}")
    if sched is not None:
        from ..learn.schedules import load_schedule

        if kind != "layered":
            raise ValueError(
                f"sched: applies to layered decoding only (got {kind!r})")
        if "alpha" in kw or "beta" in kw:
            raise ValueError(
                "decoder spec mixes norm:/offset: with sched: — a schedule "
                "already fixes per-iteration alpha/beta")
        ps = load_schedule(sched)
        T = kw.setdefault("max_iters", ps.iters)
        if T > ps.iters:
            raise ValueError(
                f"schedule {sched!r} has {ps.iters} iterations, "
                f"spec asks for {T}")
        kw["alpha"] = ps.alphas[:T]
        kw["beta"] = ps.betas[:T]
    return kw


def make_decoder(graph, kind: str = "layered", *, alpha=1.0, beta=0.0,
                 theta: float = 0.0, max_iters: int = 25,
                 early_term: bool = True, backend: str = "auto",
                 cn: str = "minsum", device="cuda"):
    """Build `decode(llr[B, n]) -> DecodeResult` for one graph: layered on
    a QCGraph, or flooding minsum/spa/minstar on a QCGraph (K3) or a
    CompiledGraph (K2). `theta` belongs to gdbf, which is not ported."""
    from ..graph.qc import QCGraph

    if backend == "xla-mm":
        raise ValueError(
            "backend 'xla-mm' is the incidence-matmul form, which exists only "
            "for the TPU (it has no vector gather); the port decodes with "
            "gathers on the card — drop '/xla-mm'")
    if backend not in ("auto", "pallas", "xla"):
        raise KeyError(f"unknown backend {backend!r}")
    if kind in ("bitflip", "gdbf"):
        raise _waiting("kind", f"{kind}/...")
    if kind == "layered":
        return make_layered_decoder(
            graph, alpha=alpha, beta=beta, max_iters=max_iters,
            early_term=early_term, cn=cn, device=device,
        )
    if kind not in CN_KINDS:
        raise KeyError(f"unknown decoder kind {kind!r}")
    if cn != "minsum":
        raise KeyError(
            f"cn={cn!r} selects the layered sweep's check-node rule; for "
            f"flooding use kind='spa'/'minstar' directly")
    kw = dict(kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term, device=device)
    if isinstance(graph, QCGraph):
        from .flooding_qc import make_flooding_qc_decoder

        return make_flooding_qc_decoder(graph, **kw)
    from .flooding import make_flooding_decoder

    return make_flooding_decoder(graph, **kw)


def _split_retry(spec: str):
    """(primary, fallback) of 'PRIMARY;retry=FALLBACK', both non-empty."""
    primary, fallback = spec.split(";retry=", 1)
    if not primary or not fallback:
        raise ValueError(
            f"{spec!r}: a retry spec is 'PRIMARY;retry=FALLBACK', both "
            f"decoder specs")
    return primary, fallback


def get_decoder(graph, spec: str, device="cuda", **overrides):
    """Build a decoder from a spec string (see the module docstring).

    'PRIMARY;retry=FALLBACK' wraps the primary in with_retry on the same
    graph and device; the wrapper reads the per-frame ok flags on the
    host, so it carries `host_level = True` as in the JAX package."""
    if ";retry=" in spec:
        primary_spec, fallback_spec = _split_retry(spec)
        dec = with_retry(get_decoder(graph, primary_spec, device, **overrides),
                         get_decoder(graph, fallback_spec, device, **overrides))
        dec.host_level = True
        return dec
    kw = parse_decoder_spec(spec)
    kw.update(overrides)
    return make_decoder(graph, device=device, **kw)


def with_retry(primary, fallback):
    """Production wrapper (ecc_ldpc_tpu/decode/api.py:377-425): decode
    with `primary`; the frames it fails (ok=False) are decoded again by
    `fallback`, and every retried row takes the fallback's bits and ok
    (even where the fallback fails too, as the reference's _combine does)
    and the sum of both decoders' iterations.

    Only the per-frame ok flags go to the host; the failed rows are
    gathered and the results scattered back on the device. The JAX
    package pads the failed rows to buckets of 32 so the TPU compiles the
    fallback once; nothing here compiles per shape, and no decoder mixes
    frames, so the fallback gets exactly the failed rows."""

    def decode(llr: torch.Tensor) -> DecodeResult:
        res = primary(llr)
        bad = np.flatnonzero(~res.ok.cpu().numpy())
        if len(bad) == 0:
            return res
        idx = torch.as_tensor(bad, device=llr.device)
        retry = fallback(llr.index_select(0, idx))
        iters = res.iterations.index_select(0, idx) + retry.iterations
        return DecodeResult(
            bits=res.bits.index_copy(0, idx, retry.bits),
            ok=res.ok.index_copy(0, idx, retry.ok),
            iterations=res.iterations.index_copy(0, idx, iters),
        )

    return decode


def choose_graph(code_spec, decoder_spec: str):
    """Compile the graph view a decoder spec needs (the JAX package's rule
    without its TPU branches): the QC block view for layered decoding
    (raises clearly on non-QC codes) and for a QC code's flooding kinds;
    the expanded graph for every other code. A ';retry=' suffix shares the
    primary's graph."""
    from ..graph.compile import compile_graph
    from ..graph.qc import compile_qc_graph

    kind = parse_decoder_spec(decoder_spec.split(";retry=")[0])["kind"]
    if kind == "layered":
        return compile_qc_graph(code_spec)
    if code_spec.qc is None or kind not in CN_KINDS + ("bitflip", "gdbf"):
        return compile_graph(code_spec)
    return compile_qc_graph(code_spec)
