"""Decoder construction + compact decoder-spec strings (port of
ecc_ldpc_tpu/decode/api.py for the layered family).

  layered/norm:0.8125/25/noet        fixed 25 iterations, alpha 0.8125
  layered/norm:0.8125/25             early termination (exact stop rule)
  layered/offset:0.15/25             offset min-sum
  layered/sched:dvbs2_64800_12_T25_op2   learned per-iteration schedule

The port has one decoder per device and no backend choice: a CUDA tensor
goes through the CUDA kernel, a CPU tensor through the plain version.
"""
from __future__ import annotations

from .layered_qc import make_layered_decoder

# decoder-spec parts the JAX package has and the port does not yet
_WAITING = {
    "retry": "ROADMAP.md Queue 1 step 10 (post-processing: with_retry)",
    "cleanup": "ROADMAP.md Queue 1 step 10 (post-processing: cleanup)",
    "q:": "ROADMAP.md Queue 1 step 11 (quantization emulation)",
    "spa": "ROADMAP.md Queue 2 K1c (layered exact BP)",
    "minstar": "ROADMAP.md Queue 2 K1c (layered exact BP)",
    "kind": "ROADMAP.md Queue 1 step 8 (flooding decoders) and step 10 "
            "(bit flipping)",
}


def _waiting(what: str, spec: str):
    return NotImplementedError(
        f"{spec!r}: {what} is not ported yet; it waits for {_WAITING[what]}")


def parse_decoder_spec(spec: str) -> dict:
    """Parse a compact decoder-spec string into make_decoder kwargs.

    'sched:NAME' loads a shipped learned schedule as per-iteration
    alpha/beta arrays; an explicit iteration count may truncate it."""
    if ";retry=" in spec:
        raise _waiting("retry", spec)
    parts = spec.split("/")
    kind = parts[0]
    kw: dict = {"kind": kind}
    sched = None
    for p in parts[1:]:
        if p.startswith("norm:"):
            kw["alpha"] = float(p[5:])
        elif p.startswith("offset:"):
            kw["beta"] = float(p[7:])
        elif p.startswith("q:"):
            raise _waiting("q:", spec)
        elif p.startswith("sched:"):
            sched = p[6:]
        elif p in ("spa", "minstar") and kind == "layered":
            raise _waiting(p, spec)
        elif p == "minsum" and kind == "layered":
            pass  # the layered rule the port runs
        elif p == "noet":
            kw["early_term"] = False
        elif p == "cleanup":
            raise _waiting("cleanup", spec)
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
                 max_iters: int = 25, early_term: bool = True,
                 device="cuda"):
    """Build `decode(llr[B, n]) -> DecodeResult` for one graph."""
    if kind != "layered":
        raise _waiting("kind", f"{kind}/...")
    return make_layered_decoder(
        graph, alpha=alpha, beta=beta, max_iters=max_iters,
        early_term=early_term, device=device,
    )


def get_decoder(graph, spec: str, device="cuda", **overrides):
    """Build a decoder from a spec string (see the module docstring)."""
    kw = parse_decoder_spec(spec)
    kw.update(overrides)
    return make_decoder(graph, device=device, **kw)


def choose_graph(code_spec, decoder_spec: str):
    """Compile the graph view a decoder spec needs: the QC block view for
    the layered decoders (raises clearly on non-QC codes)."""
    from ..graph.qc import compile_qc_graph

    kind = parse_decoder_spec(decoder_spec)["kind"]
    if kind != "layered":
        raise _waiting("kind", decoder_spec)
    return compile_qc_graph(code_spec)
