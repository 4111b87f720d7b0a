"""Ablation study: where does the layered kernel's decode time go, on the
card? (E1; port of experiments/ablate_layered.py)

K1a's fixed-iteration layered min-sum on dvbs2/64800/12 (25 iterations,
alpha 0.8125, bf16 message storage, runtime row tables:
csrc/ablate_layered.cu) with one cost removed at a time. The ablated
variants decode wrongly on purpose and keep the dependency chain whole;
this measures time only. Timed in the latency regime (one TPU tile, B =
128: 128 of the card's 132 SMs hold a frame each) and, to compare with
the static rows of ablate_layered2.py, in the throughput regime (the
headline's B = 4096), each beside K1a itself (its bf16 precision library,
decode/layered_qc.layered_decode_cuda with msg_dtype=torch.bfloat16) in
the same process.

Run:  python -m ecc_ldpc_tpu_torch.experiments.ablate_layered [--device cpu]
"""
from __future__ import annotations

import sys

from . import common
from .ablate import (
    ALPHA,
    ITERS,
    THROUGHPUT_B,
    TILE,
    ablate,
    inputs3,
    static_graph,
    to_var,
)
from .variants import E1_VARIANTS, ROLL


def k1a_seconds(graph, llr, dev, tries: int):
    """K1a, fixed 25 iterations with bf16 message storage, on llr [B, n]
    (None on the CPU: K1a is the card's)."""
    import torch

    from ..decode.layered_qc import layered_decode_cuda

    if dev.type != "cuda":
        return None
    return common.seconds(lambda: layered_decode_cuda(
        graph, llr, alpha=ALPHA, max_iters=ITERS, early_term=False,
        msg_dtype=torch.bfloat16), dev, tries)


def bound_ms(graph, B: int, iters: int) -> tuple:
    from ..bench.throughput import decode_bound

    s, by = decode_bound(graph.n, graph.num_block_edges * graph.Z, B,
                         B * iters)
    return s * 1e3, by


def run_variants(name: str, variants: dict, B: int, dev, card, tries: int,
                 iters: int, static: bool, regime: str) -> dict:
    """Times every variant at batch B; prints the TPU script's lines and a
    JSON line each. Returns {variant: seconds}."""
    graph = static_graph()
    k = graph.k
    llr3 = inputs3(graph, B, dev)
    llr = {roll: to_var(graph, llr3, roll) for roll in (True, False)}
    b_ms, by = bound_ms(graph, B, iters)
    t_k1a = k1a_seconds(graph, llr[True], dev, tries)
    print(f"[{regime}, B={B}]")
    if t_k1a is not None:
        print(f"{'k1a_bf16':8s} {t_k1a * 1e3:7.2f} ms/decode  "
              f"{B * k / t_k1a / 1e6:7.1f} Mbit/s")
        common.record(experiment=name, variant="k1a_bf16", regime=regime,
                      batch=B, ms=t_k1a * 1e3, mbps=B * k / t_k1a / 1e6,
                      bound_ms=b_ms, bound_by=by, **card)
    out, t_full = {}, None
    for v, flags in variants.items():
        x = llr[bool(flags & ROLL)]
        t = common.seconds(lambda: ablate(graph, x, flags, iters,
                                          static=static), dev, tries)
        out[v] = t
        if v == "full":
            t_full = t
        print(f"{v:8s} {t * 1e3:7.2f} ms/decode  {B * k / t / 1e6:7.1f} "
              f"Mbit/s{common.saves(t_full, t)}", flush=True)
        common.record(experiment=name, variant=v, flags=flags, regime=regime,
                      batch=B, ms=t * 1e3, mbps=B * k / t / 1e6,
                      saves_pct=(None if v == "full"
                                 else 100 * (t_full - t) / t_full),
                      vs_k1a=None if t_k1a is None else t / t_k1a,
                      bound_ms=b_ms, bound_by=by, **card)
    return out


def main(argv=None) -> int:
    p = common.parser(__doc__)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--batches", default=f"{TILE},{THROUGHPUT_B}",
                   help="the latency regime's batch, then the throughput "
                        "regime's")
    args = p.parse_args(argv)
    dev, card = common.start(args)
    for B, regime in zip(map(int, args.batches.split(",")),
                         ("latency", "throughput")):
        run_variants("ablate_layered", E1_VARIANTS, B, dev, card, args.tries,
                     args.iters, False, regime)
    return 0


if __name__ == "__main__":
    sys.exit(main())
