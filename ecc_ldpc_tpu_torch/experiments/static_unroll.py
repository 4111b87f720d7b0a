"""Experiment: the fully static layer sweep against the dynamic kernels
(E3; port of experiments/static_unroll.py).

Hypothesis carried over from the TPU: a sweep whose rows are compile-time
constants (no table loads, immediate column homes and shifts, zero shifts
elided, the compiler free to schedule across layers) runs faster than one
that reads its tables at run time. On the card the unrolled sweep is a
kernel body of some 90 layers x 7 slots, so the instruction cache may
decide instead. Timed against K1a (bf16 storage) and E1 full (the same
arithmetic with runtime tables, plus the cap) in one process, in the
latency regime (B = 128) and the throughput regime (B = 4096); E3 and E1
full must give identical bits.

Run:  python -m ecc_ldpc_tpu_torch.experiments.static_unroll [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from . import common
from .ablate import (
    ITERS,
    THROUGHPUT_B,
    TILE,
    ablate,
    inputs3,
    static_graph,
    to_var,
)
from .ablate_layered import bound_ms, k1a_seconds
from .variants import E1_VARIANTS, E3_FLAGS


def main(argv=None) -> int:
    p = common.parser(__doc__)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--batches", default=f"{TILE},{THROUGHPUT_B}")
    args = p.parse_args(argv)
    dev, card = common.start(args)
    graph = static_graph()
    k = graph.k
    for B, regime in zip(map(int, args.batches.split(",")),
                         ("latency", "throughput")):
        llr = to_var(graph, inputs3(graph, B, dev), True)
        b_ms, by = bound_ms(graph, B, args.iters)
        bits_dyn = ablate(graph, llr, E1_VARIANTS["full"], args.iters)
        bits_st = ablate(graph, llr, E3_FLAGS, args.iters, static=True)
        same = bool(torch.equal(bits_dyn, bits_st))
        times = {
            "dynamic": k1a_seconds(graph, llr, dev, args.tries),
            "e1_full": common.seconds(lambda: ablate(
                graph, llr, E1_VARIANTS["full"], args.iters), dev,
                args.tries),
            "static": common.seconds(lambda: ablate(
                graph, llr, E3_FLAGS, args.iters, static=True), dev,
                args.tries),
        }
        for name, t in times.items():
            if t is None:  # K1a on the CPU
                continue
            print(f"{name:8s} {t * 1e3:7.2f} ms/decode  "
                  f"{B * k / t / 1e6:7.1f} Mbit/s  [{regime}, B={B}]",
                  flush=True)
            common.record(experiment="static_unroll", variant=name,
                          regime=regime, batch=B, ms=t * 1e3,
                          mbps=B * k / t / 1e6, bound_ms=b_ms, bound_by=by,
                          **card)
        print(f"static bits == E1 full bits: {same}", flush=True)
        common.record(experiment="static_unroll", regime=regime, batch=B,
                      bits_equal_e1_full=same, ones=int(bits_st.sum()),
                      **card)
        if not same:
            raise AssertionError("E3's bits differ from E1 full's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
