"""Micro-benchmark: elementwise throughput per dtype, and the roll chain
per dtype, on the card (E5, E6; port of experiments/micro_vpu.py).

Question: do packed bf16 and int16 (and int8x4) elementwise ops run at
twice (four times) the f32 rate on Hopper? Each kernel of csrc/micro_ops.cu
runs a chain of INNER * REPS dependent steps at the TPU script's shape
[368, 128] (one TPU core's tile, on the card mostly launch latency) and at
[368, 16896] (132 such tiles side by side, enough to fill the card).

Run:  python -m ecc_ldpc_tpu_torch.experiments.micro_vpu [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from . import common
from .micro import (
    EW_DTYPES,
    EW_INNER,
    EW_REPS,
    EW_STEP,
    FULL_L,
    L,
    ROLL_DTYPES,
    Z,
    bytes_seconds,
    ew,
    ops_seconds,
    roll,
)


def inputs(cols: int, dev) -> torch.Tensor:
    """The TPU script's input, ones (micro_vpu.py:79), at [Z, cols]."""
    return torch.ones((Z, cols), dtype=torch.float32, device=dev)


def run(kind: str, dtype: str, x: torch.Tensor, dev, tries: int, inner: int,
        reps: int) -> dict:
    if kind == "ew":
        t = common.seconds(lambda: ew(x, dtype, inner, reps), dev, tries)
        ops = 4 * inner * reps
        bound = ops_seconds(dtype, x.numel(), inner * reps, EW_STEP)
        by = "operations"
    else:
        t = common.seconds(lambda: roll(x, dtype, inner, reps), dev, tries)
        ops = inner * reps
        # the chain is one rotation: read once, written once
        bound, by = bytes_seconds(8 * x.numel()), "bytes"
    eps = x.numel() * ops / t / 1e9
    return {"kind": kind, "dtype": dtype, "shape": list(x.shape),
            "ms": t * 1e3, "gelem_op_s": eps, "bound_ms": bound * 1e3,
            "bound_by": by}


def main(argv=None) -> int:
    p = common.parser(__doc__)
    p.add_argument("--inner", type=int, default=EW_INNER)
    p.add_argument("--reps", type=int, default=EW_REPS)
    p.add_argument("--shapes", default="tpu,full",
                   help="tpu ([368, 128]) and/or full ([368, 16896])")
    args = p.parse_args(argv)
    dev, card = common.start(args)
    cols = {"tpu": L, "full": FULL_L}
    print(f"device={card['device']} inner={args.inner} reps={args.reps}")
    for shape in args.shapes.split(","):
        x = inputs(cols[shape], dev)
        for kind, dtypes in (("ew", EW_DTYPES), ("roll", ROLL_DTYPES)):
            base = None
            for dtype in dtypes:
                r = run(kind, dtype, x, dev, args.tries, args.inner,
                        args.reps)
                print(f"{kind:4s} {dtype:10s} {r['ms']:8.2f} ms  "
                      f"{r['gelem_op_s']:9.1f} Gelem-op/s  [{shape}]")
                if base is None:
                    base = r["ms"]
                else:
                    r["vs_f32"] = base / r["ms"]
                    print(f"     -> vs f32: {r['vs_f32']:.2f}x")
                common.record(experiment="micro_vpu", shape_name=shape,
                              **r, **card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
