"""Micro-benchmark v2: per-op throughput by dtype with 4 independent
chains (E7; port of experiments/micro_vpu2.py).

Each op of OPS runs as four independent chains of INNER * REPS steps x <-
op(x, b) (csrc/micro_ops.cu), summed at the end, on random a and b: integers
in [1, 1000) for int32, standard normals otherwise. Shapes as
micro_vpu.py: the TPU script's [368, 128] and the card-filling [368, 16896].

Run:  python -m ecc_ldpc_tpu_torch.experiments.micro_vpu2 [--device cpu]
"""
from __future__ import annotations

import sys

from . import common
from .micro import (
    FULL_L,
    ILP,
    L,
    NOPS,
    OP_DTYPES,
    OP_INNER,
    OP_REPS,
    OP_STEP,
    OPS,
    Z,
    op,
    op_inputs,
    ops_seconds,
)


def run(name: str, dtype: str, cols: int, dev, tries: int, inner: int,
        reps: int) -> dict:
    a, b = op_inputs(dtype, Z, cols, dev)
    t = common.seconds(lambda: op(a, b, name, inner, reps), dev, tries)
    nops = NOPS[name] * ILP * inner * reps
    bound = ops_seconds(dtype, a.numel(), ILP * inner * reps, OP_STEP[name])
    return {"op": name, "dtype": dtype, "shape": [Z, cols], "ms": t * 1e3,
            "gelem_op_s": a.numel() * nops / t / 1e9,
            "bound_ms": bound * 1e3, "bound_by": "operations"}


def main(argv=None) -> int:
    p = common.parser(__doc__)
    p.add_argument("--inner", type=int, default=OP_INNER)
    p.add_argument("--reps", type=int, default=OP_REPS)
    p.add_argument("--shapes", default="tpu,full",
                   help="tpu ([368, 128]) and/or full ([368, 16896])")
    args = p.parse_args(argv)
    dev, card = common.start(args)
    cols = {"tpu": L, "full": FULL_L}
    print(f"device={card['device']} ilp={ILP}")
    for shape in args.shapes.split(","):
        for name in OPS:
            for dtype in OP_DTYPES:
                r = run(name, dtype, cols[shape], dev, args.tries,
                        args.inner, args.reps)
                print(f"{name:8s} {dtype:9s} {r['ms']:7.2f} ms "
                      f"{r['gelem_op_s']:8.1f} Gelem-op/s  [{shape}]")
                common.record(experiment="micro_vpu2", shape_name=shape,
                              **r, **card)
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
