"""The frozen yardstick of the kernels' roofline shares: the published H100
peaks and the least time a decode could take on them.

A copy of the port's bench/throughput.decode_ops and decode_bound as they
stood when the benchmark was defined (the layered and flooding schedules,
the set and accumulate forms), kept here so that no later change to the
port can move it. Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W
power limit; the special-function rate is Hopper's 16 results a clock per
SM at the 1.98 GHz boost clock.

The operations side divides every arithmetic operation by the 67 TFLOP/s
fp32 rate, which counts a fused multiply-add as two operations; min-sum
issues no multiply-adds, so that side is optimistic by up to 2x (PERF.md,
open questions).
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
H100_SFU_PER_S = 16 * 132 * 1.98e9
OPS_PER_EDGE_VISIT = 12


def decode_ops(num_edges: int, num_checks: int, cn: str = "minsum",
               schedule: str = "layered", accumulate: bool = False):
    """(transcendentals, arithmetic operations) of one iteration of one
    frame under check-node rule `cn`, for E edges and m checks (every check
    of degree >= 2).

    layered: minsum 0 and 12 per edge visit (pass 1: subtract, abs, min,
    max, min, sign xor; pass 2: abs-compare, select, xor, and, or, add);
    spa 5 per edge visit (tanh and log in pass 1; exp and two log1p in pass
    2) and 14 arithmetic; minstar 3(d-2) box-plus a check of degree d, each
    2 exp + 2 log1p and 16 arithmetic, plus 4 arithmetic per edge visit:
    12(E - 2m) and 48(E - 2m) + 4E. flooding: the same check work, spa with
    4 transcendentals per edge visit, plus 2 arithmetic per edge visit (the
    variable-node add and the extrinsic's recompute). accumulate (layered,
    a block column repeated in a layer): plus 2 arithmetic per edge visit."""
    E, m = num_edges, num_checks
    if schedule not in ("layered", "flooding"):
        raise KeyError(f"schedule must be layered/flooding, got {schedule!r}")
    if accumulate and schedule != "layered":
        raise ValueError("the accumulate form is a layered schedule's")
    extra = 2 * E if schedule == "flooding" or accumulate else 0
    if cn == "minsum":
        return 0, OPS_PER_EDGE_VISIT * E + extra
    if cn == "spa":
        return (4 if schedule == "flooding" else 5) * E, 14 * E + extra
    if cn == "minstar":
        return 12 * (E - 2 * m), 48 * (E - 2 * m) + 4 * E + extra
    raise KeyError(f"cn must be minsum/spa/minstar, got {cn!r}")


def decode_bound(n: int, num_edges: int, batch: int, iteration_sum: int,
                 cn: str = "minsum", num_checks: int = 0,
                 schedule: str = "layered", accumulate: bool = False):
    """(seconds, "bytes" | "operations"): the least time an H100 could take
    to decode `batch` frames that ran `iteration_sum` iterations in all:
    the larger of the compulsory bytes (4 B of LLR in, 1 B of bits out a
    code bit a frame) over the HBM rate and the operations, where the
    special-function units and the fp32 pipes run side by side."""
    t_bytes = batch * n * (4 + 1) / H100_HBM_BYTES_PER_S
    trans, arith = decode_ops(num_edges, num_checks, cn, schedule,
                              accumulate)
    t_ops = iteration_sum * max(trans / H100_SFU_PER_S,
                                arith / H100_FP32_OPS_PER_S)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
