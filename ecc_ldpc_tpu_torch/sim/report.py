"""BER/FER reporting: human tables, machine-readable output, parity checks
(a copy of ecc_ldpc_tpu/sim/report.py, which imports nothing of JAX).

format_table prints EbN0 / frames / errors / BER / FER with the FER
confidence interval. curves_overlap is the BER-parity equivalence test:
two curves "match within statistical bounds" iff their Wilson CIs overlap
at every common Eb/N0 point.
"""
from __future__ import annotations

import json
from typing import Sequence

from .runner import PointResult


def format_table(results: Sequence[PointResult]) -> str:
    head = (
        f"{'code':>16} {'decoder':>24} {'EbN0':>6} {'frames':>9} "
        f"{'bit_err':>8} {'frm_err':>8} {'BER':>10} {'FER':>10} "
        f"{'FER 95% CI':>22} {'iters':>6}"
    )
    lines = [head, "-" * len(head)]
    for r in results:
        lo, hi = r.fer_ci
        lines.append(
            f"{r.code:>16} {r.decoder:>24} {r.ebn0_db:>6.2f} {r.frames:>9} "
            f"{r.bit_errors:>8} {r.frame_errors:>8} {r.ber:>10.3e} "
            f"{r.fer:>10.3e} {f'[{lo:.2e},{hi:.2e}]':>22} {r.mean_iters:>6.1f}"
        )
    return "\n".join(lines)


def results_to_json(results: Sequence[PointResult]) -> str:
    return json.dumps([r.to_json() for r in results], indent=2)


def save_results(results: Sequence[PointResult], path: str) -> None:
    if path.endswith(".csv"):
        with open(path, "w") as f:
            f.write(results_to_csv(results))
    else:
        with open(path, "w") as f:
            f.write(results_to_json(results))


_CSV_FIELDS = (
    "code decoder ebn0_db frames bit_errors frame_errors ber fer "
    "mean_iters wall_s".split()
)


def results_to_csv(results: Sequence[PointResult]) -> str:
    lines = [",".join(_CSV_FIELDS)]
    for r in results:
        lines.append(",".join(str(getattr(r, f)) for f in _CSV_FIELDS))
    return "\n".join(lines) + "\n"


def curves_overlap(
    a: Sequence[PointResult], b: Sequence[PointResult], metric: str = "fer"
) -> bool:
    """True iff CIs overlap at every Eb/N0 point both curves share.

    BER comparison against legacy curves: points recorded before
    bit_errors_sq existed carry a falsely-narrow cluster CI (design
    effect = MEAN burst size, but per-frame error weights are heavy-
    tailed at waterfall tails — see PointResult.ber_ci). When one side
    of a point has the squared-weight statistic and the other doesn't,
    the legacy side's CI is recomputed with the measured side's design
    effect: both runs sample the same per-frame weight distribution at
    the same operating point, so the borrowed design effect is the best
    available estimate of the legacy run's true clustering.

    Borrowing makes the BER arm strictly looser against legacy curves (a
    genuine regression with heavy bursts inflates the borrowed effect
    too, widening the very CI that should catch it), so BER overlap vs a
    legacy curve is ADVISORY — the FER arm (no borrowing: frame errors
    are Bernoulli) is the hard gate, and validate_tail/the golden gate
    require it to pass independently. The effect is deliberately NOT
    capped: measured clustering reaches design effects of ~300 (apsk32
    at 5.6 dB, two heavy frames dominating sum(w^2)), so any plausible
    cap either bites legitimate bursts or fails to bind. Curves
    regenerated with bit_errors_sq never take this path.
    """
    bi = {round(r.ebn0_db, 6): r for r in b}
    shared = [(ra, bi[round(ra.ebn0_db, 6)]) for ra in a if round(ra.ebn0_db, 6) in bi]
    if not shared:
        raise ValueError("curves share no Eb/N0 points")
    for ra, rb in shared:
        if metric == "ber":
            ra, rb = _borrow_design_effect(ra, rb)
        lo_a, hi_a = getattr(ra, f"{metric}_ci")
        lo_b, hi_b = getattr(rb, f"{metric}_ci")
        if hi_a < lo_b or hi_b < lo_a:
            return False
    return True


def _borrow_design_effect(ra: PointResult, rb: PointResult):
    """If exactly one of the pair tracks bit_errors_sq, synthesize the
    other's statistic from the same design effect D = sum(w^2)/sum(w):
    bit_errors_sq = D * bit_errors keeps its BER point estimate while
    widening its CI to the measured clustering."""
    import dataclasses as _dc

    has_a = ra.bit_errors_sq > 0 and ra.bit_errors > 0
    has_b = rb.bit_errors_sq > 0 and rb.bit_errors > 0
    if has_a == has_b:
        return ra, rb
    src, dst = (ra, rb) if has_a else (rb, ra)
    if dst.bit_errors <= 0:
        return ra, rb
    design = src.bit_errors_sq / src.bit_errors
    patched = _dc.replace(dst, bit_errors_sq=design * dst.bit_errors)
    return (ra, patched) if has_a else (patched, rb)


def plot_curves(results: Sequence[PointResult], metric: str = "fer",
                width: int = 72, height: int = 22) -> str:
    """ASCII waterfall plot: log10(metric) vs Eb/N0, one glyph per
    (code, decoder) series — the reference's table output made visual
    without leaving the terminal. Zero-valued points (no errors observed)
    are drawn at the series' observable floor marker 'v' (an upper bound,
    not a measurement)."""
    series: dict = {}
    for r in results:
        series.setdefault((r.code, r.decoder), []).append(r)
    if not series:
        return "(no results)"
    glyphs = "*o+x#@%&"
    xs = sorted({r.ebn0_db for r in results})
    vals = [getattr(r, metric) for r in results if getattr(r, metric) > 0]
    # error-free points plot at their observable floor 1/denominator —
    # include those in the range so the markers aren't clamped
    for r in results:
        if getattr(r, metric) == 0 and r.frames:
            denom = (r.frames if metric == "fer"
                     else r.frames * r.message_bits_per_frame)
            vals.append(1.0 / denom)
    if not vals:
        return "(no frames recorded — nothing to plot)"
    import math

    ymax = math.ceil(math.log10(max(vals)))
    ymin = math.floor(math.log10(min(vals)))
    ymin = max(ymin, ymax - 10)  # cap dynamic range at 10 decades
    x0, x1 = min(xs), max(xs) or 1.0
    span_x = (x1 - x0) or 1.0
    grid = [[" "] * width for _ in range(height)]

    def put(x, y, ch):
        c = int(round((x - x0) / span_x * (width - 1)))
        rowf = (ymax - y) / max(ymax - ymin, 1e-9) * (height - 1)
        r = min(height - 1, max(0, int(round(rowf))))
        grid[r][c] = ch

    floors = []
    for si, ((code, dec), pts) in enumerate(sorted(series.items())):
        g = glyphs[si % len(glyphs)]
        for p in pts:
            v = getattr(p, metric)
            if v > 0:
                put(p.ebn0_db, math.log10(v), g)
            else:
                denom = (p.frames if metric == "fer"
                         else p.frames * p.message_bits_per_frame)
                if denom:
                    put(p.ebn0_db, math.log10(1.0 / denom), "v")
        floors.append(f"  {g} = {code} | {dec}")
    lines = []
    for i, row in enumerate(grid):
        y = ymax - i * (ymax - ymin) / max(height - 1, 1)
        label = f"1e{y:+.0f}" if abs(y - round(y)) < 1e-6 else ""
        lines.append(f"{label:>6s} |" + "".join(row))
    lines.append(" " * 7 + "+" + "-" * width)
    lines.append(f"{'':7s}{x0:<8.2f}{metric.upper()} vs Eb/N0 (dB)"
                 f"{x1:>{max(1, width - 22)}.2f}")
    lines += floors
    lines.append("  v = error-free point (upper bound 1/frames)")
    return "\n".join(lines)
