"""Same-call A/B of the benchmark legs between this checkout and another
tree, such as the parent commit unpacked with `git archive` into a
directory that .gitignore lists. Needs one CUDA card:

    python -m ecc_ldpc_tpu_torch.bench.legs_ab OTHER_ROOT LEG [LEG ...]

Each tree runs in a process of its own, in the order other, this, this,
other, so a drift of the card's clock or temperature falls on both alike.
Each process builds its own tree's kernels, times the legs through its own
tree's bench.throughput.run_benchmark and prints one JSON line per leg.
Then one line per leg: each tree's time (the mean of its two runs' medians)
and this / other - 1; then, per layered kernel source, each tree's
registers and spill stores of every kernel instance from its build's
`-Xptxas -v` report, and whether they agree. Leg names are
bench.profile's: the keys of LEGS,
EXACT_LEGS and FLOODING_LEGS, ccsds_<rule> and 8023an_<mode>, and
mackay_spa and mackay_minstar (the mackay leg's shape with spa/25/noet and
minstar/25/noet); a leg that a tree lacks is skipped there.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]

# run in each tree's process: argv[1] is the tree, argv[2:] the legs
_TIME_LEGS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from ecc_ldpc_tpu_torch.bench import throughput as t
legs = {}
for name in ("LEGS", "EXACT_LEGS", "FLOODING_LEGS"):
    legs.update(getattr(t, name, {}))
legs.update({f"ccsds_{k}": v for k, v in getattr(t, "CCSDS_LEGS", {}).items()})
legs.update({f"8023an_{k}": v for k, v in getattr(t, "XOR_LEGS", {}).items()})
legs.update({f"mackay_{k}": dict(legs["mackay"], decoder=f"{k}/25/noet")
             for k in ("spa", "minstar")})
for leg in sys.argv[2:]:
    if leg in legs:
        r = t.run_benchmark(**legs[leg], device="cuda")
        print(json.dumps({"leg": leg, "ms": r.wall_s_per_batch * 1e3,
                          "tries_ms": [s * 1e3 for s in r.tries_s],
                          "frame_errors": r.frame_errors}), flush=True)
"""


def time_tree(root: pathlib.Path, legs) -> dict:
    """{leg: ms} of one process that times `legs` in the tree at root."""
    out = subprocess.run([sys.executable, "-c", _TIME_LEGS, str(root), *legs],
                         cwd=root, check=True, capture_output=True, text=True)
    times = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            print(json.dumps({"tree": str(root), **d}), flush=True)
            times[d["leg"]] = d["ms"]
    return times


SPILL_SOURCES = ("layered_qc", "layered_exact", "layered_classic")


def _instance(fn: str) -> str:
    """A kernel's mangled name without its anonymous namespace, whose tag
    differs from tree to tree (_GLOBAL__N__<tag>_<file>_cu_<8 hex>)."""
    return fn.split("_cu_", 1)[1][8:] if "_cu_" in fn else fn


def spill_report(root: pathlib.Path, name: str) -> dict:
    """{kernel instance: (registers, spill store bytes)} from the ptxas
    report of the library `name` (its f32 build) that the tree at root
    built last."""
    logs = sorted((root / "build" / "kernels").glob(f"lib{name}-*.log"),
                  key=lambda p: p.stat().st_mtime)
    out, fn = {}, None
    for ln in logs[-1].read_text().splitlines() if logs else ():
        if "Compiling entry function" in ln:
            fn = _instance(ln.split("'")[1])
        elif fn and "bytes spill stores" in ln:
            spill = int(ln.split(" bytes spill stores")[0].split()[-1])
            out[fn] = (None, spill)
        elif fn and "Used" in ln and "registers" in ln:
            regs = int(ln.split("Used ")[1].split()[0])
            out[fn] = (regs, out.get(fn, (None, 0))[1])
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        raise SystemExit(__doc__)
    other, legs = pathlib.Path(args[0]).resolve(), args[1:]
    runs = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        runs[tree].append(time_tree(other if tree == "other" else HERE, legs))
    for leg in legs:
        ms = {k: [r[leg] for r in v if leg in r] for k, v in runs.items()}
        if not ms["other"] or not ms["this"]:
            continue
        a, b = (sum(v) / len(v) for v in (ms["other"], ms["this"]))
        print(json.dumps({"leg": leg, "other_ms": ms["other"],
                          "this_ms": ms["this"], "change": b / a - 1}),
              flush=True)
    for name in SPILL_SOURCES:
        a, b = spill_report(other, name), spill_report(HERE, name)
        print(json.dumps({"ptxas": name, "same": a == b,
                          "max_spill": [max((v[1] for v in r.values()),
                                            default=None) for r in (a, b)],
                          "other": a, "this": b}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
