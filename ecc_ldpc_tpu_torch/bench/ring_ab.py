"""Same-call A/B of K5 (bench/ring.py) between this checkout and another
tree, such as the parent commit unpacked with `git archive` into a
directory that .gitignore lists. Needs one CUDA card:

    python -m ecc_ldpc_tpu_torch.bench.ring_ab OTHER_ROOT D [D ...]

For each D, bench/ring.py runs on D ranks (torch.distributed.run) of each
tree in the order other, this, this, other, each tree with its own kernels
and its own wrapper; rank 0's cases are printed as JSON lines. Then one
line per (D, case, dtype): each tree's ms a call (the mean of its two
runs), K5's launches a call in each, whether both trees' sums were
identical to the plain version's and across ranks, and this / other - 1.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parents[2]


def run_tree(root: pathlib.Path, D: int) -> list:
    """Rank 0's cases of bench/ring.py on D ranks in the tree at root."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={D}", "-m", "ecc_ldpc_tpu_torch.bench.ring",
               tmp]
        subprocess.run(cmd, cwd=root, check=True, capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(root)))
        line = json.loads((pathlib.Path(tmp) / "ring_rank0.json").read_text())
    print(json.dumps({"tree": str(root), "D": D, **line}), flush=True)
    return line["cases"]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        raise SystemExit(__doc__)
    other = pathlib.Path(args[0]).resolve()
    for D in (int(d) for d in args[1:]):
        runs = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            runs[tree].append(run_tree(other if tree == "other" else HERE, D))
        for i, case in enumerate(runs["this"][0]):
            ms = {k: [r[i]["ms"] for r in v] for k, v in runs.items()}
            a, b = (sum(v) / len(v) for v in (ms["other"], ms["this"]))
            print(json.dumps({
                "D": D, "case": case["case"], "dtype": case["dtype"],
                "other_ms": ms["other"], "this_ms": ms["this"],
                "other_launches": runs["other"][0][i]["launches"],
                "this_launches": case["launches"],
                "identical": all(r[i]["identical_to_plain"]
                                 and r[i]["ranks_identical"]
                                 for v in runs.values() for r in v),
                "change": b / a - 1}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
