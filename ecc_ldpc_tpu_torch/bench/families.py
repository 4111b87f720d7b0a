"""Per-family decoded throughput on the card (port of
ecc_ldpc_tpu/bench/families.py): every config of the JAX package's
DEFAULT_CONFIGS, unchanged, through the port's run_benchmark.

Run on a machine with an NVIDIA GPU:
  python -m ecc_ldpc_tpu_torch.bench.families [--only nr5g] [--out rows.jsonl]

Prints one JSON line per config, with the card's name and power limit
(nvidia-smi), and a markdown table. A config that fails raises: no family
can fail while the run exits 0.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from .throughput import run_benchmark

# (code, decoder, batch, ebn0_db): the JAX package's list, Eb/N0 near each
# family's operating point so decoded frames are realistic noisy frames
DEFAULT_CONFIGS = [
    ("mackay1008", "minsum/norm:0.8125/25/noet", 2048, 2.5),
    ("8023an", "layered/norm:0.8125/25/noet", 2048, 4.0),
    ("80211n/648/12", "layered/norm:0.8125/25/noet", 2048, 2.5),
    ("80211n/1296/12", "layered/norm:0.8125/25/noet", 2048, 2.2),
    ("80211n/1944/12", "layered/norm:0.8125/25/noet", 2048, 2.0),
    ("80211n/1944/56", "layered/norm:0.8125/25/noet", 2048, 4.0),
    ("wimax/576/12", "layered/norm:0.8125/25/noet", 2048, 2.5),
    ("wimax/2304/56", "layered/norm:0.8125/25/noet", 1024, 4.0),
    ("dvbs2/16200/12", "layered/norm:0.8125/25/noet", 1024, 1.5),
    ("dvbs2/64800/12", "layered/norm:0.8125/25/noet", 1024, 1.5),
    ("dvbs2/64800/34", "layered/norm:0.8125/25/noet", 1024, 3.0),
    ("nr5g/bg1/384", "layered/norm:0.8125/25/noet", 512, 2.0),
    ("nr5g/bg2/384", "layered/norm:0.8125/25/noet", 512, 2.5),
    # rate-matched (n_tx) specs: inert extension rows truncated, decode
    # work scales with the transmitted length (codes/nr5g.py)
    ("nr5g/bg1/384/8448/12672", "layered/norm:0.8125/25/noet", 1024, 3.0),
    ("nr5g/bg2/384/3840/7680", "layered/norm:0.8125/25/noet", 1024, 2.5),
]


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(only: str | None = None, device="cuda") -> list:
    """[(BenchResult, card)] of every config whose code contains `only`;
    prints each row's JSON line as it comes."""
    rows = []
    for code, decoder, batch, ebn0 in DEFAULT_CONFIGS:
        if only and only not in code:
            continue
        r = run_benchmark(code=code, decoder=decoder, batch=batch,
                          ebn0_db=ebn0, device=device)
        c = card()
        print(json.dumps(dict(json.loads(r.json_line()), card=c,
                              ebn0_db=ebn0, n=r.n, k=r.k,
                              bound_ms=r.bound_ms)), flush=True)
        rows.append((r, c))
    return rows


def table(rows) -> str:
    out = ["| code | n | k | Mbit/s per card | ms a batch | batch | "
           "bound ms | card |", "|---|---|---|---|---|---|---|---|"]
    for r, c in rows:
        out.append(f"| {r.code} | {r.n} | {r.k} | {r.throughput_mbps:.1f} "
                   f"| {r.wall_s_per_batch * 1e3:.3f} | {r.batch} "
                   f"| {r.bound_ms:.4f} | {c} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", help="write JSON rows to this file")
    ap.add_argument("--only", help="substring filter on code names")
    args = ap.parse_args(argv)
    rows = run(args.only)
    print("\n" + table(rows))
    if args.out:
        with open(args.out, "w") as f:
            for r, c in rows:
                f.write(json.dumps(dict(json.loads(r.json_line()), card=c))
                        + "\n")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
