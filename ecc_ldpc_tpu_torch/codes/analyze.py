"""Structural analysis of a code: degree profiles, 4-cycle census, QC shape.

A verbatim copy of ecc_ldpc_tpu/codes/analyze.py (NumPy only; the port
imports nothing of the JAX package).

The reference workflow starts from "what code am I actually running?" —
its matrix loaders print dimensions and the Monte-Carlo tables carry the
rate (SURVEY.md §2.1 R9/R11). This module is the equivalent introspection
surface: `ecc-sim codes --info <spec>` reports everything that determines
decoding behavior (degree distributions drive the decoder's unroll groups;
4-cycles bound BP performance; the QC block shape determines which Pallas
tier serves the code). Host-side NumPy only — never on the device path.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from .spec import CodeSpec


def degree_histogram(degs: np.ndarray) -> dict:
    """{degree: count}, sorted by degree."""
    vals, cnts = np.unique(np.asarray(degs), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, cnts)}


def count_4cycles(spec: CodeSpec) -> int:
    """Number of length-4 cycles in the Tanner graph: row pairs sharing
    >= 2 columns contribute C(shared, 2) cycles each. O(sum col_deg^2)."""
    pair_counts: Counter = Counter()
    for rows in spec.col_rows:
        r = np.asarray(rows)
        for i in range(len(r) - 1):
            a = int(r[i])
            for b in r[i + 1:]:
                pair_counts[(a, int(b))] += 1
    return sum(c * (c - 1) // 2 for c in pair_counts.values() if c >= 2)


def analyze(spec: CodeSpec, *, cycles: bool = True) -> dict:
    """Structural report as a plain dict (JSON-friendly)."""
    row_deg = spec.row_deg
    col_deg = spec.col_deg
    info: dict = {
        "name": spec.name,
        "n": spec.n,
        "m": spec.m,
        "k": spec.k,
        "rate": round(spec.k / spec.n, 6),
        "edges": spec.num_edges,
        "row_degree_hist": degree_histogram(row_deg),
        "col_degree_hist": degree_histogram(col_deg),
        "mean_row_degree": round(float(row_deg.mean()), 4),
        "mean_col_degree": round(float(col_deg.mean()), 4),
    }
    if spec.qc is not None:
        qc = spec.qc
        info["qc"] = {
            "Z": int(qc.Z),
            "mb": int(qc.mb),
            "nb": int(qc.nb),
            "block_edges": int(len(qc.block_edges()[0])),
        }
    punct = getattr(spec, "punctured_cols", None) or ()
    short = getattr(spec, "shortened_cols", None) or ()
    if punct or short:
        info["punctured_bits"] = len(punct)
        info["shortened_bits"] = len(short)
        info["tx_rate"] = round(spec.rate, 6)
    if cycles:
        c4 = count_4cycles(spec)
        info["four_cycles"] = c4
        info["girth_ge_6"] = c4 == 0
    return info


def format_info(info: dict) -> str:
    """Human-readable block for the CLI."""
    lines = [
        f"code        {info['name']}",
        f"n, m, k     {info['n']}, {info['m']}, {info['k']}",
        f"rate        {info['rate']}",
        f"edges       {info['edges']}",
        f"row degrees {_fmt_hist(info['row_degree_hist'])}"
        f"  (mean {info['mean_row_degree']})",
        f"col degrees {_fmt_hist(info['col_degree_hist'])}"
        f"  (mean {info['mean_col_degree']})",
    ]
    if "qc" in info:
        q = info["qc"]
        lines.append(
            f"QC          Z={q['Z']}  base {q['mb']}x{q['nb']}  "
            f"{q['block_edges']} block-edges"
        )
    if "punctured_bits" in info:
        lines.append(
            f"rate-match  {info['punctured_bits']} punctured, "
            f"{info['shortened_bits']} shortened -> tx rate {info['tx_rate']}"
        )
    if "four_cycles" in info:
        lines.append(
            f"4-cycles    {info['four_cycles']}"
            + ("  (girth >= 6)" if info["girth_ge_6"] else "")
        )
    return "\n".join(lines)


def _fmt_hist(h: dict) -> str:
    return " ".join(f"{d}:{c}" for d, c in h.items())
