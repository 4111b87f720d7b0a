"""alist parity-check matrix format (port of ecc_ldpc_tpu/codes/alist.py;
NumPy only).

Format (whitespace-separated integers):
  line 1: n m
  line 2: dv_max dc_max
  line 3: n column degrees
  line 4: m row degrees
  next n lines: per-column 1-indexed row neighbors, 0-padded to dv_max
  next m lines: per-row 1-indexed column neighbors, 0-padded to dc_max

Tolerant reader: padding zeros are optional (some published alist files
omit them).
"""
from __future__ import annotations

import numpy as np

from .spec import CodeSpec


def loads_alist(text: str, name: str = "alist") -> CodeSpec:
    toks = text.split()
    pos = 0

    def take(count):
        nonlocal pos
        vals = [int(t) for t in toks[pos: pos + count]]
        pos += count
        return vals

    n, m = take(2)
    dv_max, dc_max = take(2)
    col_deg = take(n)
    row_deg = take(m)
    if max(col_deg, default=0) > dv_max or max(row_deg, default=0) > dc_max:
        raise ValueError("alist degree list exceeds declared maxima")

    # Files may be fully padded (dv_max / dc_max entries per line, zeros
    # for padding) or unpadded (exactly deg entries); the body length
    # tells which.
    remaining = len(toks) - pos
    padded_len = n * dv_max + m * dc_max
    unpadded_len = sum(col_deg) + sum(row_deg)
    if remaining == padded_len:
        col_entries = [take(dv_max)[: col_deg[j]] for j in range(n)]
        row_entries = [take(dc_max)[: row_deg[i]] for i in range(m)]
    elif remaining == unpadded_len:
        col_entries = [take(col_deg[j]) for j in range(n)]
        row_entries = [take(row_deg[i]) for i in range(m)]
    else:
        raise ValueError(
            f"alist body has {remaining} entries; expected {padded_len} (padded)"
            f" or {unpadded_len} (unpadded)"
        )

    row_cols = [np.sort(np.asarray(r, dtype=np.int32) - 1) for r in row_entries]
    spec = CodeSpec(name=name, n=n, m=m, row_cols=tuple(row_cols))

    # Cross-validate against the column lists.
    for j, entry in enumerate(col_entries):
        got = spec.col_rows[j]
        want = np.sort(np.asarray(entry, dtype=np.int32) - 1)
        if not np.array_equal(got, want):
            raise ValueError(f"alist row/column adjacency mismatch at column {j}")
    return spec


def load_alist(path, name: str | None = None) -> CodeSpec:
    with open(path) as f:
        return loads_alist(f.read(), name=name or str(path))


def dumps_alist(spec: CodeSpec) -> str:
    dv_max = int(spec.col_deg.max())
    dc_max = int(spec.row_deg.max())
    out = [f"{spec.n} {spec.m}", f"{dv_max} {dc_max}"]
    out.append(" ".join(str(int(d)) for d in spec.col_deg))
    out.append(" ".join(str(int(d)) for d in spec.row_deg))
    for j in range(spec.n):
        ent = [str(int(r) + 1) for r in spec.col_rows[j]]
        ent += ["0"] * (dv_max - len(ent))
        out.append(" ".join(ent))
    for i in range(spec.m):
        ent = [str(int(c) + 1) for c in spec.row_cols[i]]
        ent += ["0"] * (dc_max - len(ent))
        out.append(" ".join(ent))
    return "\n".join(out) + "\n"
