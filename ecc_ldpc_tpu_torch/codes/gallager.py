"""Seeded (j,k)-regular LDPC construction (Gallager ensemble + girth repair).

A verbatim copy of ecc_ldpc_tpu/codes/gallager.py (the port imports
nothing of the JAX package): the same seed draws the same H.

The reference ships MacKay-constructed regular codes as data files (SURVEY.md
§2.1 R9); with no network in this environment the exact published matrices
cannot be fetched, so we construct codes from the same ensemble MacKay's 1A
construction samples: column-regular/row-regular random bipartite graphs with
4-cycle removal. The construction is deterministic (seeded) and the shipped
n=1008 instance is committed as data/mackay1008.alist — clearly labelled a
surrogate, per SURVEY.md §7.2 item 4.

Construction: Gallager's original ensemble. H is a vertical stack of j
(n/k x n) strips; each strip is a column-permuted copy of the canonical strip
whose row i has ones in columns [i*k, (i+1)*k). Strip 0 uses the identity
permutation. 4-cycles (two rows sharing >= 2 columns) are then removed by
targeted column-pair swaps inside a strip, which preserves both row and column
regularity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .spec import CodeSpec


def _strip_rows(n: int, k: int, perm: np.ndarray) -> list:
    """Rows of one Gallager strip under column permutation `perm`."""
    return [np.sort(perm[i * k : (i + 1) * k]) for i in range(n // k)]


def _four_cycle_pairs(rows: list) -> set:
    """Return set of (row_a, row_b) sharing >=2 columns (a<b, global ids)."""
    from collections import defaultdict

    col_rows = defaultdict(list)
    for ri, cols in enumerate(rows):
        for c in cols:
            col_rows[int(c)].append(ri)
    pair_count = defaultdict(int)
    for rlist in col_rows.values():
        for a in range(len(rlist)):
            for b in range(a + 1, len(rlist)):
                pair_count[(rlist[a], rlist[b])] += 1
    return {p for p, cnt in pair_count.items() if cnt >= 2}


def gallager_regular(
    n: int, j: int, k: int, seed: int = 0, max_girth_iters: int = 20_000
) -> CodeSpec:
    """(j,k)-regular code, m = n*j/k checks. Deterministic given seed."""
    if n % k:
        raise ValueError(f"n={n} must be divisible by k={k}")
    rng = np.random.default_rng(seed)
    strips = []
    for s in range(j):
        perm = np.arange(n) if s == 0 else rng.permutation(n)
        strips.append(perm)

    def all_rows():
        rows = []
        for perm in strips:
            rows.extend(_strip_rows(n, k, perm))
        return rows

    # Girth repair: while some pair of rows shares >=2 columns, pick one of
    # the offending shared columns and swap it (within its strip's
    # permutation) with a random other column of the same strip. Swapping two
    # entries of a strip permutation keeps every row degree k and every column
    # degree j.
    for _ in range(max_girth_iters):
        rows = all_rows()
        bad = _four_cycle_pairs(rows)
        if not bad:
            break
        a, b = next(iter(sorted(bad)))
        shared = np.intersect1d(rows[a], rows[b])
        col = int(shared[0])
        # Row `b` (the later one) lives in strip b // (n//k).
        strip_id = b // (n // k)
        perm = strips[strip_id]
        pos = int(np.flatnonzero(perm == col)[0])
        other = int(rng.integers(n))
        perm[pos], perm[other] = perm[other], perm[pos]
    # Best-effort: at very small n a 4-cycle-free (j,k)-regular graph may be
    # unreachable by swaps; shipping codes (n=1008) are verified cycle-free
    # by tests/unit/test_codes.py.

    spec = CodeSpec(
        name=f"gallager{n}.{j}.{k}.s{seed}",
        n=n,
        m=n * j // k,
        row_cols=tuple(all_rows()),
    )
    # Gallager ensembles have j-1 guaranteed row dependencies (each strip's
    # rows sum to the all-ones vector), so the true message length exceeds
    # n - m; record it from the actual GF(2) rank.
    from ..encode.gf2 import gf2_rank

    true_k = n - gf2_rank(spec.dense())
    return dataclasses.replace(spec, k=true_k)


def gallager_36(n: int, seed: int = 0) -> CodeSpec:
    """(3,6)-regular rate-1/2 code (config 1 shape, BASELINE.json:7)."""
    return gallager_regular(n, 3, 6, seed=seed)
