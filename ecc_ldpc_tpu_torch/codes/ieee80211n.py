"""IEEE 802.11n QC-LDPC codes (config 3, BASELINE.json:9).

A verbatim copy of ecc_ldpc_tpu/codes/ieee80211n.py (the port imports
nothing of the JAX package): the same tables, repairs and girth search
give the same base matrices, which tests/test_torch_families.py checks.

Structure (802.11n-2009 Annex R): 24 block columns; Z = n/24 with
n in {648, 1296, 1944} => Z in {27, 54, 81}; rates 1/2, 2/3, 3/4, 5/6 with
mb = 24*(1-R) block rows. The parity part is dual-diagonal: a special first
parity column with three entries (shift 1 at the top row, 0 at a middle row,
1 at the bottom row) and an identity staircase (shift-0 double diagonal),
which encode/structured.py exploits for O(n) encoding.

TABLE PROVENANCE (no network in the build environment — SURVEY.md §7.2
item 4): all twelve (rate, Z) base matrices below are reproduced from
memory of the published standard (IEEE Std 802.11-2012 Annex F) — these
are among the most widely reprinted QC-LDPC tables in the literature.
Recall confidence varies per table and is recorded next to each one:
the rate-1/2 matrices (reprinted in essentially every layered-decoder
paper) are HIGH confidence; the higher-rate matrices are MEDIUM — the
protograph skeleton (dual-diagonal parity with the (1,0,1) special
column, row/column degree profile, -1 pattern) is solid, individual
shift values may carry recall errors. Every table is validated by
construction checks (G·H^T = 0 through the structured encoder, rank,
degree profile, lifted 4-cycle census — the standard tables are
girth-≥6 and every table below measures 4-cycle-free, a property random
shift errors would likely break) and by waterfall-position tests. A
shift-value error moves BER curves by fractions of a dB; it does not
change any capability the framework exposes.
"""
from __future__ import annotations

import numpy as np

from .qc import QCCode, expand_qc
from .spec import CodeSpec

# Rate-1/2, Z=27 (n=648) [recalled, HIGH confidence].
_R12_Z27 = """
 0 -1 -1 -1  0  0 -1 -1  0 -1 -1  0  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
22  0 -1 -1 17 -1  0  0 12 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
 6 -1  0 -1 10 -1 -1 -1 24 -1  0 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
 2 -1 -1  0 20 -1 -1 -1 25  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
23 -1 -1 -1  3 -1 -1 -1  0 -1  9 11 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
24 -1 23  1 17 -1  3 -1 10 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
25 -1 -1 -1  8 -1 -1 -1  7 18 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
13 24 -1 -1  0 -1  8 -1  6 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
 7 20 -1 16 22 10 -1 -1 23 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
11 -1 -1 -1 19 -1 -1 -1 13 -1  3 17 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
25 -1  8 -1 23 18 -1 14  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
 3 -1 -1 -1 16 -1 -1  2 25  5 -1 -1  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

# Rate-2/3, Z=27 (n=648) [recalled, MEDIUM confidence].
_R23_Z27 = """
25 26 14 -1 20 -1  2 -1  4 -1 -1  8 -1 16 -1 18  1  0 -1 -1 -1 -1 -1 -1
10  9 15 11 -1  0 -1  1 -1 -1 18 -1  8 -1 10 -1 -1  0  0 -1 -1 -1 -1 -1
16  2 20 26 21 -1  6 -1  1 26 -1  7 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
10 13  5  0 -1  3 -1  7 -1 -1 26 -1 -1 13 -1 16 -1 -1 -1  0  0 -1 -1 -1
23 14 24 -1 12 -1 19 -1 17 -1 -1 -1 20 -1 21 -1  0 -1 -1 -1  0  0 -1 -1
 6 22  9 20 -1 25 -1 17 -1  8 -1 14 -1 18 -1 -1 -1 -1 -1 -1 -1  0  0 -1
14 23 21 11 20 -1 24 -1 18 -1 19 -1 -1 -1 -1 22 -1 -1 -1 -1 -1 -1  0  0
17 11 11 20 -1 21 -1 26 -1  3 -1 -1 18 -1 26 -1  1 -1 -1 -1 -1 -1 -1  0
"""

# Rate-3/4, Z=27 (n=648) [recalled, MEDIUM confidence].
_R34_Z27 = """
16 17 22 24  9  3 14 -1  4  2  7 -1 26 -1  2 -1 21 -1  1  0 -1 -1 -1 -1
25 12 12  3  3 26  6 21 -1 15 22 -1 15 -1  4 -1 -1 16 -1  0  0 -1 -1 -1
25 18 26 16 22 23  9 -1  0 -1  4 -1  4 -1  8 23 11 -1 -1 -1  0  0 -1 -1
 9  7  0  1 17 -1 -1  7  3 -1  3 23 -1 16 -1 -1 21 -1  0 -1 -1  0  0 -1
24  5 26  7  1 -1 -1 15 24 15 -1  8 -1 13 -1 13 -1 11 -1 -1 -1 -1  0  0
 2  2 19 14 24  1 15 19 -1 21 -1  2 -1 24 -1  3 -1  2  1 -1 -1 -1 -1  0
"""

# Rate-5/6, Z=27 (n=648) [recalled, MEDIUM confidence].
_R56_Z27 = """
17 13  8 21  9  3 18 12 10  0  4 15 19  2  5 10 26 19 13 13  1  0 -1 -1
 3 12 11 14 11 25  5 18  0  9  2 26 26 10 24  7 14 20  4  2 -1  0  0 -1
22 16  4  3 10 21 12  5 21 14 19  5 -1  8  5 18 11  5  5 15  0 -1  0  0
 7  7 14 14  4 16 16 24 24 10  1  7 15  6 10 26  8 18 21 14  1 -1 -1  0
"""

# Rate-1/2, Z=54 (n=1296) [recalled, HIGH confidence].
_R12_Z54 = """
40 -1 -1 -1 22 -1 49 23 43 -1 -1 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
50  1 -1 -1 48 35 -1 -1 13 -1 30 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
39 50 -1 -1  4 -1  2 -1 -1 -1 -1 49 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
33 -1 -1 38 37 -1 -1  4  1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
45 -1 -1 -1  0 22 -1 -1 20 42 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
51 -1 -1 48 35 -1 -1 -1 44 -1 18 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
47 11 -1 -1 -1 17 -1 -1 51 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
 5 -1 25 -1  6 -1 45 -1 13 40 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
33 -1 -1 34 24 -1 -1 -1 23 -1 -1 46 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
 1 -1 27 -1  1 -1 -1 -1 38 -1 44 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
-1 18 -1 -1 23 -1 -1  8  0 35 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
49 -1 17 -1 30 -1 -1 -1 34 -1 -1 19  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

# Rate-2/3, Z=54 (n=1296) [recalled, MEDIUM confidence].
_R23_Z54 = """
39 31 22 43 -1 40  4 -1 11 -1 -1 50 -1 -1 -1  6  1  0 -1 -1 -1 -1 -1 -1
25 52 41  2  6 -1 14 -1 34 -1 -1 -1 24 -1 37 -1 -1  0  0 -1 -1 -1 -1 -1
43 31 29  0 21 -1 28 -1 -1  2 -1 -1  7 -1 17 -1 -1 -1  0  0 -1 -1 -1 -1
20 33 48 -1  4 13 -1 26 -1 -1 22 -1 -1 46 42 -1 -1 -1 -1  0  0 -1 -1 -1
45  7 18 51 12 25 -1 -1 -1 50 -1 -1  5 -1 -1 -1  0 -1 -1 -1  0  0 -1 -1
35 40 32 16  5 -1 -1 18 -1 -1 43 51 -1 32 -1 -1 -1 -1 -1 -1 -1  0  0 -1
 9 24 13 22 28 -1 -1 37 -1 -1 25 -1 -1 52 -1 13 -1 -1 -1 -1 -1 -1  0  0
32 22  4 21 16 -1 -1 -1 27 28 -1 38 -1 -1 -1  8  1 -1 -1 -1 -1 -1 -1  0
"""

# Rate-3/4, Z=54 (n=1296) [recalled, MEDIUM confidence].
_R34_Z54 = """
39 40 51 41  3 29  8 36 -1 14 -1  6 -1 33 -1 11 -1  4  1  0 -1 -1 -1 -1
48 21 47  9 48 35 51 -1 38 -1 28 -1 34 -1 50 -1 50 -1 -1  0  0 -1 -1 -1
30 39 28 42 50 39  5 17 -1  6 -1 18 -1 20 -1 15 -1 40 -1 -1  0  0 -1 -1
29  0  1 43 36 30 47 -1 49 -1 47 -1  3 -1 35 -1 34 -1  0 -1 -1  0  0 -1
 1 32 11 23 10 44 12  7 -1 48 -1  4 -1  9 -1 17 -1 16 -1 -1 -1 -1  0  0
13  7 15 47 23 16 47 -1 43 -1 29 -1 52 -1  2 -1 53 -1  1 -1 -1 -1 -1  0
"""

# Rate-5/6, Z=54 (n=1296) [recalled, MEDIUM confidence].
_R56_Z54 = """
48 29 37 52  2 16  6 14 53 31 34  5 18 42 53 31 45 -1 46 52  1  0 -1 -1
17  4 30  7 43 11 24  6 14 21  6 39 17 40 47  7 15 41 19 -1 -1  0  0 -1
 7  2 51 31 46 23 16 11 53 40 10  7 46 53 33 35 -1 25 35 38  0 -1  0  0
19 48 41  1 10  7 36 47  5 29 52 52 31 10 26  6  3  2 -1 51  1 -1 -1  0
"""

# Rate-1/2, Z=81 (n=1944) [recalled, HIGH confidence].
_R12_Z81 = """
57 -1 -1 -1 50 -1 11 -1 50 -1 79 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
 3 -1 28 -1  0 -1 -1 -1 55  7 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
30 -1 -1 -1 24 37 -1 -1 56 14 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
62 53 -1 -1 53 -1 -1  3 35 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
40 -1 -1 20 66 -1 -1 22 28 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
 0 -1 -1 -1  8 -1 42 -1 50 -1 -1  8 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
69 79 79 -1 -1 -1 56 -1 52 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
65 -1 -1 -1 38 57 -1 -1 72 -1 27 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
64 -1 -1 -1 14 52 -1 -1 30 -1 -1 32 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
-1 45 -1 70  0 -1 -1 -1 77  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
 2 56 -1 57 35 -1 -1 -1 -1 -1 12 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
24 -1 61 -1 60 -1 -1 27 51 -1 -1 16  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

# Rate-2/3, Z=81 (n=1944) [recalled, MEDIUM confidence].
_R23_Z81 = """
61 75  4 63 56 -1 -1 -1 -1 -1 -1  8 -1  2 17 25  1  0 -1 -1 -1 -1 -1 -1
56 74 77 20 -1 -1 -1 64 24  4 67 -1  7 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
28 21 68 10  7 14 65 -1 -1 -1 23 -1 -1 -1 75 -1 -1 -1  0  0 -1 -1 -1 -1
48 38 43 78 76 -1 -1 -1 -1  5 36 -1 15 72 -1 -1 -1 -1 -1  0  0 -1 -1 -1
40  2 53 25 -1 52 62 -1 20 -1 -1 44 -1 -1 -1 -1  0 -1 -1 -1  0  0 -1 -1
69 23 64 10 22 -1 21 -1 -1 -1 -1 -1 68 23 29 -1 -1 -1 -1 -1 -1  0  0 -1
12  0 68 20 55 61 -1 40 -1 -1 -1 52 -1 -1 -1 44 -1 -1 -1 -1 -1 -1  0  0
58  8 34 64 78 -1 -1 11 78 24 -1 -1 -1 -1 -1 58  1 -1 -1 -1 -1 -1 -1  0
"""

# Rate-3/4, Z=81 (n=1944) [recalled, MEDIUM confidence].
_R34_Z81 = """
48 29 28 39  9 61 -1 -1 -1 63 45 80 -1 -1 -1 37 32 22  1  0 -1 -1 -1 -1
 4 49 42 48 11 30 -1 -1 -1 49 17 41 37 15 -1 54 -1 -1 -1  0  0 -1 -1 -1
35 76 78 51 37 35 21 -1 17 64 -1 -1 -1 59  7 -1 -1 32 -1 -1  0  0 -1 -1
 9 65 44  9 54 56 73 34 42 -1 -1 -1 35 -1 -1 -1 46 39  0 -1 -1  0  0 -1
 3 62  7 80 68 26 -1 80 55 -1 36 -1 26 -1  9 -1 72 -1 -1 -1 -1 -1  0  0
26 75 33 21 69 59  3 38 -1 -1 -1 35 -1 62 36 26 -1 -1  1 -1 -1 -1 -1  0
"""

# Rate-5/6, Z=81 (n=1944) [recalled, MEDIUM confidence].
_R56_Z81 = """
13 48 80 66  4 74  7 30 76 52 37 60 -1 49 73 31 74 73 23 -1  1  0 -1 -1
69 63 74 56 64 77 57 65  6 16 51 -1 64 -1 68  9 48 62 54 27 -1  0  0 -1
51 15  0 80 24 25 42 54 44 71 71  9 67 35 -1 58 -1 29 -1 53  0 -1  0  0
16 29 36 41 44 56 59 37 50 24 -1 65  4 65 52 -1  4 -1 73 52  1 -1 -1  0
"""

_TABLES = {
    (27, "12"): _R12_Z27, (27, "23"): _R23_Z27,
    (27, "34"): _R34_Z27, (27, "56"): _R56_Z27,
    (54, "12"): _R12_Z54, (54, "23"): _R23_Z54,
    (54, "34"): _R34_Z54, (54, "56"): _R56_Z54,
    (81, "12"): _R12_Z81, (81, "23"): _R23_Z81,
    (81, "34"): _R34_Z81, (81, "56"): _R56_Z81,
}

# GIRTH REPAIRS. The standard's tables are 4-cycle-free; after recall,
# 9 of 12 tables measure exactly that, and three carry 1-2 lifted
# 4-cycles — i.e. the colliding cells were certainly mis-recalled
# (a recall error in a random cell has ~deg/Z odds of closing a cycle,
# so a handful of errors across ~1000 cells is the expected signature).
# The minimal repair set below (found by exhaustive 1-2 cell search)
# restores the girth property; repaired values are deterministic but NOT
# claimed to match the standard. Every other cell is as recalled.
_REPAIRS = {
    (27, "34"): {(0, 8): 0, (1, 0): 7},
    (54, "23"): {(1, 1): 6, (3, 0): 0},
    (81, "23"): {(3, 0): 1},
}

RATES = {"12": 0.5, "23": 2 / 3, "34": 3 / 4, "56": 5 / 6}
BLOCK_COLS = 24
VALID_N = {648: 27, 1296: 54, 1944: 81}


def _parse_table(text: str) -> np.ndarray:
    rows = [r.split() for r in text.strip().splitlines()]
    return np.asarray([[int(x) for x in r] for r in rows], dtype=np.int32)


# canonical home is codes/girth.py; re-exported for existing importers
from .girth import block_4cycle_violations as _block_4cycle_violations  # noqa: E402


def surrogate_base(mb: int, nb: int, Z: int, seed: int, heavy_cols: int = 2,
                   info_weight: int = 3) -> np.ndarray:
    """Structure-faithful surrogate base matrix: dual-diagonal parity part,
    `heavy_cols` full-weight info columns, remaining info columns of weight
    `info_weight`; deterministic shifts, QC-girth repaired."""
    rng = np.random.default_rng(seed)
    kb = nb - mb
    base = -np.ones((mb, nb), dtype=np.int32)
    # special parity column: (1, 0, 1)
    base[0, kb] = 1
    base[mb // 2, kb] = 0
    base[mb - 1, kb] = 1
    # staircase
    for d in range(mb - 1):
        base[d, kb + 1 + d] = 0
        base[d + 1, kb + 1 + d] = 0
    # heavy info columns
    for j in range(heavy_cols):
        base[:, j] = rng.integers(0, Z, mb)
    # light info columns: `info_weight` entries, rows chosen to keep row
    # degrees balanced (standards rows are near-uniform degree; unbalanced
    # rows inflate dcb_max and with it decoder state/padding)
    deg = (base >= 0).sum(axis=1)
    for j in range(heavy_cols, kb):
        order = np.argsort(deg + rng.random(mb) * 0.5)
        rows = order[:info_weight]
        base[rows, j] = rng.integers(0, Z, info_weight)
        deg[rows] += 1
    # girth repair on shifts only (structure fixed)
    for _ in range(2000):
        viol = _block_4cycle_violations(base, Z)
        viol = [v for v in viol if v[2] < kb or v[3] < kb]  # don't touch parity
        if not viol:
            break
        i1, i2, j1, j2 = viol[0]
        j = j1 if j1 < kb else j2
        base[i2 if j1 < kb else i1, j] = rng.integers(0, Z)
    # chain-cycle repair: equal shifts at nearby rows of one column close a
    # short bit-level cycle through the shift-0 staircase (see codes/dvbs2
    # for the measured failure mode); forbid within row distance 8
    if Z > 1:
        for _ in range(1000):
            fixed = True
            for j in range(kb):
                rows = np.flatnonzero(base[:, j] >= 0)
                for x in range(len(rows)):
                    for y in range(x + 1, len(rows)):
                        a, b = rows[x], rows[y]
                        if abs(int(b) - int(a)) <= 8 and base[a, j] == base[b, j]:
                            base[b, j] = rng.integers(0, Z)
                            fixed = False
            if fixed:
                break
    # the greedy loops above can stall (and the chain pass can undo 4-cycle
    # fixes); finish with the coordinate-descent optimizer, which respects
    # the chain rule as a hard constraint and is a no-op on a clean table
    from .girth import block_4cycle_violations, chain_conflicts, optimize_shifts

    if block_4cycle_violations(base, Z) or chain_conflicts(base, kb, 8):
        base = optimize_shifts(
            base, Z, free=lambda i, j: j < kb, seed=seed + 7_777,
            chain_dist=8, chain_ncols=kb,
        )
    return base


def ieee80211n(n: int, rate: str) -> CodeSpec:
    """rate: '12' | '23' | '34' | '56' (e.g. ieee80211n(648, '12'))."""
    if n not in VALID_N:
        raise ValueError(f"802.11n n must be one of {sorted(VALID_N)}, got {n}")
    if rate not in RATES:
        raise ValueError(f"802.11n rate must be one of {sorted(RATES)}, got {rate!r}")
    Z = VALID_N[n]
    R = RATES[rate]
    mb = round(BLOCK_COLS * (1 - R))
    base = _parse_table(_TABLES[(Z, rate)])
    if base.shape != (mb, BLOCK_COLS):
        raise AssertionError(
            f"table {(Z, rate)} is {base.shape}, want {(mb, BLOCK_COLS)}"
        )
    provenance = "recalled"
    repairs = _REPAIRS.get((Z, rate), {})
    if repairs:
        import warnings

        # ADVICE r2 item 1: make the repaired cells impossible to miss at
        # construction time, not just in the spec name — these cells are
        # girth-restoring but NOT claimed to match the standard, so a
        # codeword exchange with a compliant 802.11n transmitter may fail
        # for exactly these (rate, Z) tables.
        warnings.warn(
            f"802.11n (Z={Z}, rate={rate}) table carries {len(repairs)} "
            f"girth-repaired cell(s) at {sorted(repairs)} that are not "
            f"claimed to match IEEE Std 802.11 Annex F; curves are "
            f"self-consistent but interop with a compliant transmitter "
            f"is unverified for this table (see _REPAIRS provenance note)",
            stacklevel=2,
        )
    for (i, j), v in repairs.items():
        base[i, j] = v
        provenance = "recalled-repaired"
    qc = QCCode(Z=Z, base=base)
    spec = expand_qc(qc, name=f"80211n.{n}.{rate}.{provenance}", k=(BLOCK_COLS - mb) * Z)
    return spec
