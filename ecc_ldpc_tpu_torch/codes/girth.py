"""QC 4-cycle census and shift optimizers used by the surrogate
constructions (codes/dvbs2.py, codes/ccsds.py, codes/ieee80211n.py,
codes/nr5g.py, codes/sc.py).

Copies of block_4cycle_violations, chain_conflicts, the base-matrix
optimizer optimize_shifts (coordinate descent under the chain-shift rule)
and the edge-list optimizer (_edge_quadruples, edge_4cycle_count,
optimize_edge_shifts) from ecc_ldpc_tpu/codes/girth.py, with the same RNG
calls in the same order, so the same seed draws the same shifts; the port
keeps its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

_BIG = 1 << 30


def block_4cycle_violations(base: np.ndarray, Z: int):
    """QC 4-cycles: rows i1<i2 sharing cols j1<j2 with
    s[i1,j1]-s[i1,j2]+s[i2,j2]-s[i2,j1] == 0 (mod Z)."""
    mb, nb = base.shape
    viol = []
    for i1 in range(mb):
        for i2 in range(i1 + 1, mb):
            shared = np.flatnonzero((base[i1] >= 0) & (base[i2] >= 0))
            for a in range(len(shared)):
                for b in range(a + 1, len(shared)):
                    j1, j2 = shared[a], shared[b]
                    if (base[i1, j1] - base[i1, j2]
                            + base[i2, j2] - base[i2, j1]) % Z == 0:
                        viol.append((i1, i2, j1, j2))
    return viol


def chain_conflicts(base: np.ndarray, ncols: int, dist: int):
    """(row_a, row_b, col) triples with equal shifts at rows within `dist`
    in one of the first `ncols` columns."""
    out = []
    for j in range(ncols):
        rows = np.flatnonzero(base[:, j] >= 0)
        for x in range(len(rows)):
            for y in range(x + 1, len(rows)):
                a, b = int(rows[x]), int(rows[y])
                if b - a <= dist and base[a, j] == base[b, j]:
                    out.append((a, b, j))
    return out


def optimize_shifts(
    base: np.ndarray,
    Z: int,
    free,
    seed: int,
    *,
    chain_dist: int = 0,
    chain_ncols: int = 0,
    max_passes: int = 50,
    kicks: int = 24,
    kick_threshold: int = 8,
) -> np.ndarray:
    """Minimize lifted 4-cycles by coordinate descent on the shifts where
    free(i, j) is True (ties keep the current shift — a clean table comes
    back unchanged). When zero isn't reached directly and the residual is
    small, random-restart kicks (deterministic rng from `seed`) perturb
    one violating cycle's free entries and re-descend in shuffled order;
    the best table seen wins. Residuals can be genuinely unavoidable:
    two rows sharing s columns pigeonhole-force collisions once s > Z.
    """
    base = base.copy()
    mb, nb = base.shape
    entries = [(i, j) for i in range(mb) for j in range(nb)
               if base[i, j] >= 0 and free(i, j)]
    rows_of_col = {j: np.flatnonzero(base[:, j] >= 0) for j in range(nb)}

    def descend(b, order_rng=None):
        for _ in range(max_passes):
            changed = False
            sweep = entries
            if order_rng is not None:
                sweep = [entries[t]
                         for t in order_rng.permutation(len(entries))]
            for i, j in sweep:
                cost = np.zeros(Z, np.int64)
                for i2 in rows_of_col[j]:
                    if i2 == i:
                        continue
                    shared = np.flatnonzero((b[i] >= 0) & (b[i2] >= 0))
                    shared = shared[shared != j]
                    if len(shared):
                        deltas = (b[i, shared] - b[i2, shared]) % Z
                        hist = np.bincount(deltas, minlength=Z)
                        # candidate v's delta is (v - s[i2,j]) % Z: a roll
                        cost += np.roll(hist, int(b[i2, j]))
                    if chain_dist and j < chain_ncols \
                            and abs(int(i2) - i) <= chain_dist:
                        cost[int(b[i2, j])] += _BIG
                best = int(np.argmin(cost))
                if cost[best] < cost[int(b[i, j])]:
                    b[i, j] = best
                    changed = True
            if not changed:
                return

    def total(b):
        t = len(block_4cycle_violations(b, Z))
        if chain_dist:
            t += _BIG * len(chain_conflicts(b, chain_ncols, chain_dist))
        return t

    rng = np.random.default_rng(seed)
    descend(base)
    best = base.copy()
    best_v = total(best)
    for _ in range(kicks if 0 < best_v <= kick_threshold else 0):
        b = best.copy()
        viols = block_4cycle_violations(b, Z)
        if not viols:
            break
        i1, i2, j1, j2 = viols[int(rng.integers(len(viols)))]
        touched = False
        for i, j in ((i1, j1), (i2, j1), (i1, j2), (i2, j2)):
            if free(i, int(j)):
                b[i, j] = rng.integers(0, Z)
                touched = True
        if not touched:
            break
        descend(b, order_rng=rng)
        v = total(b)
        if v < best_v:
            best, best_v = b.copy(), v
            if v == 0:
                break
    return best


# -- explicit edge-list form (multi-edge protographs) -----------------------
#
# QCMultiCode graphs (parallel circulants in one base cell, e.g. CCSDS
# AR4JA) don't fit the base-matrix optimizer above: a 4-cycle can run
# through TWO edges of the same cell, and even through parallel edges in
# one row pair (2*(s_a - s_b) == 0 mod Z). The quadruple form below is
# exact for edge lists, given the per-cell shift-distinctness QCMultiCode
# already enforces.


def _edge_quadruples(br, bc):
    """Structural 4-cycle templates (e1, e2, e3, e4) over an edge list.

    A lifted 4-cycle exists iff some quadruple with row(e1)==row(e4),
    row(e2)==row(e3), col(e1)==col(e2), col(e3)==col(e4), e1!=e4, e2!=e3,
    e1!=e2, e3!=e4 satisfies sh[e1]-sh[e2]+sh[e3]-sh[e4] == 0 (mod Z).
    (With distinct shifts per cell, the degenerate same-check/same-var
    cases all reduce to one of the excluded index equalities.) Each cycle
    appears multiple times by symmetry — fine for minimization."""
    br = np.asarray(br)
    bc = np.asarray(bc)
    E = len(br)
    # pairs (ei, ej) in the same row: ei at col cA, ej at col cB
    pairs = [(i, j) for i in range(E) for j in range(E)
             if i != j and br[i] == br[j]]
    quads = []
    for e1, e4 in pairs:
        for e2, e3 in pairs:
            if bc[e2] == bc[e1] and bc[e3] == bc[e4] and e1 != e2 and e3 != e4:
                quads.append((e1, e2, e3, e4))
    if not quads:
        return (np.zeros(0, np.int64),) * 4
    q = np.asarray(quads, np.int64)
    return q[:, 0], q[:, 1], q[:, 2], q[:, 3]


def edge_4cycle_count(br, bc, sh, Z: int) -> int:
    """Number of violated quadruples (0 iff the lifted graph is 4-cycle-free)."""
    e1, e2, e3, e4 = _edge_quadruples(br, bc)
    sh = np.asarray(sh, np.int64)
    return int(np.count_nonzero((sh[e1] - sh[e2] + sh[e3] - sh[e4]) % Z == 0))


def optimize_edge_shifts(br, bc, Z: int, seed: int = 0,
                         *, max_passes: int = 60, kicks: int = 24):
    """Deterministic 4-cycle-minimizing shifts for an explicit edge list.

    Coordinate descent: for each edge, quadruples it enters exactly once
    forbid one residue each (the linear solve of the cycle condition);
    quadruples it enters twice (parallel-edge pairs) forbid the <=2 roots
    of 2v == c (mod Z). Sibling shifts in the same cell are hard-forbidden
    (GF(2) cancellation). Exact recount accepts each pass; random kicks
    (rng from `seed`) escape small residuals."""
    br = np.asarray(br, np.int64)
    bc = np.asarray(bc, np.int64)
    E = len(br)
    rng = np.random.default_rng(seed)
    sh = np.zeros(E, np.int64)
    cells = {}
    for e in range(E):
        cells.setdefault((int(br[e]), int(bc[e])), []).append(e)
    for key, es in cells.items():
        picks = rng.choice(Z, size=len(es), replace=False)
        for e, s in zip(es, sorted(int(p) for p in picks)):
            sh[e] = s
    q1, q2, q3, q4 = _edge_quadruples(br, bc)

    def descend(s):
        for _ in range(max_passes):
            changed = False
            for e in range(E):
                cost = np.zeros(Z, np.int64)
                for slot, (a, b, c, d) in enumerate(
                        zip(q1, q2, q3, q4)):
                    quad = (a, b, c, d)
                    hits = [t for t, x in enumerate(quad) if x == e]
                    if not hits:
                        continue
                    # condition: s1 - s2 + s3 - s4 == 0 (mod Z)
                    sign = (1, -1, 1, -1)
                    const = -sum(sign[t] * s[quad[t]]
                                 for t in range(4) if quad[t] != e)
                    coef = sum(sign[t] for t in hits)
                    if coef == 0:
                        continue  # e.g. e in slots 1 and 2: always satisfied
                    const %= Z
                    if abs(coef) == 1:
                        cost[(coef * const) % Z] += 1
                    else:  # |coef| == 2: 2v == +-const (mod Z)
                        cc = (const * (1 if coef > 0 else -1)) % Z
                        if Z % 2 == 1:
                            cost[(cc * pow(2, -1, Z)) % Z] += 1
                        elif cc % 2 == 0:
                            cost[cc // 2] += 1
                            cost[cc // 2 + Z // 2] += 1
                sibs = [x for x in cells[(int(br[e]), int(bc[e]))] if x != e]
                for x in sibs:
                    cost[s[x]] += _BIG
                best = int(np.argmin(cost))
                if cost[best] < cost[s[e]]:
                    s[e] = best
                    changed = True
            if not changed:
                return

    def total(s):
        return int(np.count_nonzero((s[q1] - s[q2] + s[q3] - s[q4]) % Z == 0))

    descend(sh)
    best, best_v = sh.copy(), total(sh)
    for _ in range(kicks if best_v > 0 else 0):
        s = best.copy()
        bad = np.flatnonzero((s[q1] - s[q2] + s[q3] - s[q4]) % Z == 0)
        if not len(bad):
            break
        i = int(bad[int(rng.integers(len(bad)))])
        for e in (int(q1[i]), int(q3[i])):
            sibs = set(int(s[x]) for x in cells[(int(br[e]), int(bc[e]))])
            choices = [v for v in rng.integers(0, Z, size=8) if int(v) not in sibs]
            if choices:
                s[e] = int(choices[0])
        descend(s)
        v = total(s)
        if v < best_v:
            best, best_v = s.copy(), v
            if v == 0:
                break
    return best.astype(np.int32)
