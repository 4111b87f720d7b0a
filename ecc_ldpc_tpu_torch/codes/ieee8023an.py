"""IEEE 802.3an 10GBASE-T RS-LDPC (2048, 1723) construction (a copy of
ecc_ldpc_tpu/codes/ieee8023an.py; NumPy only).

GF(64) with primitive polynomial x^6 + x + 1; a shortened (32, 2)
Reed-Solomon code evaluates the degree-<=1 polynomials a + b*x at 32
field points (0, 1, alpha, ..., alpha^30). The location vectors of the
coset {a + b*x : a in GF(64)} of one slope b are disjoint and stack into a
64 x 2048 block with one 1 per column; six slopes (1, alpha, ..., alpha^5)
stack into the (6, 32)-regular 384 x 2048 H. Rank(H) = 325 over GF(2), so
k = 2048 - 325 = 1723, the published dimension (checked at build time).

Each 64 x 64 block is the XOR permutation a -> a ^ (b*p), so the spec
carries a QCXorCode (codes/qc.py): a [6, 32] base matrix of xor shifts,
every cell occupied. The slope and point orderings are the reference's
deterministic choice, not the standard's (a structure-exact surrogate).
Encoding is the dense systematic generator (encode/dense.py).

Spec string: 8023an
"""
from __future__ import annotations

import numpy as np

from .spec import CodeSpec

_Q = 64
_PRIM = 0b1000011  # x^6 + x + 1


def _gf64_tables():
    exp = np.zeros(2 * _Q, dtype=np.int64)
    log = np.zeros(_Q, dtype=np.int64)
    x = 1
    for i in range(_Q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & _Q:
            x ^= _PRIM
    exp[_Q - 1:] = exp[: _Q + 1]
    return exp, log


def rs_ldpc_H(n_points: int = 32, slopes=None) -> np.ndarray:
    """Binary H of the RS-based LDPC: one 64-row block per slope.

    Rows of block for slope b: location vectors of {a + b*x : a}
    evaluated at the chosen points. (len(slopes), n_points)-regular.
    """
    exp, log = _gf64_tables()
    if slopes is None:
        slopes = [int(exp[i]) for i in range(6)]  # 1, alpha, ..., alpha^5
    points = [0] + [int(exp[i]) for i in range(n_points - 1)]
    if len(set(points)) != n_points or n_points > _Q:
        raise ValueError(f"need {n_points} distinct points in GF(64)")
    H = np.zeros((_Q * len(slopes), _Q * n_points), dtype=np.uint8)
    for ci, b in enumerate(slopes):
        for j, p in enumerate(points):
            # b*p is constant down the coset; a + b*p sweeps GF(64)
            bp = 0 if (b == 0 or p == 0) else int(exp[log[b] + log[p]])
            for a in range(_Q):
                H[ci * _Q + a, j * _Q + (a ^ bp)] = 1
    return H


def xor_base(n_points: int = 32, slopes=None) -> np.ndarray:
    """The [len(slopes), n_points] base matrix of xor-shifts: cell (ci, j)
    holds bp = slopes[ci] * points[j] in GF(64) — block row a has its 1 at
    block column position a ^ bp, exactly rs_ldpc_H's placement."""
    exp, log = _gf64_tables()
    if slopes is None:
        slopes = [int(exp[i]) for i in range(6)]
    points = [0] + [int(exp[i]) for i in range(n_points - 1)]
    base = np.zeros((len(slopes), n_points), dtype=np.int32)
    for ci, b in enumerate(slopes):
        for j, p in enumerate(points):
            base[ci, j] = 0 if (b == 0 or p == 0) else int(exp[log[b] + log[p]])
    return base


def ieee8023an() -> CodeSpec:
    """The (2048, 1723) 10GBASE-T class code (structure-exact surrogate)."""
    from ..encode.gf2 import gf2_rank
    from .qc import QCXorCode, expand_qc_xor

    spec = expand_qc_xor(QCXorCode(Z=_Q, base=xor_base()), name="8023an",
                         k=1723)
    rank = gf2_rank(spec.dense())
    k = spec.n - rank
    if k != 1723:  # the published dimension is the construction's anchor
        raise AssertionError(f"RS-LDPC rank self-check failed: k={k} != 1723")
    return spec
