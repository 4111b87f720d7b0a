"""Host-side GF(2) linear algebra (port of ecc_ldpc_tpu/encode/gf2.py;
NumPy only, verbatim, so that elimination picks the same pivots).

Rows are packed 64 columns per uint64 word.
"""
from __future__ import annotations

import numpy as np


def pack_rows(H: np.ndarray) -> np.ndarray:
    """uint8 [m, n] -> uint64 [m, ceil(n/64)] little-endian bit packing."""
    m, n = H.shape
    words = (n + 63) // 64
    packed = np.zeros((m, words), dtype=np.uint64)
    bits = np.asarray(H, dtype=np.uint64)
    for w in range(words):
        chunk = bits[:, w * 64: (w + 1) * 64]
        shifts = np.arange(chunk.shape[1], dtype=np.uint64)
        packed[:, w] = (chunk << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    return packed


def unpack_rows(packed: np.ndarray, n: int) -> np.ndarray:
    m, words = packed.shape
    out = np.zeros((m, words * 64), dtype=np.uint8)
    for w in range(words):
        col = packed[:, w]
        shifts = np.arange(64, dtype=np.uint64)
        out[:, w * 64: (w + 1) * 64] = (
            (col[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return out[:, :n]


def gf2_row_reduce(H: np.ndarray):
    """Row-reduce H over GF(2) with column pivot tracking.

    Returns (R, pivot_cols): R is the reduced matrix (same shape, rows beyond
    rank are zero), pivot_cols the column index of each pivot (len = rank),
    with R[r, pivot_cols[r]] = 1 and every other row 0 in pivot columns.
    """
    H = np.asarray(H, dtype=np.uint8)
    m, n = H.shape
    P = pack_rows(H)
    pivot_cols = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        w, b = divmod(c, 64)
        colbit = (P[r:, w] >> np.uint64(b)) & np.uint64(1)
        nz = np.flatnonzero(colbit)
        if len(nz) == 0:
            continue
        p = r + int(nz[0])
        if p != r:
            P[[r, p]] = P[[p, r]]
        # eliminate this column from all other rows that have it
        has = ((P[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        has[r] = False
        P[has] ^= P[r]
        pivot_cols.append(c)
        r += 1
    return unpack_rows(P, n), np.asarray(pivot_cols, dtype=np.int64)


def gf2_rank(H: np.ndarray) -> int:
    return len(gf2_row_reduce(H)[1])


def gf2_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(A @ B) mod 2 for 0/1 matrices (host-side), accumulated in float64:
    exact, since every dot product is an integer far below 2^53."""
    acc = A.astype(np.float64) @ B.astype(np.float64)
    return (acc.astype(np.int64) & 1).astype(np.uint8)
