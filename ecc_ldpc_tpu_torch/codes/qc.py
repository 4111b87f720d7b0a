"""Quasi-cyclic (QC) LDPC structure: base matrix + circulant lifting.

Port of ecc_ldpc_tpu/codes/qc.py (QCCode, circulant, expand_qc); NumPy only.

Convention: a block with shift s is P^s where P is the Z x Z identity
cyclically shifted so that row r has its 1 in column (r + s) mod Z. shift -1
denotes the all-zero block. This matches IEEE 802.11n / 802.16e / 3GPP 38.212
published base-matrix tables. On the GPU a circulant is index arithmetic:
check r of a block reads variable (r + s) % Z of its block-column.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .spec import CodeSpec


@dataclasses.dataclass(frozen=True)
class QCCode:
    """Base matrix (mb x nb of shifts) lifted by circulant size Z."""

    Z: int
    base: np.ndarray  # int32 [mb, nb]; -1 = zero block, s in [0, Z) = P^s

    def __post_init__(self):
        b = np.asarray(self.base, dtype=np.int32)
        if np.any(b >= self.Z):
            raise ValueError("shift >= Z in base matrix")
        object.__setattr__(self, "base", b)

    @property
    def mb(self) -> int:
        return self.base.shape[0]

    @property
    def nb(self) -> int:
        return self.base.shape[1]

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def n(self) -> int:
        return self.nb * self.Z

    def block_edges(self):
        """Nonzero blocks as (block_row, block_col, shift) int32 arrays."""
        br, bc = np.nonzero(self.base >= 0)
        return br.astype(np.int32), bc.astype(np.int32), self.base[br, bc]


def circulant(Z: int, shift: int) -> np.ndarray:
    """Dense P^shift (for tests): row r has 1 at column (r+shift) % Z."""
    P = np.zeros((Z, Z), dtype=np.uint8)
    r = np.arange(Z)
    P[r, (r + shift) % Z] = 1
    return P


def expand_qc(qc: QCCode, name: str = "qc", **kw) -> CodeSpec:
    """Lift the base matrix into a CodeSpec (sparse row adjacency)."""
    Z = qc.Z
    rows = []
    for bi in range(qc.mb):
        shifts = qc.base[bi]
        nz = np.flatnonzero(shifts >= 0)
        # row bi*Z + r has a 1 at column bj*Z + (r + s) % Z for each block
        for r in range(Z):
            cols = nz * Z + (r + shifts[nz]) % Z
            rows.append(np.sort(cols).astype(np.int32))
    return CodeSpec(
        name=name, n=qc.n, m=qc.m, row_cols=tuple(rows), qc=qc, **kw
    )
