"""Quasi-cyclic (QC) LDPC structure: base matrix + block lifting.

Port of ecc_ldpc_tpu/codes/qc.py (QCCode, QCMultiCode, QCXorCode, circulant,
expand_qc, expand_qc_multi, expand_qc_xor); NumPy only.

Convention: a block with shift s is P^s where P is the Z x Z identity
cyclically shifted so that row r has its 1 in column (r + s) mod Z. shift -1
denotes the all-zero block. This matches IEEE 802.11n / 802.16e / 3GPP 38.212
published base-matrix tables. On the GPU a circulant is index arithmetic:
check r of a block reads variable (r + s) % Z of its block-column. A
QCXorCode's block (perm "xor") maps check r to variable r ^ s instead.
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
    perm = "roll"

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


@dataclasses.dataclass(frozen=True)
class QCMultiCode:
    """Multi-edge QC structure: explicit (block_row, block_col, shift) triples.

    Unlike QCCode's one-shift-per-cell base matrix, this admits PARALLEL
    block-edges — two or three circulants summed in one base cell, the
    I + P^s cells of protograph families like CCSDS AR4JA. Shifts within a
    cell must be distinct (equal shifts would cancel over GF(2)). Exposes
    the same (Z, mb, nb, block_edges()) surface the graph compiler
    consumes, so every QC decoder serves these codes; the layered decoders
    take their accumulate form on them (graph/qc.py intra_layer_dup_free)."""

    Z: int
    mb: int
    nb: int
    br: np.ndarray  # int32 [BE] block-row per edge
    bc: np.ndarray  # int32 [BE] block-col per edge
    sh: np.ndarray  # int32 [BE] circulant shift per edge, in [0, Z)
    perm = "roll"

    def __post_init__(self):
        br = np.asarray(self.br, dtype=np.int32)
        bc = np.asarray(self.bc, dtype=np.int32)
        sh = np.asarray(self.sh, dtype=np.int32)
        if not (len(br) == len(bc) == len(sh)):
            raise ValueError("br, bc, sh must have equal length")
        if len(br) and (br.min() < 0 or br.max() >= self.mb):
            raise ValueError("block row out of range")
        if len(bc) and (bc.min() < 0 or bc.max() >= self.nb):
            raise ValueError("block col out of range")
        if len(sh) and (sh.min() < 0 or sh.max() >= self.Z):
            raise ValueError("shift out of range")
        cells = {}
        for r, c, s in zip(br, bc, sh):
            key = (int(r), int(c))
            if int(s) in cells.setdefault(key, set()):
                raise ValueError(
                    f"parallel edges in cell {key} share shift {int(s)} "
                    f"(would cancel over GF(2))"
                )
            cells[key].add(int(s))
        object.__setattr__(self, "br", br)
        object.__setattr__(self, "bc", bc)
        object.__setattr__(self, "sh", sh)

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def n(self) -> int:
        return self.nb * self.Z

    def block_edges(self):
        return self.br, self.bc, self.sh


def expand_qc_multi(qcm: QCMultiCode, name: str = "qc", **kw) -> CodeSpec:
    """Lift an explicit block-edge list into a CodeSpec."""
    Z = qcm.Z
    r = np.arange(Z, dtype=np.int32)
    rows = []
    for bi in range(qcm.mb):
        e = np.flatnonzero(qcm.br == bi)
        # row bi*Z + r has 1s at cols bc[e]*Z + (r + sh[e]) % Z
        cols = qcm.bc[e][None, :] * Z + (r[:, None] + qcm.sh[e][None, :]) % Z
        cols = np.sort(cols.astype(np.int32), axis=1)
        if cols.shape[1] > 1 and np.any(cols[:, 1:] == cols[:, :-1]):
            raise ValueError("duplicate lifted entries (parallel-edge clash)")
        rows.extend(cols)
    return CodeSpec(
        name=name, n=qcm.n, m=qcm.m, row_cols=tuple(rows), qc=qcm, **kw
    )


@dataclasses.dataclass(frozen=True)
class QCXorCode:
    """Base matrix lifted by Z x Z XOR-permutation blocks (perm="xor").

    A block with shift s maps check row r to variable r ^ s — the
    GF(2)-additive permutation family of the IEEE 802.3an RS-LDPC
    construction (codes/ieee8023an.py). Z must be a power of two. Same
    (Z, mb, nb, block_edges()) surface as QCCode, so the graph compiler and
    every QC decoder serve these codes (graph/qc.py var_index)."""

    Z: int
    base: np.ndarray  # int32 [mb, nb]; -1 = zero block, s in [0, Z)
    perm = "xor"

    def __post_init__(self):
        if self.Z & (self.Z - 1) or self.Z <= 0:
            raise ValueError(f"xor lifting needs power-of-two Z, got {self.Z}")
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
        br, bc = np.nonzero(self.base >= 0)
        return br.astype(np.int32), bc.astype(np.int32), self.base[br, bc]


def expand_qc_xor(qc: QCXorCode, name: str = "qc", **kw) -> CodeSpec:
    """Lift a XOR base matrix into a CodeSpec (sparse row adjacency)."""
    Z = qc.Z
    rows = []
    for bi in range(qc.mb):
        shifts = qc.base[bi]
        nz = np.flatnonzero(shifts >= 0)
        for r in range(Z):
            cols = nz * Z + (r ^ shifts[nz])
            rows.append(np.sort(cols).astype(np.int32))
    return CodeSpec(
        name=name, n=qc.n, m=qc.m, row_cols=tuple(rows), qc=qc, **kw
    )


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
