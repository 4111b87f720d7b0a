"""CodeSpec: the host-side sparse parity-check matrix representation.

A copy of ecc_ldpc_tpu/codes/spec.py (NumPy only). The canonical form is a
sparse row-adjacency list (per-check column indices), which scales to
n=64800 DVB-S2 codes where a dense H would be ~2 GB. The decoders' tables
are derived from the QC structure by graph/qc.py.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A binary LDPC code defined by its parity-check matrix H (m x n).

    Attributes:
      name: human-readable identifier (also used by the CLI registry).
      n: codeword length (number of variable nodes / columns of H).
      m: number of parity checks (rows of H). May include redundant rows.
      row_cols: tuple of m int32 arrays; row_cols[i] holds the sorted, unique
        column indices of the nonzeros in row i of H.
      k: message length. Defaults to n - m; standards codes with redundant
        rows or punctured/filler structure override it.
      qc: optional QC structure (set by codes/qc.py) enabling roll-based
        decode kernels; None for unstructured codes.
      punctured_cols: codeword positions never transmitted (e.g. 5G NR's
        leading 2*Zc systematic puncture). LLR=0 at the receiver.
      shortened_cols: positions known-zero at the transmitter (filler bits).
        Transmitted neither; receiver treats them as infinitely reliable 0.
    """

    name: str
    n: int
    m: int
    row_cols: tuple
    k: Optional[int] = None
    qc: Optional[object] = None
    punctured_cols: tuple = ()
    shortened_cols: tuple = ()

    def __post_init__(self):
        if len(self.row_cols) != self.m:
            raise ValueError(f"row_cols has {len(self.row_cols)} rows, m={self.m}")
        if self.k is None:
            object.__setattr__(self, "k", self.n - self.m)
        object.__setattr__(
            self, "row_cols", tuple(np.asarray(r, dtype=np.int32) for r in self.row_cols)
        )

    # -- derived views ------------------------------------------------------

    @functools.cached_property
    def col_rows(self) -> tuple:
        """Per-column row indices (the transpose adjacency)."""
        cols = [[] for _ in range(self.n)]
        for i, r in enumerate(self.row_cols):
            for c in r:
                cols[int(c)].append(i)
        return tuple(np.asarray(c, dtype=np.int32) for c in cols)

    @functools.cached_property
    def num_edges(self) -> int:
        return int(sum(len(r) for r in self.row_cols))

    @functools.cached_property
    def row_deg(self) -> np.ndarray:
        return np.asarray([len(r) for r in self.row_cols], dtype=np.int32)

    @functools.cached_property
    def col_deg(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.int32)
        for r in self.row_cols:
            d[r] += 1
        return d

    @property
    def rate(self) -> float:
        """Design rate over *transmitted* bits."""
        n_tx = self.n - len(self.punctured_cols) - len(self.shortened_cols)
        return self.k / n_tx

    def dense(self, max_cells: int = 64_000_000) -> np.ndarray:
        """Dense H as uint8 — only for small codes / tests.

        max_cells guards against accidental multi-GB materialization
        (DVB-S2 n=64800 would be ~2.1e9 cells); callers that have decided
        to pay for a large dense H (encode.DenseEncoder.build on codes
        with no structured encoder, e.g. CCSDS k=16384) raise it
        explicitly."""
        if self.n * self.m > max_cells:
            raise ValueError(f"refusing dense H for {self.m}x{self.n}")
        H = np.zeros((self.m, self.n), dtype=np.uint8)
        for i, r in enumerate(self.row_cols):
            H[i, r] = 1
        return H

    @staticmethod
    def from_dense(H: np.ndarray, name: str = "dense", **kw) -> "CodeSpec":
        H = np.asarray(H)
        rows = tuple(np.flatnonzero(H[i]).astype(np.int32) for i in range(H.shape[0]))
        return CodeSpec(name=name, n=H.shape[1], m=H.shape[0], row_cols=rows, **kw)

    def check_syndrome(self, codeword: np.ndarray) -> bool:
        """True iff H @ codeword == 0 (mod 2). codeword: (..., n) in {0,1}."""
        cw = np.asarray(codeword, dtype=np.int64)
        for r in self.row_cols:
            if np.any(cw[..., r].sum(axis=-1) % 2):
                return False
        return True
