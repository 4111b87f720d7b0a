"""Compiled quasi-cyclic graph: block-edge tables (port of
ecc_ldpc_tpu/graph/qc.py).

The tables are NumPy; `QCGraph.to(device)` gives their int32/bool tensors.
Check r of block-edge e (block-row br[e], block-column bc[e], shift s[e])
connects variable bc[e]*Z + var_index(r, s[e], Z, perm): (r + s) % Z on a
circulant ("roll") graph, r ^ s on a XOR-permutation ("xor") graph such as
IEEE 802.3an's. The layered decoders visit the
block-rows in `layer_order` and the edges of a row in `layer_edges` order
(edge-id order), the same order as the JAX package, so the two share fixed
points. The block edges come from the code's `block_edges()`: a QCCode's
or QCXorCode's base matrix, or a QCMultiCode's explicit list (CCSDS
AR4JA), whose parallel edges put one block-column twice in a layer
(`intra_layer_dup_free` False).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.spec import CodeSpec

PERMS = ("roll", "xor")


def var_index(z, s, Z: int, perm: str):
    """The position in its block-column of the variable that check z of a
    block with shift s reads: (z + s) % Z (roll) or z ^ s (xor)."""
    return z ^ s if perm == "xor" else (z + s) % Z


def check_index(zv, s, Z: int, perm: str):
    """The inverse of var_index: the check of the block that reads variable
    position zv, (zv - s) % Z (roll) or zv ^ s (xor permutations are
    involutions)."""
    return zv ^ s if perm == "xor" else (zv - s) % Z


@dataclasses.dataclass(frozen=True)
class QCGraphTensors:
    """Device copies of a QCGraph's tables."""

    be_row: torch.Tensor    # int32 [BE]
    be_col: torch.Tensor    # int32 [BE]
    be_shift: torch.Tensor  # int32 [BE]
    row_be: torch.Tensor    # int32 [mb, dcb_max] block-edge ids per block-row
    row_mask: torch.Tensor  # bool [mb, dcb_max]
    col_be: torch.Tensor    # int32 [nb, dvb_max]
    col_mask: torch.Tensor  # bool [nb, dvb_max]


@dataclasses.dataclass(frozen=True, eq=False)
class QCGraph:
    """Host-side QC graph with NumPy block-edge tables."""

    Z: int
    mb: int
    nb: int
    num_block_edges: int
    dcb_max: int
    dvb_max: int
    k: int
    name: str
    be_row: np.ndarray    # int32 [BE]
    be_col: np.ndarray    # int32 [BE]
    be_shift: np.ndarray  # int32 [BE]
    row_be: np.ndarray    # int32 [mb, dcb_max]
    row_mask: np.ndarray  # bool [mb, dcb_max]
    col_be: np.ndarray    # int32 [nb, dvb_max]
    col_mask: np.ndarray  # bool [nb, dvb_max]
    perm: str = "roll"    # block permutation: "roll" or "xor" (var_index)
    # decoder tables derived from the above, per (kind, device); filled by
    # the decoders on first use (decode/layered_qc.py)
    device_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    def to(self, device) -> QCGraphTensors:
        """The tables as tensors on `device`."""
        def t(a):
            return torch.as_tensor(a).to(device)

        return QCGraphTensors(
            be_row=t(self.be_row), be_col=t(self.be_col),
            be_shift=t(self.be_shift), row_be=t(self.row_be),
            row_mask=t(self.row_mask), col_be=t(self.col_be),
            col_mask=t(self.col_mask),
        )

    @functools.cached_property
    def _rows(self) -> tuple:
        rows = [[] for _ in range(self.mb)]
        for e in range(self.num_block_edges):
            rows[int(self.be_row[e])].append(
                (e, int(self.be_col[e]), int(self.be_shift[e])))
        return tuple(tuple(r) for r in rows)

    def layer_edges(self, i: int):
        """(edge_id, col, shift) triples of block-row i, in edge-id order."""
        return list(self._rows[i])

    @property
    def layer_order(self):
        """Canonical layered processing order: block-rows stably sorted by
        degree (the order of the JAX package's oracle and Pallas kernel).
        Any fixed row order is a valid layered schedule."""
        degs = [len(r) for r in self._rows]
        return tuple(sorted(range(self.mb), key=lambda i: degs[i]))

    @property
    def intra_layer_dup_free(self) -> bool:
        """True when no block-row touches the same block-column twice, so a
        layer writes each posterior at most once (the set-form update
        `extrinsic + Cnew`); otherwise the layered decoders add each slot's
        message change to the posteriors (the accumulate form)."""
        for r in self._rows:
            cols = [c for _, c, _ in r]
            if len(cols) != len(set(cols)):
                return False
        return True

    @property
    def layer_groups(self):
        """(degree, rows_tuple) groups following layer_order."""
        groups = []
        for i in self.layer_order:
            d = len(self._rows[i])
            if groups and groups[-1][0] == d:
                groups[-1][1].append(i)
            else:
                groups.append((d, [i]))
        return tuple((d, tuple(rows)) for d, rows in groups)


def qc_graph_from_block_edges(
    Z: int, mb: int, nb: int, br, bc, sh, *, k: int, name: str = "qc",
    perm: str = "roll",
) -> QCGraph:
    """Build a QCGraph from explicit (block_row, block_col, shift) triples
    whose blocks are circulants (perm "roll") or XOR permutations ("xor",
    power-of-two Z)."""
    br = np.asarray(br, np.int32)
    bc = np.asarray(bc, np.int32)
    sh = np.asarray(sh, np.int32)
    BE = len(br)
    if perm not in PERMS:
        raise ValueError(f"perm must be 'roll' or 'xor', got {perm!r}")
    if perm == "xor" and Z & (Z - 1):
        raise ValueError(f"xor-perm blocks need power-of-two Z, got {Z}")
    if np.any(sh < 0) or np.any(sh >= Z):
        raise ValueError("shifts must lie in [0, Z)")
    if len(bc) != BE or len(sh) != BE:
        raise ValueError("br, bc, sh must have equal length")
    if BE and (br.min() < 0 or br.max() >= mb):
        raise ValueError(f"block rows must lie in [0, {mb})")
    if BE and (bc.min() < 0 or bc.max() >= nb):
        raise ValueError(f"block cols must lie in [0, {nb})")
    dcb = np.bincount(br, minlength=mb)
    dvb = np.bincount(bc, minlength=nb)
    dcb_max, dvb_max = int(dcb.max()), int(dvb.max())

    row_be = np.zeros((mb, dcb_max), np.int32)
    row_mask = np.zeros((mb, dcb_max), bool)
    col_be = np.zeros((nb, dvb_max), np.int32)
    col_mask = np.zeros((nb, dvb_max), bool)
    fr = np.zeros(mb, np.int32)
    fc = np.zeros(nb, np.int32)
    for e in range(BE):
        i, j = br[e], bc[e]
        row_be[i, fr[i]] = e
        row_mask[i, fr[i]] = True
        fr[i] += 1
        col_be[j, fc[j]] = e
        col_mask[j, fc[j]] = True
        fc[j] += 1

    return QCGraph(
        Z=Z, mb=mb, nb=nb, num_block_edges=BE,
        dcb_max=dcb_max, dvb_max=dvb_max, k=k, name=name,
        be_row=br, be_col=bc, be_shift=sh,
        row_be=row_be, row_mask=row_mask, col_be=col_be, col_mask=col_mask,
        perm=perm,
    )


def compile_qc_graph(spec: CodeSpec) -> QCGraph:
    """The QCGraph of a code with QC structure (QCCode, QCXorCode or
    QCMultiCode), block edges in the order `block_edges()` lists them."""
    qc = spec.qc
    if qc is None:
        raise ValueError(f"code {spec.name!r} has no QC structure")
    br, bc, sh = qc.block_edges()
    return qc_graph_from_block_edges(
        qc.Z, qc.mb, qc.nb, br, bc, sh, k=spec.k, name=spec.name,
        perm=getattr(qc, "perm", "roll"),
    )
