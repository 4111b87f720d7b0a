"""Seeded QC graphs whose every block-row holds one block-column twice,
for holding the accumulate ("classic") form of the layered decoders
against its plain version: circulant or XOR-permutation blocks
(graph/qc.qc_graph_from_block_edges), any row degree. Used by
chip_smoke.py (phases 43-44) and the CPU tests."""
from __future__ import annotations

import numpy as np

from ..graph.qc import QCGraph, qc_graph_from_block_edges


def multi_edge_graph(Z: int, mb: int, nb: int, degree: int, perm: str,
                     seed: int = 0) -> QCGraph:
    """A QCGraph of mb block-rows of `degree` slots over nb block-columns:
    each row's first two slots share one block-column (with two distinct
    shifts), the others are distinct columns, shifts drawn from [0, Z);
    k = (nb - mb) * Z, the nominal rate for the channel."""
    if not 2 <= degree <= nb + 1:
        raise ValueError(f"degree {degree} needs 2 <= degree <= nb + 1")
    rng = np.random.default_rng(seed)
    br, bc, sh = [], [], []
    for r in range(mb):
        cols = rng.choice(nb, size=degree - 1, replace=False)
        cols = np.concatenate([cols[:1], cols])  # slot 0's column twice
        s = rng.integers(0, Z, size=degree)
        while s[1] == s[0]:
            s[1] = rng.integers(0, Z)
        br += [r] * degree
        bc += cols.tolist()
        sh += s.tolist()
    return qc_graph_from_block_edges(
        Z, mb, nb, br, bc, sh, k=(nb - mb) * Z, perm=perm,
        name=f"multi_edge/{perm}/Z{Z}/d{degree}/s{seed}")
