"""Bridge from the JAX package's host tables to the port's objects.

The reference's "weights" are its graph tables and learned schedules. The
tests pass the JAX QCGraph's NumPy tables (be_row_np, be_col_np,
be_shift_np) and a NomsParams' arrays through these functions, so both
packages decode the same graph with the same parameters. Nothing here
imports the JAX package: the caller hands over plain arrays.
"""
from __future__ import annotations

import numpy as np

from .graph.qc import QCGraph, qc_graph_from_block_edges
from .learn.schedules import NomsParams


def graph_from_numpy(Z: int, mb: int, nb: int, k: int, be_row, be_col,
                     be_shift, name: str = "qc") -> QCGraph:
    """The port's QCGraph from block-edge tables (edge order kept)."""
    return qc_graph_from_block_edges(
        int(Z), int(mb), int(nb),
        np.asarray(be_row, np.int32), np.asarray(be_col, np.int32),
        np.asarray(be_shift, np.int32), k=int(k), name=name,
    )


def schedule_from_numpy(alphas, betas) -> NomsParams:
    """The port's per-iteration schedule from alpha/beta arrays (f32)."""
    return NomsParams(alphas=np.asarray(alphas, np.float32),
                      betas=np.asarray(betas, np.float32))
