"""Bridge from the JAX package's host tables to the port's objects.

The reference's "weights" are its graph tables, generators and learned
schedules. The tests pass the JAX QCGraph's NumPy tables (be_row_np,
be_col_np, be_shift_np), a CompiledGraph's (cn_vn, cn_mask, vn_edge,
vn_mask), a DenseEncoder's (G, info_cols) and a NomsParams' arrays through
these functions, so both packages decode the same graph with the same
parameters. Nothing here imports the JAX package: the caller hands over
plain arrays.
"""
from __future__ import annotations

import numpy as np

from .encode.dense import DenseEncoder
from .graph.compile import CompiledGraph
from .graph.qc import QCGraph, qc_graph_from_block_edges
from .learn.schedules import NomsParams


def graph_from_numpy(Z: int, mb: int, nb: int, k: int, be_row, be_col,
                     be_shift, name: str = "qc",
                     perm: str = "roll") -> QCGraph:
    """The port's QCGraph from block-edge tables (edge order kept) and the
    block permutation kind ("roll" or "xor", the JAX QCGraph's perm)."""
    return qc_graph_from_block_edges(
        int(Z), int(mb), int(nb),
        np.asarray(be_row, np.int32), np.asarray(be_col, np.int32),
        np.asarray(be_shift, np.int32), k=int(k), name=name, perm=perm,
    )


def compiled_graph_from_numpy(n: int, m: int, k: int, cn_vn, cn_mask,
                              vn_edge, vn_mask,
                              name: str = "graph") -> CompiledGraph:
    """The port's CompiledGraph from the flooding tables (kept as given;
    each check's real slots must be a prefix of its row, as
    compile_graph lays them out)."""
    cn_vn = np.asarray(cn_vn, np.int32)
    cn_mask = np.asarray(cn_mask, bool)
    vn_edge = np.asarray(vn_edge, np.int32)
    vn_mask = np.asarray(vn_mask, bool)
    if cn_vn.shape != cn_mask.shape or cn_vn.shape[0] != m:
        raise ValueError(f"cn_vn/cn_mask must be [{m}, dc_max]")
    if vn_edge.shape != vn_mask.shape or vn_edge.shape[0] != n:
        raise ValueError(f"vn_edge/vn_mask must be [{n}, dv_max]")
    deg = cn_mask.sum(1)
    if not np.array_equal(cn_mask, np.arange(cn_mask.shape[1]) < deg[:, None]):
        raise ValueError("each check's real slots must be a prefix of its row")
    return CompiledGraph(
        n=int(n), m=int(m), k=int(k), num_edges=int(cn_mask.sum()),
        dc_max=cn_vn.shape[1], dv_max=vn_edge.shape[1], name=name,
        cn_vn=cn_vn, cn_mask=cn_mask, vn_edge=vn_edge, vn_mask=vn_mask,
    )


def dense_encoder_from_numpy(G, info_cols) -> DenseEncoder:
    """The port's DenseEncoder from a generator G [k, n] (0/1) and its
    systematic positions."""
    return DenseEncoder(np.asarray(G, np.uint8), np.asarray(info_cols, np.int32))


def schedule_from_numpy(alphas, betas) -> NomsParams:
    """The port's per-iteration schedule from alpha/beta arrays (f32)."""
    return NomsParams(alphas=np.asarray(alphas, np.float32),
                      betas=np.asarray(betas, np.float32))
