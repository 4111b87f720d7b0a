"""Compile a CodeSpec's H into the flooding decoder's index tables (port of
ecc_ldpc_tpu/graph/compile.py).

Layout: the padded check-side view [m, dc_max] is the edge space — edge
(i, j) is slot j of check i, flat id i*dc_max + j; check i's real slots are
a prefix of its row. The variable-side view [n, dv_max] holds flat ids into
that edge space. Padding slots point at id 0 and are masked. The tables are
NumPy; `CompiledGraph.to(device)` gives their tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.spec import CodeSpec


@dataclasses.dataclass(frozen=True)
class CompiledGraphTensors:
    """Device copies of a CompiledGraph's tables."""

    cn_vn: torch.Tensor    # int32 [m, dc_max]
    cn_mask: torch.Tensor  # bool [m, dc_max]
    vn_edge: torch.Tensor  # int32 [n, dv_max]
    vn_mask: torch.Tensor  # bool [n, dv_max]


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledGraph:
    """Host-side LDPC graph with NumPy edge tables."""

    n: int
    m: int
    k: int
    num_edges: int
    dc_max: int
    dv_max: int
    name: str
    cn_vn: np.ndarray    # int32 [m, dc_max] variable id per check slot
    cn_mask: np.ndarray  # bool [m, dc_max]
    vn_edge: np.ndarray  # int32 [n, dv_max] flat edge id (i*dc_max + j)
    vn_mask: np.ndarray  # bool [n, dv_max]
    # decoder tables derived from the above, per (kind, device); filled by
    # the decoders on first use (decode/flooding.py)
    device_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def rate(self) -> float:
        return self.k / self.n

    def to(self, device) -> CompiledGraphTensors:
        """The tables as tensors on `device`."""
        def t(a):
            return torch.as_tensor(a).to(device)

        return CompiledGraphTensors(cn_vn=t(self.cn_vn), cn_mask=t(self.cn_mask),
                                    vn_edge=t(self.vn_edge),
                                    vn_mask=t(self.vn_mask))


def compile_graph(spec: CodeSpec) -> CompiledGraph:
    m, n = spec.m, spec.n
    dc_max = int(spec.row_deg.max())
    dv_max = int(spec.col_deg.max())

    cn_vn = np.zeros((m, dc_max), dtype=np.int32)
    cn_mask = np.zeros((m, dc_max), dtype=bool)
    for i, cols in enumerate(spec.row_cols):
        cn_vn[i, : len(cols)] = cols
        cn_mask[i, : len(cols)] = True

    # Variable side: flat edge ids, built by walking the rows once.
    vn_edge = np.zeros((n, dv_max), dtype=np.int32)
    vn_mask = np.zeros((n, dv_max), dtype=bool)
    fill = np.zeros(n, dtype=np.int32)
    for i, cols in enumerate(spec.row_cols):
        for j, c in enumerate(cols):
            c = int(c)
            vn_edge[c, fill[c]] = i * dc_max + j
            vn_mask[c, fill[c]] = True
            fill[c] += 1
    assert np.array_equal(fill, spec.col_deg)

    return CompiledGraph(
        n=n, m=m, k=spec.k, num_edges=spec.num_edges, dc_max=dc_max,
        dv_max=dv_max, name=spec.name, cn_vn=cn_vn, cn_mask=cn_mask,
        vn_edge=vn_edge, vn_mask=vn_mask,
    )
