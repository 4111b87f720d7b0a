"""Dense-generator GF(2) encoding (port of ecc_ldpc_tpu/encode/dense.py).

The host derives a systematic generator G from H by GF(2) elimination
(the JAX package's pivots, so the same `info_cols`). The device encodes a
batch as one 0/1 matrix product followed by mod 2. PyTorch has no integer
matmul on CUDA, so the product runs in f32, which is exact here: every
sum is an integer of at most k, far below 2^24. For codes without a
structured encoder (mackay1008, alist files).
"""
from __future__ import annotations

import numpy as np
import torch

from ..codes.spec import CodeSpec
from .gf2 import gf2_matmul, gf2_row_reduce

# cells of H above which the JAX package caches G on the host (its
# DenseEncoder.build); the port has no such cache yet
_CACHE_CELLS = 64_000_000


def systematic_generator(spec: CodeSpec, max_cells: int = _CACHE_CELLS):
    """(G uint8 [k, n], info_cols int32 [k]) with G @ H^T = 0 (mod 2), in
    the original column order; codeword[info_cols] == message for
    message @ G."""
    H = spec.dense(max_cells=max_cells)
    R, pivot_cols = gf2_row_reduce(H)
    rank = len(pivot_cols)
    k = spec.n - rank
    info_cols = np.setdiff1d(np.arange(spec.n), pivot_cols)
    assert len(info_cols) == k
    # For a codeword c: 0 = R c = c[pivot_cols] + R[:, info_cols] c[info_cols]
    # => c[pivot_cols] = R[:rank, info_cols] @ msg, c[info_cols] = msg.
    G = np.zeros((k, spec.n), dtype=np.uint8)
    G[np.arange(k), info_cols] = 1
    G[:, pivot_cols[:rank]] = R[:rank][:, info_cols].T
    assert not np.any(gf2_matmul(G, H.T)), "G @ H^T != 0"
    return G, info_cols.astype(np.int32)


class DenseEncoder:
    """Batched encoder: msg uint8 [B, k] -> codeword uint8 [B, n], on the
    device of its input. G and info_cols go to each device once."""

    def __init__(self, G: np.ndarray, info_cols: np.ndarray):
        self.G = np.asarray(G, np.uint8)
        self.info_cols = np.asarray(info_cols, np.int32)
        self._dev = {}

    @staticmethod
    def build(spec: CodeSpec) -> "DenseEncoder":
        if spec.n * spec.m > _CACHE_CELLS:
            raise NotImplementedError(
                f"{spec.name}: a {spec.m}x{spec.n} dense generator needs the "
                f"JAX package's host-side G cache, which waits for ROADMAP.md "
                f"Queue 1 step 3 (dense encoders)")
        return DenseEncoder(*systematic_generator(spec))

    @property
    def k(self) -> int:
        return self.G.shape[0]

    @property
    def n(self) -> int:
        return self.G.shape[1]

    def _tables(self, device: torch.device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.as_tensor(self.G, dtype=torch.float32, device=device),
                torch.as_tensor(self.info_cols.astype(np.int64), device=device),
            )
        return self._dev[key]

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        """Host-side NumPy twin of __call__."""
        return gf2_matmul(np.asarray(msg_bits, np.uint8), self.G)

    def __call__(self, msg_bits: torch.Tensor) -> torch.Tensor:
        G, _ = self._tables(msg_bits.device)
        acc = msg_bits.to(torch.float32) @ G
        return (acc.to(torch.int32) & 1).to(torch.uint8)

    def extract_message(self, codeword_bits: torch.Tensor) -> torch.Tensor:
        """codeword [..., n] -> message [..., k] (the systematic positions)."""
        _, cols = self._tables(codeword_bits.device)
        return codeword_bits.index_select(-1, cols)
