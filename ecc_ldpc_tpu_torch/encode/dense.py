"""Dense-generator GF(2) encoding (port of ecc_ldpc_tpu/encode/dense.py).

The host derives a systematic generator G from H by GF(2) elimination
(the JAX package's pivots, so the same `info_cols`). The device encodes a
batch as one 0/1 matrix product followed by mod 2. PyTorch has no integer
matmul on CUDA, so the product runs in f32, which is exact here: every
sum is an integer of at most k, far below 2^24. For codes without a
structured encoder (mackay1008, alist files, CCSDS AR4JA).

Large codes (n * m above 64M cells, such as CCSDS k = 16384) pay a one-time
elimination of seconds to minutes; DenseEncoder.build keeps their G on the
host, bit-packed and content-addressed by a hash of H, under
~/.cache/ecc_ldpc_tpu_torch/, in the JAX package's file format
(G_<hash>.npz with G_packed, n and info_cols), so either package reads a
file the other wrote.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..codes.spec import CodeSpec
from .gf2 import gf2_matmul, gf2_row_reduce

# cells of H above which DenseEncoder.build caches G on the host (the JAX
# package's threshold), and the most it eliminates (ecc_ldpc_tpu/encode/
# dense.py LARGE_CELLS: CCSDS k = 16384 at rate 1/2 has 24576 x 40960,
# ~1.0e9, while a DVB-S2 normal frame's H stays refused)
_CACHE_CELLS = 64_000_000
LARGE_CELLS = 1_200_000_000
CACHE_DIR = ("~", ".cache", "ecc_ldpc_tpu_torch")


def cache_path(spec: CodeSpec) -> str:
    """The G cache file of `spec`: sha256 of [m, n] (int64) and each row's
    columns (int32), first 24 hex digits, as the JAX package names it."""
    h = hashlib.sha256()
    h.update(np.int64([spec.m, spec.n]).tobytes())
    for r in spec.row_cols:
        h.update(np.asarray(r, np.int32).tobytes())
    return os.path.join(os.path.expanduser(os.path.join(*CACHE_DIR)),
                        f"G_{h.hexdigest()[:24]}.npz")


def load_cached(path: str):
    """(G uint8 [k, n], info_cols int32 [k]) from a cache file."""
    with np.load(path) as z:
        G = np.unpackbits(z["G_packed"], axis=1, count=int(z["n"]))
        return G, np.asarray(z["info_cols"], np.int32)


def save_cached(path: str, G: np.ndarray, info_cols: np.ndarray) -> None:
    """Write a cache file: to a temporary name, then os.replace into place,
    so a reader never sees half a file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, G_packed=np.packbits(G, axis=1),
                            n=np.int64(G.shape[1]), info_cols=info_cols)
    os.replace(tmp, path)


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
    def build(spec: CodeSpec, cache: bool = True) -> "DenseEncoder":
        """The systematic generator of `spec`, from the host cache where
        n * m exceeds 64M cells (eliminated and stored there on a miss, up
        to LARGE_CELLS); cache=False eliminates anew and stores nothing."""
        big = spec.n * spec.m > _CACHE_CELLS
        path = cache_path(spec) if cache and big else None
        if path is not None and os.path.exists(path):
            return DenseEncoder(*load_cached(path))
        G, info_cols = systematic_generator(
            spec, max_cells=LARGE_CELLS if big else _CACHE_CELLS)
        if path is not None:
            save_cached(path, G, info_cols)
        return DenseEncoder(G, info_cols)

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
