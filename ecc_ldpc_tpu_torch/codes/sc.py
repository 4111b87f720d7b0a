"""Spatially-coupled (convolutional) LDPC codes — terminated edge-spread
ensembles (beyond-reference family; the modern capacity-approaching
construction).

A verbatim copy of ecc_ldpc_tpu/codes/sc.py (the port imports nothing of
the JAX package).

Construction: couple the (J,K)-regular protograph over L spatial
positions by identity edge spreading — position t's K/J variable types
each connect once to check positions t, t+1, ..., t+J-1. Termination
adds J-1 extra check positions at the chain's end; boundary checks have
lower degree, which is exactly the structured irregularity that makes BP
on the coupled ensemble achieve the UNCOUPLED ensemble's MAP threshold
(threshold saturation, Kudekar/Richardson/Urbanke 2011). The rate loss
is the termination overhead: R = (L - J + 1)/ ... precisely
k/n = 1 - (L+J-1)/(vpp*L) for vpp = K/J variables per position.

Why this lands for free here: the coupled protograph is just a banded
base matrix, so the QC machinery (graph/qc.py), the layered/roll
decoders, and the Pallas kernel all serve SC codes unchanged, and the
exact BEC density evolution (codes/threshold.py) demonstrates threshold
saturation numerically — e.g. (3,6)-coupled at L=20 reads eps* ~ 0.48
vs the uncoupled 0.4294 (the (3,6) MAP threshold is ~0.4881).

Shifts are machine-optimized for girth like every surrogate family here
(codes/girth.py; deterministic from `seed`).

Spec string: sc/<J>/<K>/<L>/<Z>[/s<seed>].
"""
from __future__ import annotations

import numpy as np

from .girth import optimize_shifts
from .qc import QCCode, expand_qc
from .spec import CodeSpec


def sc_regular(J: int, K: int, L: int, Z: int, seed: int = 0) -> CodeSpec:
    """Terminated (J,K)-regular SC-LDPC over L positions, lifting Z."""
    if K % J:
        raise ValueError(f"identity edge spreading needs J | K, got ({J},{K})")
    if L < J:
        raise ValueError(f"chain length L={L} shorter than the window J={J}")
    vpp = K // J  # variable types per spatial position
    nb = vpp * L
    mb = L + J - 1
    base = np.full((mb, nb), -1, dtype=np.int32)
    rng = np.random.default_rng(seed)
    for t in range(L):
        for v in range(vpp):
            col = t * vpp + v
            for w in range(J):
                base[t + w, col] = int(rng.integers(0, Z))
    base = optimize_shifts(base, Z, free=lambda i, j: True, seed=seed)
    qc = QCCode(Z=Z, base=base)
    spec = expand_qc(qc, name=f"sc/{J}/{K}/{L}/{Z}")
    # terminated SC chains carry a few linearly dependent checks (the
    # boundary structure), so k = n - rank(H), not n - m
    from ..encode.gf2 import gf2_rank

    rank = gf2_rank(spec.dense())
    if rank != spec.m:
        spec = CodeSpec(
            name=spec.name, n=spec.n, m=spec.m, row_cols=spec.row_cols,
            qc=spec.qc, k=spec.n - rank,
        )
    return spec
