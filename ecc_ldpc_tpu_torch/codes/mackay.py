"""The shipped (3,6)-regular rate-1/2 n=1008 code (port of
ecc_ldpc_tpu/codes/mackay.py).

Reads the port's byte copy of the JAX package's data file,
ecc_ldpc_tpu_torch/data/mackay1008.alist: a deterministic Gallager-ensemble
surrogate of MacKay's construction 1A ((3,6)-regular, 4-cycle-free). The
regenerator (codes/gallager.py) is not ported, so a missing file raises.
"""
from __future__ import annotations

import pathlib

from .alist import load_alist
from .spec import CodeSpec

PATH = pathlib.Path(__file__).resolve().parent.parent / "data" / "mackay1008.alist"


def mackay_1008() -> CodeSpec:
    """Load the shipped n=1008 code, with k = n - rank(H) = 506 (the
    Gallager-ensemble H has 2 dependent rows)."""
    from ..encode.gf2 import gf2_rank

    if not PATH.exists():
        raise FileNotFoundError(
            f"{PATH}: the mackay1008 data file is missing (the port has no "
            f"regenerator; copy ecc_ldpc_tpu/data/mackay1008.alist)")
    spec = load_alist(PATH, name="mackay1008")
    k = spec.n - gf2_rank(spec.dense())
    return CodeSpec(name="mackay1008", n=spec.n, m=spec.m,
                    row_cols=spec.row_cols, k=k)
