"""QC 4-cycle census used by the surrogate constructions (codes/dvbs2.py).

Copy of block_4cycle_violations from ecc_ldpc_tpu/codes/girth.py; the
port keeps its own copy so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def block_4cycle_violations(base: np.ndarray, Z: int):
    """QC 4-cycles: rows i1<i2 sharing cols j1<j2 with
    s[i1,j1]-s[i1,j2]+s[i2,j2]-s[i2,j1] == 0 (mod Z)."""
    mb, nb = base.shape
    viol = []
    for i1 in range(mb):
        for i2 in range(i1 + 1, mb):
            shared = np.flatnonzero((base[i1] >= 0) & (base[i2] >= 0))
            for a in range(len(shared)):
                for b in range(a + 1, len(shared)):
                    j1, j2 = shared[a], shared[b]
                    if (base[i1, j1] - base[i1, j2]
                            + base[i2, j2] - base[i2, j1]) % Z == 0:
                        viol.append((i1, i2, j1, j2))
    return viol
