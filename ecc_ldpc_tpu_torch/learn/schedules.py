"""Shipped learned min-sum schedules (port of load_schedule in
ecc_ldpc_tpu/learn/noms.py).

A schedule is a per-iteration normalization alpha_t and offset beta_t for
layered min-sum, trained in the JAX package and shipped as JSON under
learn/schedules/ (the same files). Schedules are code-specific and, when
they carry offsets, SNR-band-specific; each file records its training range.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

_DIR = pathlib.Path(__file__).parent / "schedules"


@dataclasses.dataclass(frozen=True)
class NomsParams:
    """Per-iteration min-sum parameters (both length-T f32 arrays)."""

    alphas: np.ndarray
    betas: np.ndarray

    def __post_init__(self):
        a = np.asarray(self.alphas, np.float32).reshape(-1)
        b = np.asarray(self.betas, np.float32).reshape(-1)
        if a.shape != b.shape or a.size == 0:
            raise ValueError(
                f"alphas and betas must be equal non-empty 1-D arrays, got "
                f"{a.shape} and {b.shape}")
        object.__setattr__(self, "alphas", a)
        object.__setattr__(self, "betas", b)

    @property
    def iters(self) -> int:
        return int(self.alphas.shape[0])


def load_schedule(name: str) -> NomsParams:
    """Load a shipped schedule by name (e.g. 'dvbs2_64800_12_T25_op2') or
    a schedule JSON by path (anything containing '/' or ending in '.json')."""
    if "/" in name or name.endswith(".json"):
        path = pathlib.Path(name)
    else:
        path = _DIR / f"{name}.json"
    with open(path) as f:
        d = json.load(f)
    return NomsParams(alphas=d["alphas"], betas=d["betas"])
