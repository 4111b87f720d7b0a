"""Sequential stopping + confidence intervals (a copy of
ecc_ldpc_tpu/sim/stopping.py, which imports nothing of JAX).

Wilson score intervals (robust at the tiny error rates LDPC waterfalls
produce) and a stopping rule of `frame_errors >= min_frame_errors OR
frames >= max_frames`.
"""
from __future__ import annotations

import dataclasses
import math


def wilson_interval(errors: int, trials: int, z: float = 1.96):
    """Wilson score interval for a binomial proportion. Returns (lo, hi)."""
    if trials == 0:
        return 0.0, 1.0
    p = errors / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    center = (p + z2 / (2 * trials)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / trials + z2 / (4 * trials * trials))
    return max(0.0, center - half), min(1.0, center + half)


@dataclasses.dataclass(frozen=True)
class StoppingRule:
    """Stop a grid point when enough frame errors were seen (statistical
    confidence) or a frame budget is exhausted (error floors / high SNR)."""

    min_frame_errors: int = 100
    max_frames: int = 1_000_000
    min_frames: int = 0  # optionally force at least this many frames

    def done(self, frame_errors: int, frames: int) -> bool:
        if frames < self.min_frames:
            return False
        return frame_errors >= self.min_frame_errors or frames >= self.max_frames
