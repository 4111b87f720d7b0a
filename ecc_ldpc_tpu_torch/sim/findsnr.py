"""Operating-point finder: the Eb/N0 where a config hits a target FER (port
of ecc_ldpc_tpu/sim/findsnr.py).

The inverse of a sweep: "what SNR do I need for FER 1e-2 with this
code and decoder?" (a coding gain is the difference between two configs'
answers). The finder bisects Eb/N0 over the sweep's Pipeline
(sim/runner.py), built once for every probe.

Decision rule per probe: accumulate frames until the Wilson CI of the
measured FER excludes the target (then the side is known) or a frame
budget is exhausted (then the point estimate decides). Near the threshold
the CI straddles the target by construction, so the budget bounds each
probe's cost exactly where certainty is expensive and unnecessary.

Noise: each step of each probe draws from its own torch.Generator, seeded
by runner.step_seed(seed, 0xF17D, probe index, step index). The tag
0xF17D (the reference's root key fold) sits where a sweep puts its host
index, so a probe's streams are never a sweep's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..device import resolve_device
from .runner import Pipeline, SweepSpec, step_seed
from .stopping import wilson_interval

PROBE_TAG = 0xF17D


@dataclasses.dataclass
class OperatingPoint:
    ebn0_db: float
    fer: float
    fer_ci: tuple
    frames: int
    target_fer: float
    code: str
    decoder: str
    channel: str

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def _probe(pipeline, seed, point_idx, ebn0, target, batch, max_frames):
    """Measure FER at one Eb/N0 until the CI excludes `target` or the
    frame budget runs out. Returns (side, fer, ci, frames): side is +1
    (fer above target), -1 (below), or 0 (undecided)."""
    frames = 0
    frame_errors = 0
    step_idx = 0
    while frames < max_frames:
        gen = torch.Generator(device=pipeline.device)
        gen.manual_seed(step_seed(seed, PROBE_TAG, point_idx, step_idx))
        _, fe, _, _ = pipeline.step(gen, ebn0)
        frame_errors += int(fe)
        frames += batch
        step_idx += 1
        lo, hi = wilson_interval(frame_errors, frames)
        if lo > target:
            return 1, frame_errors / frames, (lo, hi), frames
        if hi < target:
            return -1, frame_errors / frames, (lo, hi), frames
    lo, hi = wilson_interval(frame_errors, frames)
    fer = frame_errors / frames
    return (1 if fer > target else -1 if fer < target else 0,
            fer, (lo, hi), frames)


def find_operating_point(
    code: str,
    decoder: str,
    *,
    target_fer: float = 1e-2,
    bracket: tuple = (0.0, 6.0),
    tol_db: float = 0.05,
    batch: int = 512,
    max_frames_per_probe: int = 65536,
    channel: str = "bpsk",
    backend: Optional[str] = None,
    seed: int = 0,
    progress=None,
    device="cuda",
) -> OperatingPoint:
    """Bisect Eb/N0 so that FER(ebn0) ~= target_fer (FER is decreasing in
    SNR), on `device` (default the card; "cpu" the plain path). Raises if
    the bracket does not straddle the target. progress(ebn0, fer, ci,
    frames) is called after each bisection probe."""
    spec = SweepSpec(
        code=code, decoder=decoder, ebn0_db=bracket, batch=batch,
        seed=seed, backend=backend, channel=channel,
    )
    pipeline = Pipeline.build(spec, resolve_device(device))

    lo, hi = float(bracket[0]), float(bracket[1])
    side_lo, *_ = _probe(pipeline, seed, 0, lo, target_fer, batch,
                         max_frames_per_probe)
    side_hi, *_ = _probe(pipeline, seed, 1, hi, target_fer, batch,
                         max_frames_per_probe)
    if side_lo <= 0 or side_hi >= 0:
        raise ValueError(
            f"bracket {bracket} does not straddle FER={target_fer:g}: "
            f"FER({lo} dB) is {'below/at' if side_lo <= 0 else 'above'} "
            f"target, FER({hi} dB) is "
            f"{'above/at' if side_hi >= 0 else 'below'} target"
        )
    idx = 2
    fer, ci, frames = math.nan, (0.0, 1.0), 0
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        side, fer, ci, frames = _probe(
            pipeline, seed, idx, mid, target_fer, batch,
            max_frames_per_probe)
        if progress:
            progress(mid, fer, ci, frames)
        idx += 1
        if side >= 0:
            lo = mid  # FER still above target: need more SNR
        else:
            hi = mid
    return OperatingPoint(
        ebn0_db=0.5 * (lo + hi), fer=float(fer), fer_ci=ci, frames=frames,
        target_fer=target_fer, code=code, decoder=decoder, channel=channel,
    )
