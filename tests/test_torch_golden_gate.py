"""The port's golden-curve gate on the card: tests/ber/test_golden_gate.py
for ecc_ldpc_tpu_torch. Each family is re-measured through the port's
sweep (run_sweep on cuda, the CUDA kernels) at its golden's deepest
resolvable points, and must overlap the golden by the reference's rule:
Wilson-CI overlap of FER (or within 1.25x where the golden saturates at
FER >= 0.5), and BER overlap or within 2x.

Marked slow and cuda; it skips without a card. The test tree's conftest
imports JAX, which the card's machine lacks, so run it there with:

    python -m pytest tests/test_torch_golden_gate.py -m slow --noconftest
"""
import json
from pathlib import Path

import pytest
import torch

from ecc_ldpc_tpu_torch.sim import (
    StoppingRule,
    SweepSpec,
    curves_overlap,
    run_sweep,
)
from ecc_ldpc_tpu_torch.sim.runner import PointResult

pytestmark = [pytest.mark.slow, pytest.mark.cuda]

_CURVES = Path(__file__).parents[1] / "curves"

# the reference gate's goldens, points and budget
_GOLDENS = [
    "80211n_1944_12_tpu_golden.json",
    "wimax_2304_12_tpu_golden.json",
    "wimax_2304_56_tpu_golden.json",
    "nr5g_bg1_384_tpu_golden.json",
    "nr5g_bg2_384_tpu_golden.json",
    "dvbs2_16200_12_tpu_golden.json",
    "dvbs2_64800_12_tpu_golden.json",
    "mackay1008_tpu_golden.json",
    "dvbs2_16200_12_apsk16_tpu_golden.json",
    "dvbs2_16200_12_apsk32_tpu_golden.json",
    "8023an_tpu_golden.json",
    "8023an_layered_tpu_golden.json",
]
_MIN_FER = 2e-2      # ~80+ expected errors in the 4096-frame budget
_MAX_POINTS = 2      # the two lowest-SNR resolvable points per family


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _load(path: Path):
    return [PointResult.from_json(d) for d in json.loads(path.read_text())]


def _fer_ok(m, r) -> bool:
    """CI overlap, or within 1.25x where the golden saturates."""
    lo, hi = m.fer_ci
    if not (r.fer_ci[1] < lo or hi < r.fer_ci[0]):
        return True
    return r.fer >= 0.5 and 0.8 <= m.fer / r.fer <= 1.25


@pytest.mark.parametrize("fname", _GOLDENS)
def test_family_matches_golden(fname, card):
    golden = _load(_CURVES / fname)
    pts = [r for r in golden if r.fer >= _MIN_FER][:_MAX_POINTS]
    assert pts, f"{fname}: no point with FER >= {_MIN_FER}"
    code, decoder = pts[0].code, pts[0].decoder
    res = run_sweep(SweepSpec(
        code=code, decoder=decoder, channel=pts[0].channel or "bpsk",
        ebn0_db=tuple(r.ebn0_db for r in pts), batch=512, seed=77,
        stopping=StoppingRule(min_frame_errors=80, max_frames=4096),
    ), device=card)
    report = "\n".join(
        f"  {r.ebn0_db} dB: FER {m.fer:.3e} {m.fer_ci}, BER {m.ber:.3e}; "
        f"golden FER {r.fer:.3e} {r.fer_ci}, BER {r.ber:.3e}"
        for m, r in zip(res, pts))
    print(f"{fname} ({code}, {decoder}):\n{report}")
    assert all(_fer_ok(m, r) for m, r in zip(res, pts)), (
        f"{code} FER diverged from golden:\n{report}")
    assert curves_overlap(res, pts, metric="ber") or all(
        0.5 <= m.ber / r.ber <= 2.0 for m, r in zip(res, pts) if r.ber > 0
    ), f"{code} BER diverged >2x from golden:\n{report}"
