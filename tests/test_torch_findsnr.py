"""The port's operating-point finder (sim/findsnr.py) on the CPU: a port
of tests/unit/test_findsnr.py (the closed form of uncoded BPSK, the order
of two coded targets, a bracket that does not straddle the target)."""
import math

import pytest
import torch
from scipy.stats import norm

from ecc_ldpc_tpu_torch.sim.findsnr import find_operating_point

torch.set_num_threads(1)


def test_uncoded_bpsk_matches_closed_form():
    """Uncoded BPSK frame of n bits: FER = 1 - (1-Q(sqrt(2g)))^n, so the
    Eb/N0 for a target FER has a closed form to pin the finder against."""
    n, target = 128, 0.05
    p = 1.0 - (1.0 - target) ** (1.0 / n)
    expected_db = 10.0 * math.log10(norm.isf(p) ** 2 / 2.0)
    probes = []
    op = find_operating_point(
        f"bpsk/{n}", "minsum/1", target_fer=target, bracket=(2.0, 12.0),
        tol_db=0.08, batch=1024, max_frames_per_probe=32768, device="cpu",
        progress=lambda *a: probes.append(a))
    assert abs(op.ebn0_db - expected_db) < 0.25
    assert len(probes) == math.ceil(math.log2(10.0 / 0.08))
    assert op.json_dict()["code"] == f"bpsk/{n}" and op.target_fer == target


def test_coded_point_and_ordering():
    """An LDPC code needs less SNR at FER 0.3 than at FER 0.02, and both
    sit in the code's waterfall region (the reference's test at 5
    iterations and smaller budgets)."""
    kw = dict(bracket=(0.0, 6.0), tol_db=0.4, batch=128,
              max_frames_per_probe=512, device="cpu")
    hi = find_operating_point("80211n/648/12", "layered/norm:0.8125/5",
                              target_fer=0.3, **kw)
    lo = find_operating_point("80211n/648/12", "layered/norm:0.8125/5",
                              target_fer=0.02, **kw)
    assert hi.ebn0_db < lo.ebn0_db
    assert 0.5 < hi.ebn0_db < 4.0 and 1.0 < lo.ebn0_db < 5.0


def test_bad_bracket_raises():
    with pytest.raises(ValueError, match="does not straddle"):
        find_operating_point(
            "80211n/648/12", "layered/norm:0.8125/25", target_fer=0.3,
            bracket=(8.0, 10.0), batch=256, max_frames_per_probe=2048,
            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        find_operating_point("bpsk/16", "minsum/1", bracket=(0.0, 1.0))
