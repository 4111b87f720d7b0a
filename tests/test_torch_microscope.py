"""The port's trapping-set microscopy (sim/microscope.py) against the JAX
package's on the same error supports, and end to end on the CPU: a port
of tests/unit/test_microscope.py."""
import dataclasses

import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.sim.microscope import canonical_set as jax_canonical_set
from ecc_ldpc_tpu.sim.microscope import classify_failure as jax_classify
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.ecc import build_ecc
from ecc_ldpc_tpu_torch.sim.microscope import (
    TrapReport,
    canonical_set,
    classify_failure,
    harvest,
    harvest_batch,
)

torch.set_num_threads(1)


def _brute_ab(spec, err_set):
    H = spec.dense()
    e = np.zeros(spec.n, np.uint8)
    e[list(err_set)] = 1
    deg = H.astype(np.int64) @ e  # induced degree per check
    return len(err_set), int((deg % 2).sum()), bool(
        len(err_set) and deg.max() <= 2)


@pytest.mark.parametrize("code", ["mackay1008", "80211n/648/12"])
def test_classify_and_canonical_match_jax(code):
    """Random error supports (and their QC rotations) classify and
    canonicalize exactly as in the JAX package and as brute-force H
    arithmetic says."""
    spec, jspec = get_code(code), jax_get_code(code)
    rng = np.random.default_rng(0)
    tx = rng.integers(0, 2, spec.n).astype(np.uint8)
    for _ in range(12):
        err = rng.choice(spec.n, size=rng.integers(1, 9), replace=False)
        rx = tx.copy()
        rx[err] ^= 1
        detected = bool(rng.integers(0, 2))
        f = classify_failure(spec, tx, rx, detected=detected)
        jf = jax_classify(jspec, tx, rx, detected=detected)
        assert dataclasses.asdict(f) == dataclasses.asdict(jf)
        assert (f.a, f.b, f.elementary) == _brute_ab(spec, set(err.tolist()))
        assert f.b == len(f.unsat_checks) and f.detected == detected
        assert canonical_set(spec, f.vn_set) == jax_canonical_set(jspec,
                                                                  f.vn_set)
    assert canonical_set(spec, ()) == ()


def test_single_flip_is_elementary():
    spec = get_code("mackay1008")
    tx = np.zeros(spec.n, np.uint8)
    rx = tx.copy()
    rx[17] = 1
    f = classify_failure(spec, tx, rx)
    # (3,6)-regular: one flipped bit leaves its dv=3 checks odd, degree 1
    assert f.a == 1 and f.b == 3 and f.elementary and f.ab == (1, 3)


def test_qc_canonicalization_merges_rotations():
    spec = get_code("80211n/648/12")
    Z = spec.qc.Z
    base = (0 * Z + 3, 5 * Z + 11, 9 * Z + 20)
    for t in (1, 7, 26):
        rot = tuple(b // Z * Z + (b % Z + t) % Z for b in base)
        assert canonical_set(spec, rot) == canonical_set(spec, base)
    other = (0 * Z + 3, 5 * Z + 12, 9 * Z + 20)
    assert canonical_set(spec, other) != canonical_set(spec, base)


def test_harvest_end_to_end():
    """The histogram counts every failed frame, counted again here on the
    same frames (harvest_batch regenerates them), and each stored failure's
    b is the weight of H e."""
    code, decoder = "80211n/648/12", "minsum/norm:0.8125/5"
    rep = harvest(code, decoder, ebn0_db=2.0, frames=96, batch=64, seed=3,
                  max_stored=10, device="cpu")
    assert isinstance(rep, TrapReport) and rep.frames == 96
    ecc = build_ecc(code, decoder, device="cpu")
    failed = 0
    for step, b in enumerate((64, 32)):
        cw, llr = harvest_batch(ecc, 3, step, b, 2.0, torch.device("cpu"))
        failed += int((ecc.decode(llr).bits != cw).any(1).sum())
    assert 10 < failed < 96
    assert sum(rep.histogram.values()) == failed
    assert sum(rep.set_counts.values()) == failed
    assert len(rep.failures) == 10
    H = ecc.spec.dense().astype(np.int64)
    for f in rep.failures:
        e = np.zeros(ecc.n, np.int64)
        e[list(f.vn_set)] = 1
        assert f.b == int(((H @ e) % 2).sum()) == len(f.unsat_checks)
    js = rep.to_json()
    assert js["n_failures"] == len(rep.failures)
    assert sum(js["histogram"].values()) == failed
    assert rep.summary().startswith(f"{code} | {decoder} @ 2.0 dB")
    assert rep.dominant(1)[0][1] >= 1
