"""The port's Monte-Carlo sweep (sim/) against the JAX package's: the
statistics and the result files agree exactly, one step's tally equals
JAX's, and small sweeps on the CPU give sane, resumable counters."""
import dataclasses
import glob
import itertools
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.decode.types import DecodeResult as JaxDecodeResult
from ecc_ldpc_tpu.sim import runner as jax_runner
from ecc_ldpc_tpu.sim.report import curves_overlap as jax_curves_overlap
from ecc_ldpc_tpu.sim.stopping import StoppingRule as JaxStoppingRule
from ecc_ldpc_tpu.sim.stopping import wilson_interval as jax_wilson
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.sim import (
    PointResult,
    StoppingRule,
    SweepSpec,
    curves_overlap,
    run_sweep,
    wilson_interval,
)
from ecc_ldpc_tpu_torch.sim.report import format_table, plot_curves
from ecc_ldpc_tpu_torch.sim.runner import step_seed, tally

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = sorted(glob.glob(os.path.join(ROOT, "curves", "*golden*.json")))


def _load(path, cls):
    with open(path) as f:
        return [cls.from_json(d) for d in json.load(f)]


@pytest.mark.parametrize("errors,trials", [(0, 0), (0, 100), (3, 10),
                                           (412, 29696), (10, 10)])
def test_wilson_and_stopping_match_jax(errors, trials):
    assert wilson_interval(errors, trials) == jax_wilson(errors, trials)
    for rule in ((100, 1000, 0), (5, 50, 20)):
        ours, theirs = StoppingRule(*rule), JaxStoppingRule(*rule)
        assert ours.done(errors, trials) == theirs.done(errors, trials)


def test_point_result_json_round_trips_between_packages():
    fields = dict(code="dvbs2/64800/12", decoder="layered/spa/50",
                  ebn0_db=1.1, frames=29696, bit_errors=5835,
                  frame_errors=412, iters_sum=123456, steps=29,
                  message_bits_per_frame=32400, wall_s=3.5,
                  bit_errors_sq=6495923.0)
    ours = PointResult(**fields)
    theirs = jax_runner.PointResult.from_json(
        json.loads(json.dumps(ours.to_json())))
    assert dataclasses.asdict(theirs) == dataclasses.asdict(ours)
    back = PointResult.from_json(json.loads(json.dumps(theirs.to_json())))
    assert back == ours
    assert ours.to_json() == theirs.to_json()
    legacy = dataclasses.replace(ours, bit_errors_sq=0.0)  # mean-burst CI
    jlegacy = dataclasses.replace(theirs, bit_errors_sq=0.0)
    for p, q in ((ours, theirs), (legacy, jlegacy)):
        assert (p.ber, p.fer, p.ber_ci, p.fer_ci, p.mean_iters) == (
            q.ber, q.fer, q.ber_ci, q.fer_ci, q.mean_iters)


def test_curves_overlap_matches_jax_on_goldens():
    assert len(GOLDEN) >= 10
    curves = {p: (_load(p, PointResult), _load(p, jax_runner.PointResult))
              for p in GOLDEN}
    compared = 0
    for a, b in itertools.product(GOLDEN, repeat=2):
        for metric in ("fer", "ber"):
            try:
                want = jax_curves_overlap(curves[a][1], curves[b][1], metric)
            except ValueError:
                with pytest.raises(ValueError):
                    curves_overlap(curves[a][0], curves[b][0], metric)
                continue
            assert curves_overlap(curves[a][0], curves[b][0], metric) == want
            compared += 1
    assert compared >= 2 * len(GOLDEN)


def test_tally_matches_jax_staged_tally():
    rng = np.random.default_rng(11)
    B, k, n = 16, 40, 64
    msg = rng.integers(0, 2, (B, k), dtype=np.uint8)
    bits = rng.integers(0, 2, (B, n), dtype=np.uint8)
    bits[:5, :k] = msg[:5]           # frames without a message-bit error
    bits[5, :k] = msg[5]
    bits[5, 3] ^= 1                  # a single wrong message bit
    iters = rng.integers(0, 30, B).astype(np.int32)

    class Enc:  # systematic: the message is the first k bits
        @staticmethod
        def extract_message(b):
            return b[..., :k]

    res = JaxDecodeResult(bits=jnp.asarray(bits), ok=jnp.ones(B, bool),
                          iterations=jnp.asarray(iters))
    want = [float(x) for x in jax_runner._staged_tally(Enc, jnp.asarray(msg),
                                                       res)]
    got = tally(torch.from_numpy(msg), torch.from_numpy(bits[:, :k]),
                torch.from_numpy(iters))
    assert [float(x) for x in got] == want
    assert isinstance(got[0], int) and isinstance(got[1], int)
    assert got[1] == B - 5


def _spec(**kw):
    base = dict(code="dvbs2/16200/12", decoder="layered/norm:0.8125/10",
                ebn0_db=(0.5, 3.0), batch=8,
                stopping=StoppingRule(min_frame_errors=1000, max_frames=16))
    base.update(kw)
    return SweepSpec(**base)


def _counters(pr):
    d = dataclasses.asdict(pr)
    d.pop("wall_s")
    return d


@pytest.fixture(scope="module")
def small_sweep():
    return run_sweep(_spec(), device="cpu")


def test_small_cpu_sweep_counters(small_sweep):
    lo, hi = small_sweep
    for pr in small_sweep:
        assert pr.frames == 16 and pr.steps == 2
        assert pr.message_bits_per_frame == get_code("dvbs2/16200/12").k
        assert pr.frame_errors <= pr.frames
        assert pr.bit_errors >= pr.frame_errors
        assert pr.bit_errors_sq >= pr.bit_errors
        assert 0 < pr.iters_sum <= pr.frames * 10
        assert pr.wall_s > 0
    # deep in the waterfall at 0.5 dB, error-free at 3.0 dB
    assert lo.frame_errors >= 12 and hi.frame_errors == 0
    assert lo.mean_iters > hi.mean_iters
    table = format_table(small_sweep)
    assert "dvbs2/16200/12" in table and len(table.splitlines()) == 4
    assert "FER vs Eb/N0" in plot_curves(small_sweep)


def test_interrupted_sweep_resumes_exactly(small_sweep, tmp_path):
    """Stop after the first point with that point only half run (8 of 16
    frames), then resume from the state file: the counters equal an
    uninterrupted run's, because each step's noise is a pure function of
    (seed, host, point, step)."""
    state = str(tmp_path / "state.json")

    class Stop(Exception):
        pass

    def stop(pr):
        raise Stop

    half = _spec(stopping=StoppingRule(min_frame_errors=1000, max_frames=8))
    with pytest.raises(Stop):
        run_sweep(half, device="cpu", resume_path=state, progress=stop)
    with open(state) as f:
        saved = json.load(f)
    assert list(saved) == ["dvbs2/16200/12|layered/norm:0.8125/10|0.5"]
    assert saved["dvbs2/16200/12|layered/norm:0.8125/10|0.5"]["steps"] == 1
    resumed = run_sweep(_spec(), device="cpu", resume_path=state)
    assert [_counters(p) for p in resumed] == [_counters(p)
                                               for p in small_sweep]
    assert step_seed(0, 0, 0, 1) != step_seed(0, 0, 1, 0)
    assert step_seed(0, 0, 0, 1) != step_seed(0, 1, 0, 1)
    assert 0 <= step_seed(2**40, 3, 7, 9) < 2**63


def test_pipeline_frames_are_the_steps_batch():
    """Pipeline.frames draws the very batch that Pipeline.step decodes from
    the same generator state, so the batch a sweep step decoded can be
    regenerated and decoded again by another decoder."""
    from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder
    from ecc_ldpc_tpu_torch.sim.runner import Pipeline

    spec = _spec()
    pipe = Pipeline.build(spec, torch.device("cpu"))

    def gen():
        g = torch.Generator()
        g.manual_seed(step_seed(spec.seed, 0, 0, 0))
        return g

    msg, llr = pipe.frames(gen(), 0.5)
    assert msg.shape == (spec.batch, pipe.k) and llr.dtype == torch.float32
    graph = choose_graph(get_code(spec.code), spec.decoder)
    res = get_decoder(graph, spec.decoder, device="cpu")(llr)
    msg_hat = res.bits[:, :pipe.k]  # the structured encoders are systematic
    assert pipe.step(gen(), 0.5) == tally(msg, msg_hat, res.iterations)


def test_uncoded_bpsk_ber_matches_theory():
    ebn0 = 4.0
    spec = SweepSpec(code="bpsk/1008", decoder="none", ebn0_db=(ebn0,),
                     batch=64, seed=3,
                     stopping=StoppingRule(min_frame_errors=10**9,
                                           max_frames=512))
    (pr,) = run_sweep(spec, device="cpu")
    assert pr.frames == 512 and pr.message_bits_per_frame == 1008
    theory = 0.5 * math.erfc(math.sqrt(10 ** (ebn0 / 10)))  # Q(sqrt(2Eb/N0))
    lo, hi = pr.ber_ci
    assert lo <= theory <= hi
    assert abs(pr.ber - theory) < 0.1 * theory


def test_ecc_facade_round_trip():
    from ecc_ldpc_tpu_torch.ecc import build_ecc

    ecc = build_ecc("dvbs2/16200/12", "layered/norm:0.8125/10", device="cpu")
    assert (ecc.n, ecc.k) == (16200, get_code("dvbs2/16200/12").k)
    gen = torch.Generator().manual_seed(5)
    msg = torch.randint(0, 2, (2, ecc.k), generator=gen, dtype=torch.uint8)
    cw = ecc.encode(msg)
    out = ecc.decode(ecc.transmit(gen, cw, 3.0))
    assert torch.equal(ecc.extract_message(out.bits), msg)
    assert bool(out.ok.all())
    # the JAX package's default decoder, flooding normalized min-sum, on
    # the unstructured mackay1008 (dense encoder, message at info_cols)
    ecc = build_ecc("mackay1008", device="cpu")
    assert (ecc.n, ecc.k) == (1008, 506)
    msg = torch.randint(0, 2, (3, ecc.k), generator=gen, dtype=torch.uint8)
    out = ecc.decode(ecc.transmit(gen, ecc.encode(msg), 4.0))
    assert torch.equal(ecc.extract_message(out.bits), msg)
    assert bool(out.ok.all())
    # GDBF on the same code: hard-decision flipping at a high Eb/N0
    ecc = build_ecc("mackay1008", "gdbf/theta:-0.5/50", device="cpu")
    msg = torch.randint(0, 2, (3, ecc.k), generator=gen, dtype=torch.uint8)
    out = ecc.decode(ecc.transmit(gen, ecc.encode(msg), 9.0))
    assert torch.equal(ecc.extract_message(out.bits), msg)
    assert bool(out.ok.all())
