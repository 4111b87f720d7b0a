"""The port's bench modules (ab, pipeline, scaling, profile.trace) and the
CLI's findsnr, trap, bench and learn on the CPU: parsing, the CPU runs at a
tiny size, and the card-only paths refusing the CPU. No timing is
asserted (the card's numbers come from chip_smoke.py)."""
import json

import pytest
import torch

from ecc_ldpc_tpu_torch.bench.ab import ABResult, ab_compare
from ecc_ldpc_tpu_torch.bench.pipeline import (
    PipelineBenchResult,
    run_pipeline_benchmark,
)
from ecc_ldpc_tpu_torch.bench.profile import trace
from ecc_ldpc_tpu_torch.bench.scaling import run_scaling
from ecc_ldpc_tpu_torch.bench.throughput import run_benchmark
from ecc_ldpc_tpu_torch.cli.main import build_parser, main

torch.set_num_threads(1)


def test_parser_takes_the_jax_flags():
    p = build_parser()
    a = p.parse_args(["findsnr", "--code", "c", "--target-fer", "0.1",
                      "--bracket", "1:2", "--tol-db", "0.1", "--max-frames",
                      "8", "--channel", "qpsk", "--backend", "pallas",
                      "--profile-dir", "d", "-v", "--device", "cpu"])
    assert (a.target_fer, a.bracket, a.tol_db, a.max_frames, a.channel,
            a.backend, a.profile_dir, a.verbose, a.device) == (
        0.1, "1:2", 0.1, 8, "qpsk", "pallas", "d", True, "cpu")
    a = p.parse_args(["trap", "--ebn0", "2.0"])
    assert (a.frames, a.channel, a.out, a.batch, a.seed, a.device) == (
        1 << 14, "bpsk", None, 256, 0, "cuda")
    a = p.parse_args(["bench", "--ab", "--decoder", "x", "--decoder", "y"])
    assert a.ab and not a.pipeline and a.decoder == ["x", "y"]
    a = p.parse_args(["learn", "--ebn0", "1.8:2.6", "--out", "s.json"])
    assert (a.iters, a.steps, a.lr, a.init_alpha, a.alpha_only,
            a.beta_only) == (25, 100, 1e-2, 0.8125, False, False)
    a = p.parse_args(["sweep", "--ebn0", "1", "--profile-dir", "d"])
    assert a.profile_dir == "d"
    for argv in (["trap"], ["learn", "--ebn0", "1"], ["sweep", "--mystery"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)


def test_bench_refuses_the_cpu():
    with pytest.raises(SystemExit, match="--ab needs >=2"):
        main(["bench", "--ab", "--code", "mackay1008", "--device", "cpu"])
    for argv in (["bench", "--device", "cpu"],
                 ["bench", "--pipeline", "--device", "cpu"],
                 ["bench", "--ab", "--decoder", "minsum/5",
                  "--decoder", "minsum/10", "--device", "cpu"]):
        with pytest.raises(ValueError, match="no CPU mode"):
            main(argv)
    arms = [("mackay1008", "minsum/5"), ("mackay1008", "minsum/10")]
    for fn in (lambda: ab_compare(arms, device="cpu"),
               lambda: run_pipeline_benchmark(device="cpu"),
               lambda: run_scaling(device="cpu"),
               lambda: run_benchmark(device="cpu")):
        with pytest.raises(ValueError, match="no CPU mode"):
            fn()


def test_result_lines():
    ab = ABResult(labels=["a|x", "a|y"], mbps=[10.0, 5.0], ratios=[1.0, 0.5],
                  reps=3)
    line = json.loads(ab.json_line())
    assert line["metric"] == "ab_compare" and line["reps"] == 3
    assert [a["vs_arm0"] for a in line["arms"]] == [1.0, 0.5]
    pl = PipelineBenchResult(encode_mbps=100.0, pipeline_mbps=10.0,
                             decode_share=0.9, code="c", decoder="d",
                             batch=4, device="cpu")
    line = json.loads(pl.json_line())
    assert line["metric"] == "pipeline_throughput"
    assert line["decode_share"] == 0.9 and line["device"] == "cpu"


def test_trace(tmp_path):
    with trace(None) as path:
        assert path is None
    with trace(str(tmp_path / "p")) as path:
        torch.ones(4).sum()
    assert path.parent == tmp_path / "p" and path.name.startswith("trace_")
    assert "traceEvents" in json.loads(path.read_text())


def test_subcommands_run_on_the_cpu(tmp_path, capsys):
    """findsnr, trap and learn at a tiny size with --device cpu; the sweep's
    and trap's --profile-dir write a trace each."""
    prof = tmp_path / "prof"
    assert main(["findsnr", "--code", "bpsk/64", "--decoder", "minsum/1",
                 "--target-fer", "0.1", "--bracket", "2:12", "--tol-db",
                 "1.0", "--batch", "256", "--max-frames", "1024",
                 "--device", "cpu", "-v"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("  probe ") for ln in lines) == 4
    op = json.loads(lines[-1])
    assert op["code"] == "bpsk/64" and 2.0 < op["ebn0_db"] < 12.0
    out = tmp_path / "trap.json"
    assert main(["trap", "--code", "80211n/648/12", "--decoder",
                 "minsum/norm:0.8125/5", "--ebn0", "2.0", "--frames", "32",
                 "--batch", "32", "--device", "cpu", "--out", str(out),
                 "--profile-dir", str(prof)]) == 0
    assert "80211n/648/12 | minsum/norm:0.8125/5" in capsys.readouterr().out
    assert json.loads(out.read_text())["frames"] == 32
    assert main(["sweep", "--code", "80211n/648/12", "--decoder",
                 "layered/norm:0.8125/5", "--ebn0", "3", "--batch", "4",
                 "--max-frames", "4", "--device", "cpu",
                 "--profile-dir", str(prof)]) == 0
    assert len(list(prof.glob("trace_*.json"))) == 2
