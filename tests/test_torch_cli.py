"""The port's CLI (python -m ecc_ldpc_tpu_torch.cli): a CPU sweep writes a
results file the JAX package reads, compare and plot read it back, and
what is not ported says which ROADMAP step it waits for."""
import json

import pytest
import torch

from ecc_ldpc_tpu.sim.runner import PointResult as JaxPointResult
from ecc_ldpc_tpu_torch.cli.main import main, parse_ebn0

torch.set_num_threads(1)

SWEEP = ["sweep", "--code", "dvbs2/16200/12",
         "--decoder", "layered/norm:0.8125/8;retry=layered/spa/8",
         "--ebn0", "0.8,3.0", "--batch", "4", "--max-frames", "4",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def results_file(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli") / "res.json")
    assert main(SWEEP + ["--out", out]) == 0
    return out


def test_sweep_writes_results_the_jax_package_reads(results_file, capsys):
    with open(results_file) as f:
        pts = [JaxPointResult.from_json(d) for d in json.load(f)]
    assert [p.ebn0_db for p in pts] == [0.8, 3.0]
    for p in pts:
        assert p.code == "dvbs2/16200/12" and p.frames == 4 and p.steps == 1
        assert p.decoder == "layered/norm:0.8125/8;retry=layered/spa/8"
    # at 0.8 dB most frames fail the primary and go to the fallback, so
    # some frame used more than the primary's 8 iterations
    assert pts[0].iters_sum > 4 * 8 or pts[0].frame_errors > 0
    assert pts[1].frame_errors == 0


def test_compare_and_plot(results_file, capsys):
    assert main(["compare", results_file, results_file]) == 0
    out = capsys.readouterr().out
    assert "FER curves overlap: YES" in out and "BER curves overlap: YES" in out
    assert main(["plot", results_file, "--metric", "ber"]) == 0
    assert "BER vs Eb/N0" in capsys.readouterr().out


def test_not_ported_yet_names_its_roadmap_step(tmp_path, capsys):
    # --mesh is ported: one process is a 1x1 mesh, so 2x1 needs two ranks,
    # and the sharded step refuses a ';retry=' decoder, as the reference does
    with pytest.raises(ValueError, match="mesh 2x1"):
        main(SWEEP + ["--mesh", "2x1"])
    with pytest.raises(ValueError, match="host-level"):
        main(SWEEP + ["--mesh", "1x1"])
    for cmd in ("findsnr", "trap", "bench", "learn"):
        assert main([cmd, "--code", "dvbs2/64800/12"]) == 2
        assert "ROADMAP.md Queue 1 step" in capsys.readouterr().err
    # the bit-flipping decoders are ported: a sweep on the CPU, and the
    # JAX package's KeyError for a /pallas override
    bf = tmp_path / "bitflip.json"
    assert main(["sweep", "--code", "dvbs2/16200/12", "--decoder",
                 "bitflip/5", "--ebn0", "1.0", "--batch", "2",
                 "--max-frames", "2", "--device", "cpu",
                 "--out", str(bf)]) == 0
    (pt,) = json.loads(bf.read_text())
    assert pt["decoder"] == "bitflip/5" and pt["frames"] == 2
    with pytest.raises(KeyError, match="Pallas"):
        main(["sweep", "--code", "dvbs2/16200/12", "--decoder", "bitflip/5",
              "--backend", "pallas", "--ebn0", "1.0", "--device", "cpu"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"code": "dvbs2/16200/12",
                               "decoder": "layered/norm:0.8125/2",
                               "ebn0": [5.0], "batch": 2, "max-frames": 2}))
    out = tmp_path / "cfg_res.json"
    assert main(["sweep", "--ebn0", "0", "--config", str(cfg), "--device",
                 "cpu", "--out", str(out)]) == 0
    (pt,) = json.loads(out.read_text())
    assert pt["ebn0_db"] == 5.0 and pt["frames"] == 2


def test_parse_ebn0():
    assert parse_ebn0("0:1:0.25") == (0.0, 0.25, 0.5, 0.75, 1.0)
    assert parse_ebn0("1,2,3.5") == (1.0, 2.0, 3.5)
    assert parse_ebn0([1, 2]) == (1.0, 2.0)
