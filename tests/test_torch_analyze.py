"""The port's code analysis (codes/analyze.py) and thresholds
(codes/threshold.py) against the JAX package's on three codes, and the
port's `cli codes` subcommand against the JAX CLI's output."""
import json

import pytest
import torch

from ecc_ldpc_tpu.cli.main import main as jax_main
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.analyze import analyze as jax_analyze
from ecc_ldpc_tpu.codes.analyze import count_4cycles as jax_count_4cycles
from ecc_ldpc_tpu.codes.analyze import format_info as jax_format_info
from ecc_ldpc_tpu.codes.threshold import bec_threshold as jax_bec_threshold
from ecc_ldpc_tpu.codes.threshold import (
    de_threshold_ebn0 as jax_de_threshold_ebn0,
)
from ecc_ldpc_tpu_torch.cli.main import main
from ecc_ldpc_tpu_torch.codes import get_code
from ecc_ldpc_tpu_torch.codes.analyze import analyze, count_4cycles, format_info
from ecc_ldpc_tpu_torch.codes.threshold import bec_threshold, de_threshold_ebn0

torch.set_num_threads(1)

CODES = ["80211n/648/56", "nr5g/bg2/52/500/1200/rv1", "gallager/252/3/6/s0"]


@pytest.mark.parametrize("code", CODES)
def test_analyze_matches_jax(code):
    spec, jspec = get_code(code), jax_get_code(code)
    info = analyze(spec)
    assert info == jax_analyze(jspec)
    assert format_info(info) == jax_format_info(info)
    assert count_4cycles(spec) == jax_count_4cycles(jspec)
    assert analyze(spec, cycles=False) == jax_analyze(jspec, cycles=False)


@pytest.mark.parametrize("code", CODES)
def test_thresholds_match_jax(code):
    spec, jspec = get_code(code), jax_get_code(code)
    assert de_threshold_ebn0(spec) == jax_de_threshold_ebn0(jspec)
    assert bec_threshold(spec) == jax_bec_threshold(jspec)


def test_cli_codes_matches_jax(capsys):
    runs = [["codes"],
            ["codes", "--info", "80211n/648/56", "--info", "sc/3/6/10/32"],
            ["codes", "--info", "nr5g/bg2/52/500/1200/rv1", "--json",
             "--no-cycles"],
            ["codes", "--threshold", "wimax/576/12"]]
    for argv in runs:
        assert main(argv) == 0
        got = capsys.readouterr().out
        assert jax_main(argv) == 0
        assert got == capsys.readouterr().out
    assert main(runs[0]) == 0
    assert "nr5g" in capsys.readouterr().out.split()
    main(runs[2])
    info = json.loads(capsys.readouterr().out)
    assert info["punctured_bits"] == 1484 and info["qc"]["Z"] == 52
