"""The layered ablation kernels' plain version (E1,
ecc_ldpc_tpu_torch/experiments/ablate.py) against the TPU script's Pallas
kernel (experiments/ablate_layered.py) run in interpret mode, on the z16
surrogate of tests/test_torch_layered_qc.py; and the static sweep's
generated header, the storage mapping and the wrapper's rules. E2 and E3
are tests/test_torch_experiments_layered2.py's, so that the two files'
JAX builds run on two workers.

The scripts call pl.pallas_call without interpret=True and size their
tiles by module globals, so the fixtures patch pallas_call with
interpret=True and lower Bt to 8 and ITERS to 3, for their own scope only.
The TPU kernels read LLRs and write bits in the delta-shift storage
[nb, Z, Bt]; the port's decode3 maps them onto variables and back, so the
bits must be identical.
"""
import functools

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import experiments.ablate_layered as je1
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch import _build
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.experiments import (
    ablate,
    ablate_layered,
    ablate_layered2,
    static_unroll,
)
from ecc_ldpc_tpu_torch.experiments.variants import (
    E1_VARIANTS,
    E2_VARIANTS,
    E3_FLAGS,
    ROLL,
)

torch.set_num_threads(1)

BT, ITERS = 8, 3
E1_FLAGS = dict(roll_on=True, sign_on=True, min2_on=True, vrow_on=True,
                castq_on=True)
# the script's variant table (ablate_layered.py:150-159) as flag overrides
E1_OFF = {"full": (), "noroll": ("roll_on",), "nosign": ("sign_on",),
          "nomin2": ("min2_on",), "novrow": ("vrow_on",),
          "nocastq": ("castq_on",), "floor": tuple(E1_FLAGS)}


@pytest.fixture(scope="module")
def z16():
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    jspec = jax_expand_qc(JaxQCCode(Z=16, base=base), name="test.z16",
                          k=8 * 16)
    jg = jax_compile_qc_graph(jspec)
    g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name)
    rng = np.random.default_rng(7)
    llr3 = (1.5 * rng.standard_normal((jg.nb, jg.Z, BT)) + 0.5).astype(
        np.float32)
    return jg, g, llr3


@pytest.fixture(scope="module")
def jax_bits(z16):
    """{variant: bits int8 [nb, Z, Bt]} of E1's variants, each built once
    with pallas_call in interpret mode."""
    jg, _, llr3 = z16
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(je1, "Bt", BT)
    mp.setattr(je1, "ITERS", ITERS)
    try:
        return {v: np.asarray(je1.build(
            jg, **dict(E1_FLAGS, **{k: False for k in off}))(llr3))
            for v, off in E1_OFF.items()}
    finally:
        mp.undo()


def _port(z16, flags):
    _, g, llr3 = z16
    bits = ablate.decode3(g, torch.from_numpy(llr3), flags, ITERS)
    assert bits.dtype == torch.int8 and bits.shape == llr3.shape
    return bits.numpy()


@pytest.mark.parametrize("variant", list(E1_VARIANTS))
def test_e1_plain_matches_jax(z16, jax_bits, variant):
    got = _port(z16, E1_VARIANTS[variant])
    np.testing.assert_array_equal(got, jax_bits[variant])


def test_e1_variants_touch_the_bits(jax_bits):
    """The ablations change what is computed: each but nocastq (whose
    posteriors differ from full's by bf16 roundings only) differs from
    full in the bits."""
    for v, bits in jax_bits.items():
        if v not in ("full", "nocastq"):
            assert not np.array_equal(bits, jax_bits["full"]), v


def test_storage_mapping_round_trips(z16):
    _, g, llr3 = z16
    x = torch.from_numpy(llr3)
    for roll in (True, False):
        v = ablate.to_var(g, x, roll)
        assert v.shape == (BT, g.n)
        assert torch.equal(ablate.from_var(g, v, roll), x)
    # variable (c, w) is storage row (w - a0[c]) mod Z
    a0 = ablate.last_touch(g)
    v = ablate.to_var(g, x, True)
    c, w = 5, 3
    assert torch.equal(v[:, c * g.Z + w], x[c, (w - a0[c]) % g.Z])
    assert torch.equal(ablate.to_var(g, x, False)[:, c * g.Z + w], x[c, w])


def test_static_header_is_current():
    g = ablate.static_graph()
    plan = ablate.ablate_plan(g, ablate.THROUGHPUT_B)
    assert plan.frames == 1 and plan.cluster == 1
    text = ablate.static_header(g, plan)
    assert ablate.STATIC_HEADER.read_text() == text
    assert f"kStaticChip = {plan.chip};" in text
    assert text.count("  ROW(") == g.mb
    # every batch takes the same plan, so the header serves them all
    for B in (1, 8, ablate.TILE):
        assert ablate.ablate_plan(g, B).home == plan.home


def test_libraries_and_wrapper_rules(z16):
    _, g, _ = z16
    assert set(_build.ABLATE_STATIC_FLAGS) == set(E2_VARIANTS.values()) | {
        E3_FLAGS}
    for fl in _build.ABLATE_STATIC_FLAGS:
        name = ablate.library_of(fl, True)
        assert _build.LIBRARIES[name] == (
            "ablate_layered", (f"-DABLATE_STATIC_FLAGS={fl}",))
    with pytest.raises(ValueError, match="no static library"):
        ablate.library_of(E1_VARIANTS["full"], True)
    assert ablate.library_of(E1_VARIANTS["floor"], False) == "ablate_layered"
    with pytest.raises(ValueError, match="E1's variants"):
        ablate.library_of(E2_VARIANTS["full"], False)
    llr = torch.zeros((2, g.n))
    before = ablate.ablate_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ablate.ablate_cuda(g, llr, E1_VARIANTS["full"])
    assert ablate.ablate_cuda.launches == before
    # without the roll nothing rotates: the storage is the variables
    assert E1_VARIANTS["noroll"] & ROLL == 0


@pytest.mark.parametrize("mod", [ablate_layered, ablate_layered2,
                                 static_unroll])
def test_main_needs_the_card_unless_cpu(mod):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--iters", "1"])


def test_main_runs_on_the_cpu(capsys):
    assert static_unroll.main(["--device", "cpu", "--iters", "1",
                               "--batches", "2,3", "--tries", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("static bits == E1 full bits: True") == 2
    assert ablate_layered2.main(["--device", "cpu", "--iters", "1",
                                 "--batch", "2", "--tries", "1"]) == 0
    assert "saves" in capsys.readouterr().out
