"""The dc-major flooding min-sum's plain version (E4,
ecc_ldpc_tpu_torch/experiments/smallcode_opt2.py) against the TPU script's
Pallas kernel (experiments/smallcode_opt2.py::make_dcmajor_decoder, which
picks interpret mode itself off the TPU) on two small unstructured codes:
a (3,6)-regular Gallager code (n = 96) and a seeded irregular one (n = 120,
row degrees 3-7, so the dc-major layout has padded slots). Both have
n_pad == m_pad == 128, where the script's cn_only variant runs. Same
numpy-seeded LLRs on both sides: bits, ok and iterations must be
identical, which holds with each variable's sum taken in ascending edge
order, as XLA:CPU's product sums it here.
"""
import numpy as np
import pytest
import torch

import experiments.smallcode_opt2 as jsc
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.spec import CodeSpec as JaxCodeSpec
from ecc_ldpc_tpu.graph import compile_graph as jax_compile_graph
from ecc_ldpc_tpu_torch.convert import compiled_graph_from_numpy
from ecc_ldpc_tpu_torch.experiments import smallcode_opt2 as sc

torch.set_num_threads(1)

B, T = 16, 6


def _irregular() -> JaxCodeSpec:
    rng = np.random.default_rng(11)
    n, m = 120, 60
    rows = tuple(np.sort(rng.choice(n, rng.integers(3, 8), replace=False))
                 .astype(np.int32) for _ in range(m))
    return JaxCodeSpec(name="test.irregular120", n=n, m=m, row_cols=rows)


CODES = {"gallager96": lambda: jax_get_code("gallager/96/3/6/s0"),
         "irregular120": _irregular}


@pytest.fixture(scope="module", params=list(CODES))
def code(request):
    jg = jax_compile_graph(CODES[request.param]())
    g = compiled_graph_from_numpy(jg.n, jg.m, jg.k, np.asarray(jg.cn_vn),
                                  np.asarray(jg.cn_mask),
                                  np.asarray(jg.vn_edge),
                                  np.asarray(jg.vn_mask), jg.name)
    rng = np.random.default_rng(3)
    sigma = 0.8  # the all-zero codeword through AWGN: some frames fail
    y = 1.0 + sigma * rng.standard_normal((B, jg.n))
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    return request.param, jg, g, llr


@pytest.mark.parametrize("variant", sc.VARIANTS)
def test_plain_matches_jax(code, variant):
    name, jg, g, llr = code
    ref = jsc.make_dcmajor_decoder(jg, max_iters=T, variant=variant)(llr)
    got = sc.dcmajor(g, torch.from_numpy(llr), variant, T)
    assert got.bits.dtype == torch.uint8 and got.ok.dtype == torch.bool
    assert got.iterations.dtype == torch.int32
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    if variant == "full":
        ok = int(got.ok.sum())
        assert 0 < ok < B, (name, ok)  # a decode with some failures


def test_tables_and_padding(code):
    _, jg, g, _ = code
    t = sc.tables(g)
    m, dc = g.m, g.dc_max
    cn_vn, mask = np.asarray(jg.cn_vn), np.asarray(jg.cn_mask)
    for i in range(m):
        for j in range(dc):
            want = cn_vn[i, j] if mask[i, j] else -1
            assert t["cn"][j * m + i] == want
    # every real edge once, each variable's in ascending order
    real = np.flatnonzero(t["cn"] >= 0)
    assert sorted(t["vedge"].tolist()) == real.tolist()
    for v in range(g.n):
        es = t["vedge"][t["vptr"][v]:t["vptr"][v + 1]]
        assert np.all(np.diff(es) > 0) and np.all(t["cn"][es] == v)
        assert np.array_equal(t["vmat"][v][t["vmat"][v] >= 0], es)


def test_plan_and_wrapper_rules(code):
    _, _, g, _ = code
    p = sc.dcmajor_plan(g, 2048, 132)
    assert p["frames"] * p["tiles"] >= 2048 and p["blocks"] <= 132
    assert p["smem"] <= 232_448
    mackay = sc.dcmajor_plan(
        compiled_graph_from_numpy(1008, 504, 504,
                                  np.zeros((504, 6), np.int32),
                                  np.ones((504, 6), bool),
                                  np.zeros((1008, 3), np.int32),
                                  np.ones((1008, 3), bool)), 2048, 132)
    # 20,160 B a frame: 11 fit a block, so 2 waves of tiles of 8
    assert (mackay["frames"], mackay["tiles"]) == (8, 256)
    before = sc.dcmajor_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.dcmajor_cuda(g, torch.zeros((2, g.n)))
    assert sc.dcmajor_cuda.launches == before


def test_main_runs_on_the_cpu(capsys):
    assert sc.main(["mackay1008", "--device", "cpu", "--batch", "4",
                    "--iters", "2", "--tries", "1"]) == 0
    out = capsys.readouterr().out
    assert "dcmajor/cn_only/bf16" in out and "saves" in out


def test_main_needs_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc.main(["mackay1008", "--batch", "4", "--iters", "2"])
