"""Row degree 34 (dvbs2/16200/910) on the CPU: the plain layered decode
takes any degree and matches the JAX XLA layered decoder on the same LLRs
(f32 min-sum bit for bit; spa's decisions, its messages within ulps of
XLA:CPU's), and the decoders built from spec strings run it; the plain
flooding versions (K3's and K2's) decode it too. On the card the 64-wide
builds of K1a, K1c, K3 and K2 take it (chip_smoke.py phase 27)."""
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu_torch.codes import get_code
from ecc_ldpc_tpu_torch.codes.matrixio import dumps_matlab_sparse
from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder
from test_torch_families import assert_layered_matches_jax, decode_case

torch.set_num_threads(1)

CODE = "dvbs2/16200/910"
T = 25


@pytest.fixture(scope="module")
def wide():
    # 6 frames at 4.3 dB: most stop within 6 iterations, not all
    return decode_case(CODE, 4.3)


@pytest.mark.parametrize("cn", ["minsum", "spa"])
def test_plain_layered_matches_jax(wide, cn):
    """layered/norm:0.8125/25 and layered/spa/25 (track mode)."""
    g, jg, llr = wide
    assert g.dcb_max == jg.dcb_max == 34
    got = assert_layered_matches_jax(g, jg, llr, cn, max_iters=T)
    assert bool(got.ok.any())


@pytest.mark.parametrize("dec,mat", [
    ("layered/norm:0.8125/25/noet", False), ("layered/minstar/25", False),
    ("minsum/norm:0.8125/25", False), ("spa/25", False),
    ("minsum/norm:0.8125/25", True), ("spa/25", True)])
def test_decoders_take_degree_34_on_the_cpu(wide, dec, mat, tmp_path):
    """Layered through the plain layered version, flooding through K3's
    plain version on the QC view and (mat) K2's on a mat: load of the
    same H: every frame the layered min-sum decodes, each decodes alike."""
    _, _, llr = wide
    x = torch.from_numpy(llr)
    spec = get_code(CODE)
    ref = get_decoder(choose_graph(spec, "layered/norm:0.8125/25"),
                      "layered/norm:0.8125/25", device="cpu")(x)
    if mat:
        path = tmp_path / "h.mat"
        path.write_text(dumps_matlab_sparse(spec))
        spec = get_code(f"mat:{path}")
        assert spec.qc is None and int(spec.row_deg.max()) == 34
    res = get_decoder(choose_graph(spec, dec), dec, device="cpu")(x)
    assert bool(res.ok.any())
    assert np.array_equal(res.bits.numpy()[ref.ok.numpy()],
                          ref.bits.numpy()[ref.ok.numpy()])
