"""The port's layered exact-BP rules (spa, minstar) against the JAX
package: the check rules against decode/xla/layered.py::_cn_spa_seq and
decode/xla/flooding_qc.py::_cn_minstar_qc, whole decodes against
decode_layered(cn=...) and, once, the Pallas kernel in interpret mode.

Tolerances. XLA:CPU and PyTorch's CPU math compute exp, log, tanh and
log1p to within a few ulps of each other, not bit for bit, so:
- decisions (bits, ok, iterations) must be equal: a few ulps in a message
  do not move a hard decision or the stop rule on these inputs;
- messages must agree within atol 1e-3 / rtol 1e-4. Near |t| -> 1 the
  spa magnitude log1p(t) - log1p(-t) magnifies one ulp of t (6e-8) by
  1/(1-t) <= 1e7 before the clip, and a minstar chain of 30 box-plus
  steps adds up its rounding, so bit-exactness is not the contract here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.decode.api import parse_decoder_spec as jax_parse
from ecc_ldpc_tpu.decode.pallas.layered_qc import make_layered_pallas_decoder
from ecc_ldpc_tpu.decode.xla.flooding_qc import _cn_minstar_qc
from ecc_ldpc_tpu.decode.xla.layered import _cn_spa_seq, decode_layered
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder as JaxDDE
from ecc_ldpc_tpu.encode.structured import build_encoder as jax_build_encoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.decode.api import get_decoder, parse_decoder_spec
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    _cn_minstar,
    _cn_spa,
    layered_decode_plain,
    make_layered_decoder,
)

torch.set_num_threads(1)

T = 8
ATOL, RTOL = 1e-3, 1e-4


def _port_graph(jg):
    return graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                            jg.be_col_np, jg.be_shift_np, jg.name)


def _llr(cw, rate, ebn0_db, rng):
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX QCGraph, port QCGraph, llr f32 [B, n])}: the z16
    surrogate of tests/test_torch_layered_qc.py (B=32) and wimax/576/12
    as tests/pallas/test_exact_kinds.py sets it up (Z=24, B=16), each at
    an Eb/N0 where 8 iterations decode some frames and not others."""
    out = {}
    rng = np.random.default_rng(5)
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    jspec = jax_expand_qc(JaxQCCode(Z=16, base=base), name="test.z16",
                          k=8 * 16)
    jg = jax_compile_qc_graph(jspec)
    msg = rng.integers(0, 2, (32, jspec.k), dtype=np.uint8)
    cw = JaxDDE(jspec).encode_numpy(msg)
    sigma = 0.62
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    out["z16"] = (jg, _port_graph(jg), (2.0 * y / sigma ** 2).astype(np.float32))
    spec = jax_get_code("wimax/576/12")
    jg = jax_compile_qc_graph(spec)
    rng = np.random.default_rng(7)
    msg = rng.integers(0, 2, (16, spec.k), dtype=np.uint8)
    cw = jax_build_encoder(spec).encode_numpy(msg)
    out["wimax576"] = (jg, _port_graph(jg), _llr(cw, spec.rate, 1.4, rng))
    return out


def _rule_input(d: int) -> np.ndarray:
    """V f32 [d, 4, 16] with ±0.0, magnitudes above 40, and ±1e9."""
    rng = np.random.default_rng(100 + d)
    V = rng.normal(0.0, 3.0, (d, 4, 16)).astype(np.float32)
    V[0, 0, :4] = [0.0, -0.0, 55.0, -1e9]
    V[-1, 1, :4] = [-0.0, 1e9, -47.5, 0.0]
    if d > 1:
        V[1, 2, :3] = [0.0, -0.0, 0.0]
        V[:, 3, 5] = 45.0  # every input saturates the tanh clip
    return V


@pytest.mark.parametrize("d", [1, 2, 8, 31])
@pytest.mark.parametrize("cn", ["spa", "minstar"])
def test_rules_match_jax(cn, d):
    V = _rule_input(d)
    if cn == "spa":
        want = np.asarray(_cn_spa_seq(jnp.asarray(V), signbit=True))
        got = _cn_spa(torch.from_numpy(V)).numpy()
        # the sign is the XOR of the other slots' sign bits: exact
        assert np.array_equal(np.signbit(got), np.signbit(want))
    else:
        want = np.asarray(_cn_minstar_qc(jnp.asarray(V), 1.0, 0.0))
        got = _cn_minstar(torch.from_numpy(V)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["z16", "wimax576"])
@pytest.mark.parametrize("cn", ["spa", "minstar"])
@pytest.mark.parametrize("mode", ["fixed", "track"])
def test_exact_decode_matches_jax(graphs, name, cn, mode):
    jg, g, llr = graphs[name]
    et = mode == "track"
    want = decode_layered(jg, jnp.asarray(llr), cn=cn, max_iters=T,
                          early_term=et)
    got = layered_decode_plain(g, torch.from_numpy(llr), cn=cn, max_iters=T,
                               early_term=et)
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())
    # some frames decode and some do not, so the parity and the freeze
    # mean something
    assert 0 < int(got.ok.sum()) < len(llr)
    if et:
        assert int(got.iterations.min()) < T


def test_plain_matches_pallas_interpret(graphs):
    jg, g, llr = graphs["z16"]
    dec = make_layered_pallas_decoder(jg, kind="spa", max_iters=T,
                                      early_term=True, batch_tile=32,
                                      interpret=True)
    want = dec(jnp.asarray(llr))
    got = layered_decode_plain(g, torch.from_numpy(llr), cn="spa",
                               max_iters=T, early_term=True)
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())


SPECS = [
    "layered/spa/25",
    "layered/minstar/25/noet",
    "layered/minsum/norm:0.75/20",
    "layered/norm:0.8125/offset:0.15/25/noet",
    "layered/norm:0.8125/50;retry=layered/spa/50",
    "layered/sched:dvbs2_64800_12_T25_op2",
    "layered/spa/sched:dvbs2_64800_12_T25_op2/20",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_decoder_spec_matches_jax(spec):
    want, got = jax_parse(spec), parse_decoder_spec(spec)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        if k in ("alpha", "beta") and np.ndim(v):  # a schedule's arrays
            v = np.asarray(v)
            assert np.array_equal(v, got[k]) and got[k].dtype == v.dtype
        else:
            assert got[k] == v


def test_exact_rules_reject_a_schedule(graphs):
    _, g, _ = graphs["z16"]
    with pytest.raises(ValueError, match="minsum only"):
        get_decoder(g, "layered/spa/sched:dvbs2_64800_12_T25_op2/20",
                    device="cpu")
    with pytest.raises(ValueError, match="minsum only"):
        make_layered_decoder(g, alpha=np.full(4, 0.8, np.float32),
                             max_iters=4, cn="minstar", device="cpu")
    with pytest.raises(KeyError):
        make_layered_decoder(g, cn="bp", device="cpu")
    # scalar alpha/beta are taken and ignored, as in the JAX package
    x = torch.from_numpy(graphs["z16"][2])
    a = layered_decode_plain(g, x, alpha=0.5, beta=0.3, max_iters=3, cn="spa")
    b = layered_decode_plain(g, x, max_iters=3, cn="spa")
    assert torch.equal(a.bits, b.bits) and torch.equal(a.iterations,
                                                       b.iterations)
