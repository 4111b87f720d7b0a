"""The port's other code families against the JAX package's: 802.11n,
WiMAX, 5G NR (filler, puncturing, graph truncation, the circular buffer),
spatially coupled, punct: and Gallager codes.

Same code string through both packages: the same CodeSpec (n, m, k, name,
base matrix, punctured and shortened columns, H), the same QC graph
tables, and codewords bit-identical to the JAX encoder's that satisfy H,
the NR encoder and ShortenedEncoder included. The plain layered decode is
held to the JAX XLA layered decoder on the same LLRs (min-sum and spa:
bits, ok and iterations identical) on an odd Z (80211n/648/56; the NR
decodes are tests/test_torch_nr5g.py's, row degree 34 is
tests/test_torch_wide.py's); the plain flooding decode of a Gallager code
to the JAX XLA flooding decoder.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.decode.api import get_decoder as jax_get_decoder
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder as jax_layered
from ecc_ldpc_tpu.encode.structured import build_encoder as jax_build_encoder
from ecc_ldpc_tpu.graph import compile_graph as jax_compile_graph
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes import get_code
from ecc_ldpc_tpu_torch.codes.puncture import ShortenedEncoder, shorten
from ecc_ldpc_tpu_torch.decode.api import get_decoder
from ecc_ldpc_tpu_torch.decode.layered_qc import layered_decode_plain
from ecc_ldpc_tpu_torch.encode.structured import build_encoder
from ecc_ldpc_tpu_torch.graph.compile import compile_graph
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

QC_CODES = [
    "80211n/1944/12", "80211n/648/56", "wimax/2304/56", "wimax/1152/23A",
    "nr5g/bg1/384", "nr5g/bg1/208/3168", "nr5g/bg1/384/8448/12672",
    "nr5g/bg2/52/500/1200/rv1", "sc/3/6/10/64", "punct/80211n~1944~12/0:81",
]
CODES = QC_CODES + ["gallager/252/3/6/s0"]
B, T = 6, 10


@pytest.fixture(scope="module", params=CODES)
def both(request):
    name = request.param
    return name, get_code(name), jax_get_code(name)


def llr_of(spec, cw, ebn0_db, rng):
    """BPSK/AWGN LLRs at spec.rate, punctured columns 0 and filler 60, as
    both packages' make_channel masks them."""
    sigma = (2.0 * spec.rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    llr[:, list(spec.punctured_cols)] = 0.0
    llr[:, list(spec.shortened_cols)] = 60.0
    return llr


def test_same_spec(both):
    _, spec, jspec = both
    assert (spec.n, spec.m, spec.k, spec.name, spec.rate) == (
        jspec.n, jspec.m, jspec.k, jspec.name, jspec.rate)
    assert spec.punctured_cols == jspec.punctured_cols
    assert spec.shortened_cols == jspec.shortened_cols
    assert all(np.array_equal(a, b)
               for a, b in zip(spec.row_cols, jspec.row_cols))
    assert (spec.qc is None) == (jspec.qc is None)
    if spec.qc is not None:
        assert spec.qc.Z == jspec.qc.Z
        assert np.array_equal(spec.qc.base, jspec.qc.base)


@pytest.mark.parametrize("code", QC_CODES)
def test_graph_tables_match(code):
    g = compile_qc_graph(get_code(code))
    jg = jax_compile_qc_graph(jax_get_code(code))
    assert (g.Z, g.mb, g.nb, g.num_block_edges, g.dcb_max, g.k) == (
        jg.Z, jg.mb, jg.nb, jg.num_block_edges, jg.dcb_max, jg.k)
    assert np.array_equal(g.be_row, np.asarray(jg.be_row_np))
    assert np.array_equal(g.be_col, np.asarray(jg.be_col_np))
    assert np.array_equal(g.be_shift, np.asarray(jg.be_shift_np))
    assert g.layer_order == jg.layer_order
    assert g.layer_groups == jg.layer_groups
    assert g.intra_layer_dup_free and jg.intra_layer_dup_free
    if code == "nr5g/bg1/384/8448/12672":  # truncated to 13 x 35
        assert (g.mb, g.nb, g.num_block_edges) == (13, 35, 144)


def test_codewords_match_jax(both):
    _, spec, jspec = both
    enc, jenc = build_encoder(spec), jax_build_encoder(jspec)
    assert type(enc).__name__ == type(jenc).__name__
    msg = np.random.default_rng(7).integers(0, 2, (3, spec.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg)).numpy()
    want = (jenc.encode_numpy(msg) if hasattr(jenc, "encode_numpy")
            else np.asarray(jenc(jnp.asarray(msg))))
    assert cw.dtype == np.uint8 and cw.shape == (3, spec.n)
    assert np.array_equal(cw, want)
    assert spec.check_syndrome(cw)
    assert np.array_equal(enc.extract_message(torch.from_numpy(cw)).numpy(),
                          msg)
    if spec.shortened_cols:  # NR filler bits are sent as zeros
        assert not cw[:, list(spec.shortened_cols)].any()


def test_shortened_encoder_matches_jax():
    from ecc_ldpc_tpu.codes.puncture import shorten as jax_shorten

    spec = shorten(get_code("wimax/576/12"), 40)
    jspec = jax_shorten(jax_get_code("wimax/576/12"), 40)
    assert (spec.k, spec.name, spec.shortened_cols) == (
        jspec.k, jspec.name, jspec.shortened_cols)
    enc = build_encoder(spec)
    assert isinstance(enc, ShortenedEncoder) and enc.k_full == 288
    msg = np.random.default_rng(2).integers(0, 2, (4, spec.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg)).numpy()
    assert np.array_equal(cw, jax_build_encoder(jspec).encode_numpy(msg))
    assert np.array_equal(cw, enc.encode_numpy(msg))
    assert spec.check_syndrome(cw)


def decode_case(code: str, ebn0_db: float):
    """(port graph, JAX graph, llr f32 [B, n]) of B encoded frames at
    ebn0_db, seeded."""
    spec, jspec = get_code(code), jax_get_code(code)
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, (B, spec.k), dtype=np.uint8)
    cw = build_encoder(spec)(torch.from_numpy(msg)).numpy()
    return (compile_qc_graph(spec), jax_compile_qc_graph(jspec),
            llr_of(spec, cw, ebn0_db, rng))


def assert_layered_matches_jax(g, jg, llr, cn, max_iters=T,
                               early_term=True):
    """The plain layered decode and the JAX XLA layered decoder on the same
    LLRs: bits, ok and iterations identical (min-sum bit for bit; spa's
    messages differ from XLA:CPU's by ulps, its decisions must not).
    Returns the port's DecodeResult."""
    alpha = 0.8125 if cn == "minsum" else 1.0
    want = jax_layered(jg, alpha=alpha, max_iters=max_iters,
                       early_term=early_term, cn=cn)(jnp.asarray(llr))
    got = layered_decode_plain(g, torch.from_numpy(llr), alpha=alpha,
                               max_iters=max_iters, early_term=early_term,
                               cn=cn)
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations),
                          got.iterations.numpy())
    return got


@pytest.fixture(scope="module")
def odd_z():
    return decode_case("80211n/648/56", 3.0)


@pytest.mark.parametrize("cn", ["minsum", "spa"])
def test_plain_layered_matches_jax(odd_z, cn):
    """Track mode (the sweeps' decoder) on Z = 27: some frames stop
    early and some never."""
    g, jg, llr = odd_z
    assert g.Z % 2 == 1
    got = assert_layered_matches_jax(g, jg, llr, cn)
    its = got.iterations.numpy()
    assert its.min() < T and its.max() == T and bool(got.ok.any())


def test_plain_flooding_matches_jax_on_gallager():
    code, dec = "gallager/252/3/6/s0", "minsum/norm:0.8125/10"
    spec, jspec = get_code(code), jax_get_code(code)
    g, jg = compile_graph(spec), jax_compile_graph(jspec)
    for f in ("cn_vn", "cn_mask", "vn_edge", "vn_mask"):
        assert np.array_equal(getattr(g, f), np.asarray(getattr(jg, f))), f
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 2, (8, spec.k), dtype=np.uint8)
    cw = build_encoder(spec)(torch.from_numpy(msg)).numpy()
    llr = llr_of(spec, cw, 2.0, rng)
    want = jax_get_decoder(jg, dec)(jnp.asarray(llr))
    got = get_decoder(g, dec, device="cpu")(torch.from_numpy(llr))
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations),
                          got.iterations.numpy())
    assert bool(got.ok.any())
