"""The post-decode forms of the port against the JAX package: the bit-flip
cleanup (decode/cleanup.py against decode/xla/cleanup.py) and the
bit-flipping decoders (decode/bitflip.py against decode/xla/bitflip.py:
majority flipping and GDBF, the QC form on 80211n/648/12 and the
unstructured form on mackay1008, with and without early termination).

Inputs from a numpy seed: 80211n/648/12 codewords from the port's encoder
with 1-3 bits flipped (and clean ones) for the cleanup; LLRs of the
all-zero codeword over BPSK + AWGN for the decoders (both decoders treat
every codeword alike).

Tolerances. Cleanup and majority flipping count integers: bits, ok and
iterations identical. GDBF adds integer check terms to w * x~ * y, whose
per-frame weight w = 1 / mean|llr| the two packages sum in different
orders, so it may differ by an ulp: the frames must be identical except
those whose metric came within 1e-5 of theta in the port's decode
(decode_bitflip(margin=True)); the test lists them and allows only those.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.decode.xla.bitflip import make_bitflip_decoder as jax_bf
from ecc_ldpc_tpu.decode.xla.cleanup import bitflip_cleanup as jax_cleanup
from ecc_ldpc_tpu.graph.compile import compile_graph as jax_compile_graph
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import get_decoder
from ecc_ldpc_tpu_torch.decode.bitflip import decode_bitflip
from ecc_ldpc_tpu_torch.decode.cleanup import bitflip_cleanup
from ecc_ldpc_tpu_torch.decode.layered_qc import layered_decode_plain
from ecc_ldpc_tpu_torch.encode.structured import build_encoder
from ecc_ldpc_tpu_torch.graph.compile import compile_graph
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

B = 48
THETA = -0.5
NEAR_THETA = 1e-5


def _zero_cw_llr(n, rate, ebn0_db, rng):
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def codes():
    """{name: (JAX graph, port graph, llr f32 [B, n])}: 80211n/648/12 in
    the QC form, mackay1008 in the unstructured form, both at 6 dB, where
    either decoder decodes some frames and not others."""
    qc = "80211n/648/12"
    spec = get_code(qc)
    mk = get_code("mackay1008")
    return {
        "qc": (jax_compile_qc_graph(jax_get_code(qc)), compile_qc_graph(spec),
               _zero_cw_llr(spec.n, spec.rate, 6.0,
                            np.random.default_rng(41))),
        "mm": (jax_compile_graph(jax_get_code("mackay1008")),
               compile_graph(mk),
               _zero_cw_llr(mk.n, mk.rate, 6.0, np.random.default_rng(42))),
    }


def test_cleanup_matches_jax():
    """Codewords with 0-3 wrong bits: identical bits and ok; clean frames
    untouched; the single flips all repaired."""
    code = "80211n/648/12"
    spec = get_code(code)
    jg = jax_compile_qc_graph(jax_get_code(code))
    g = compile_qc_graph(spec)
    rng = np.random.default_rng(7)
    msg = rng.integers(0, 2, (B, spec.k), dtype=np.uint8)
    cw = build_encoder(spec)(torch.from_numpy(msg)).numpy()
    bits = cw.copy()
    flips = np.arange(B) % 4  # 0, 1, 2 or 3 wrong bits
    for f in range(B):
        pos = rng.choice(spec.n, flips[f], replace=False)
        bits[f, pos] ^= 1
    want_bits, want_ok = jax_cleanup(jg, jnp.asarray(bits))
    got_bits, got_ok = bitflip_cleanup(g, torch.from_numpy(bits))
    assert np.array_equal(np.asarray(want_bits), got_bits.numpy())
    assert np.array_equal(np.asarray(want_ok), got_ok.numpy())
    clean = flips == 0
    assert np.array_equal(got_bits.numpy()[clean], cw[clean])
    assert got_ok.numpy()[clean].all()
    one = flips == 1
    assert np.array_equal(got_bits.numpy()[one], cw[one])
    assert not got_ok.numpy()[flips >= 2].all()  # some remain detected


def test_cleanup_spec_wraps_the_decoder(codes):
    """'/cleanup' on the CPU: the layered decode, then bitflip_cleanup of
    its bits; iterations are the decoder's."""
    _, g, _ = codes["qc"]
    # at 1 dB 3 sweeps leave failures for the cleanup to work on
    x = torch.from_numpy(_zero_cw_llr(g.n, 0.5, 1.0,
                                      np.random.default_rng(43)))
    res = get_decoder(g, "layered/norm:0.8125/3/cleanup", device="cpu")(x)
    plain = layered_decode_plain(g, x, alpha=0.8125, max_iters=3)
    bits, ok = bitflip_cleanup(g, plain.bits)
    assert torch.equal(res.bits, bits) and torch.equal(res.ok, ok)
    assert torch.equal(res.iterations, plain.iterations)
    assert not bool(plain.ok.all())


# (graph form, variant, early termination)
BF_CASES = [(form, var, et) for form in ("qc", "mm")
            for var in ("maj", "gdbf") for et in (True, False)]


@pytest.mark.parametrize("form,variant,et", BF_CASES,
                         ids=[f"{f}_{v}_{'et' if e else 'noet'}"
                              for f, v, e in BF_CASES])
def test_bitflip_matches_jax(codes, form, variant, et):
    jg, g, llr = codes[form]
    kw = dict(variant=variant, theta=THETA, max_iters=50, early_term=et)
    want = jax_bf(jg, **kw)(jnp.asarray(llr))
    got, margin = decode_bitflip(g, torch.from_numpy(llr), margin=True, **kw)
    wb, wok, wit = (np.asarray(want.bits), np.asarray(want.ok),
                    np.asarray(want.iterations))
    same = ((wb == got.bits.numpy()).all(1) & (wok == got.ok.numpy())
            & (wit == got.iterations.numpy()))
    if variant == "maj":
        assert same.all()
    else:
        differ = np.flatnonzero(~same)
        near = np.flatnonzero(margin.numpy() < NEAR_THETA)
        assert set(differ) <= set(near), (differ, near)
    ok = got.ok.numpy()
    assert 0 < ok.sum() < B
    assert int(got.iterations.max()) > 0


def test_bitflip_spec_routes(codes):
    """bitflip/N and gdbf/theta:T/N build the port's decoders on either
    graph form; the frames decoded match decode_bitflip."""
    for form in ("qc", "mm"):
        _, g, llr = codes[form]
        x = torch.from_numpy(llr)
        for spec, variant in (("bitflip/20", "maj"),
                              ("gdbf/theta:-0.5/20/noet", "gdbf")):
            res = get_decoder(g, spec, device="cpu")(x)
            want = decode_bitflip(g, x, variant=variant, theta=-0.5,
                                  max_iters=20,
                                  early_term=not spec.endswith("noet"))
            assert torch.equal(res.bits, want.bits)
            assert torch.equal(res.iterations, want.iterations)


def test_bitflip_needs_no_card_on_cpu_and_rejects_unknown(codes):
    _, g, llr = codes["qc"]
    with pytest.raises(KeyError):
        decode_bitflip(g, torch.from_numpy(llr), variant="wbf")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_decoder(g, "bitflip/50")
