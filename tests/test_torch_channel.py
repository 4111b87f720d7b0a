"""The port's BPSK/AWGN front-end against ecc_ldpc_tpu/chan/awgn.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.chan import awgn as jax_awgn
from ecc_ldpc_tpu.codes.spec import CodeSpec as JaxCodeSpec
from ecc_ldpc_tpu_torch.chan import awgn
from ecc_ldpc_tpu_torch.codes.spec import CodeSpec

torch.set_num_threads(1)


@pytest.mark.parametrize("ebn0_db,rate", [(1.5, 0.5), (3.0, 0.75), (-1.0, 0.25)])
def test_sigma_and_llr_match_jax(ebn0_db, rate):
    # rsqrt may differ in the last ulp between the two libraries
    s = awgn.noise_sigma(ebn0_db, rate)
    js = np.asarray(jax_awgn.noise_sigma(ebn0_db, rate))
    assert s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-6)
    y = np.random.default_rng(3).normal(0, 2, (4, 100)).astype(np.float32)
    out = awgn.llr_from_channel(torch.from_numpy(y), s).numpy()
    ref = np.asarray(jax_awgn.llr_from_channel(jnp.asarray(y), js))
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    bits = np.array([0, 1, 1, 0], np.uint8)
    assert np.array_equal(awgn.bpsk(torch.from_numpy(bits)).numpy(),
                          np.asarray(jax_awgn.bpsk(jnp.asarray(bits))))


def test_channel_masks_match_jax():
    H = np.array([[1, 1, 0, 1, 0, 0, 1, 0],
                  [0, 1, 1, 0, 1, 0, 0, 1],
                  [1, 0, 1, 0, 0, 1, 1, 0],
                  [0, 0, 0, 1, 1, 1, 0, 1]], np.uint8)
    kw = dict(punctured_cols=(0, 3), shortened_cols=(6,))
    spec = CodeSpec.from_dense(H, name="masked", **kw)
    jspec = JaxCodeSpec.from_dense(H, name="masked", **kw)
    assert spec.rate == jspec.rate
    keep, add = awgn.channel_masks(spec)
    assert keep.tolist() == [0, 1, 1, 0, 1, 1, 0, 1]
    assert add.tolist() == [0, 0, 0, 0, 0, 0, 60, 0]
    cw = np.zeros((16, 8), np.uint8)
    gen = torch.Generator().manual_seed(0)
    llr = awgn.make_channel(spec)(gen, torch.from_numpy(cw), 2.0).numpy()
    import jax

    jllr = np.asarray(jax_awgn.make_channel(jspec)(
        jax.random.key(0), jnp.asarray(cw), 2.0))
    for a in (llr, jllr):
        assert np.all(a[:, [0, 3]] == 0.0)
        assert np.all(a[:, 6] == 60.0)
        assert np.all(a[:, [1, 2, 4, 5, 7]] != 0.0)


def test_torch_noise_statistics():
    """All-zero codewords: y - 1 is the noise; its mean and variance lie
    within 5 standard errors of 0 and sigma^2."""
    n = 200_000
    rate, ebn0_db = 0.5, 1.0
    gen = torch.Generator().manual_seed(11)
    bits = torch.zeros(n, dtype=torch.uint8)
    llr = awgn.awgn_llr(gen, bits, ebn0_db, rate)
    sigma = float(awgn.noise_sigma(ebn0_db, rate))
    noise = llr.double().numpy() * sigma * sigma / 2.0 - 1.0
    assert abs(noise.mean()) < 5 * sigma / np.sqrt(n)
    var = sigma * sigma
    assert abs(noise.var() - var) < 5 * var * np.sqrt(2.0 / n)
    # same generator seed, same stream
    gen2 = torch.Generator().manual_seed(11)
    assert torch.equal(awgn.awgn_llr(gen2, bits, ebn0_db, rate), llr)


CHANNEL_SPECS = ["bpsk", "AWGN", "hard", "rayleigh", "bsc:0.05", "bec:0.3",
                 "qpsk", "qam64:il", "8psk", "apsk16", "apsk16:r910",
                 "apsk32:g2.8:g5.2:il"]


@pytest.mark.parametrize("spec", CHANNEL_SPECS)
def test_parse_channel_spec_matches_jax(spec):
    from ecc_ldpc_tpu.chan.modem import parse_channel_spec as jax_parse
    from ecc_ldpc_tpu_torch.chan.modem import build_channel, parse_channel_spec

    assert parse_channel_spec(spec) == jax_parse(spec)
    # every spec builds (n = 120: every symbol size divides it) and gives
    # f32 LLRs of the codeword's shape
    code = CodeSpec(name="uncoded", n=120, m=0, row_cols=(), k=120)
    gen = torch.Generator().manual_seed(0)
    llr = build_channel(code, spec)(gen, torch.zeros(2, 120, dtype=torch.uint8),
                                    3.0)
    assert llr.shape == (2, 120) and llr.dtype == torch.float32
