"""The port's channel layer (ecc_ldpc_tpu_torch/chan) against the JAX
package's (ecc_ldpc_tpu/chan) on the same numpy inputs: constellation
tables and mappers exactly, the exact log-sum-exp demappers within
rtol/atol (transcendentals in another order of library calls, as for
spa), the draw-level channels against numpy formulas on the same draws,
the spec gates, the uncoded statistics against their closed forms, the
sharded sweep's per-frame draws, and bpsk's counters pinned to the values
the channel layer's parent gave.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.chan import awgn as jawgn
from ecc_ldpc_tpu.chan import modem as jm
from ecc_ldpc_tpu_torch.chan import awgn as pawgn
from ecc_ldpc_tpu_torch.chan import modem as pm
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.codes.spec import CodeSpec
from ecc_ldpc_tpu_torch.dist.mesh import Mesh
from ecc_ldpc_tpu_torch.dist.montecarlo import (
    frame_bits,
    frame_normals,
    frame_uniforms,
    make_sharded_step,
    sharded_sweep_counters,
)
from ecc_ldpc_tpu_torch.sim.runner import Pipeline, SweepSpec, run_sweep
from ecc_ldpc_tpu_torch.sim.stopping import StoppingRule

CPU = torch.device("cpu")
# the demappers: f32 log-sum-exp over the same points in the same order;
# logaddexp and exp/log1p come from different libraries (XLA:CPU, ATen)
DEMAP_RTOL, DEMAP_ATOL = 1e-5, 1e-4
APSK32_GAMMAS = [pm.APSK32_GAMMA["34"], pm.APSK32_GAMMA["910"]]


def _bits(rng, shape):
    return rng.integers(0, 2, shape).astype(np.uint8)


@pytest.mark.parametrize("bd", [1, 2, 3, 4])
def test_pam_tables_identical(bd):
    for a, b in zip(pm.pam_tables(bd), jm.pam_tables(bd)):
        np.testing.assert_array_equal(a, b)
    assert pm.qam_unit_scale(1 << (2 * bd)) == jm.qam_unit_scale(1 << (2 * bd))


@pytest.mark.parametrize("b", [2, 3, 4])
def test_psk_tables_identical(b):
    for a, c in zip(pm.psk_tables(b), jm.psk_tables(b)):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("M,gamma", [(16, g) for g in pm.APSK16_GAMMA.values()]
                         + [(32, g) for g in APSK32_GAMMAS])
def test_apsk_tables_identical(M, gamma):
    """Ring radii within 1e-12; APSK16's standard labels and APSK32's
    seeded surrogate labels (_quasi_gray_labels) identical."""
    for (r, c, o), (jr, jc, jo) in zip(pm.apsk_rings(M, gamma),
                                       jm.apsk_rings(M, gamma)):
        assert abs(r - jr) < 1e-12 and c == jc and o == jo
    for a, b in zip(pm.apsk_tables(M, gamma), jm.apsk_tables(M, gamma)):
        np.testing.assert_array_equal(a, b)
    assert pm._APSK16_STD_LABELS == jm._APSK16_STD_LABELS


@pytest.mark.parametrize("kind,M", [("qam", 4), ("qam", 16), ("qam", 64),
                                    ("qam", 256), ("psk", 8), ("apsk", 16),
                                    ("apsk", 32)])
def test_modulated_symbols_equal(kind, M):
    b = int(math.log2(M))
    bits = _bits(np.random.default_rng(M), (3, 40 * b))
    if kind == "qam":
        got = pm.qam_modulate(torch.as_tensor(bits), M)
        want = jm.qam_modulate(jnp.asarray(bits), M)
    elif kind == "psk":
        got = pm.psk_modulate(torch.as_tensor(bits), M)
        want = jm.psk_modulate(jnp.asarray(bits), M)
    else:
        g = 2.7 if M == 16 else APSK32_GAMMAS[0]
        got = pm.apsk_modulate(torch.as_tensor(bits), M, g)
        want = jm.apsk_modulate(jnp.asarray(bits), M, g)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("b", [2, 3, 4, 5, 6, 8])
def test_interleaver_permutations_equal(b):
    x = np.arange(2 * 24 * b, dtype=np.float32).reshape(2, 24 * b)
    tx = pm.interleave_tx(torch.as_tensor(x), b)
    np.testing.assert_array_equal(tx.numpy(),
                                  np.asarray(jm.interleave_tx(jnp.asarray(x), b)))
    back = pm.deinterleave_llr(tx, b)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jm.deinterleave_llr(jnp.asarray(tx.numpy()),
                                                     b)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("bd,sigma", [(1, 0.7), (2, 0.3), (3, 0.2), (4, 0.05)])
def test_pam_bit_llrs_match(bd, sigma):
    rng = np.random.default_rng(bd)
    y = rng.normal(0.0, 1.0, (4, 50)).astype(np.float32)
    s = np.float32(sigma)
    scale = pm.qam_unit_scale(1 << (2 * bd))
    got = pm.pam_bit_llrs(torch.as_tensor(y), bd, scale, torch.tensor(s))
    want = jm.pam_bit_llrs(jnp.asarray(y), bd, scale, jnp.float32(s))
    assert got.shape == (4, 50, bd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DEMAP_RTOL, atol=DEMAP_ATOL)


@pytest.mark.parametrize("which", ["psk8", "apsk16", "apsk32"])
def test_joint_demappers_match(which):
    rng = np.random.default_rng(len(which))
    yi, yq = (rng.normal(0.0, 1.0, (4, 60)).astype(np.float32)
              for _ in range(2))
    s = np.float32(0.25)
    if which == "psk8":
        got = pm.psk_bit_llrs(torch.as_tensor(yi), torch.as_tensor(yq), 3,
                              torch.tensor(s))
        want = jm.psk_bit_llrs(jnp.asarray(yi), jnp.asarray(yq), 3,
                               jnp.float32(s))
    else:
        M = int(which[4:])
        tab = pm.apsk_tables(M, 2.7 if M == 16 else APSK32_GAMMAS[0])
        got = pm.const_bit_llrs(torch.as_tensor(yi), torch.as_tensor(yq),
                                tab[0], tab[1], tab[2], torch.tensor(s))
        want = jm.const_bit_llrs(jnp.asarray(yi), jnp.asarray(yq), tab[0],
                                 tab[1], tab[2], jnp.float32(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DEMAP_RTOL, atol=DEMAP_ATOL)


@pytest.mark.parametrize("spec", ["qpsk", "qam16", "qam64:il", "qam256",
                                  "8psk:il", "apsk16:r56:il", "apsk32:r34"])
def test_symbol_channel_on_given_draws(spec):
    """A built symbol channel on given normals (I then Q a symbol, in
    transmitted order) equals the JAX package's modulator and demapper on
    y = x + sigma * n formed from the same numbers."""
    n, ebn0 = 240, 3.0
    kw = pm.parse_channel_spec(spec)
    M, b = kw["M"], int(math.log2(kw["M"]))
    code = CodeSpec(name="toy", n=n, m=0, row_cols=(), k=n // 2)
    rate = code.rate
    ch = pm.build_channel(code, spec)
    assert (ch.draws, ch.count) == ("normals", 2 * n // b)
    rng = np.random.default_rng(b)
    cw = _bits(rng, (3, n))
    z = rng.normal(0.0, 1.0, (3, ch.count)).astype(np.float32)
    got = ch(None, torch.as_tensor(cw), ebn0, torch.as_tensor(z)).numpy()
    tx = np.asarray(jm.interleave_tx(jnp.asarray(cw), b)) if kw.get("il") \
        else cw
    sigma = jax.lax.rsqrt(2.0 * b * rate * 10.0 ** (jnp.float32(ebn0) / 10.0))
    if kw["kind"] == "qam":
        xi, xq = jm.qam_modulate(jnp.asarray(tx), M)
    elif kw["kind"] == "psk":
        xi, xq = jm.psk_modulate(jnp.asarray(tx), M)
    else:
        xi, xq = jm.apsk_modulate(jnp.asarray(tx), M, kw["gamma"])
    yi = xi + sigma * jnp.asarray(z[:, 0::2])
    yq = xq + sigma * jnp.asarray(z[:, 1::2])
    if kw["kind"] == "qam":
        d = jm.qam_unit_scale(M)
        want = jnp.concatenate([jm.pam_bit_llrs(yi, b // 2, d, sigma),
                                jm.pam_bit_llrs(yq, b // 2, d, sigma)], -1)
    elif kw["kind"] == "psk":
        want = jm.psk_bit_llrs(yi, yq, b, sigma)
    else:
        t = jm.apsk_tables(M, kw["gamma"])
        want = jm.const_bit_llrs(yi, yq, t[0], t[1], t[2], sigma)
    want = want.reshape(3, n)
    if kw.get("il"):
        want = jm.deinterleave_llr(want, b)
    np.testing.assert_allclose(got, np.asarray(want), rtol=DEMAP_RTOL,
                               atol=DEMAP_ATOL)


def _nr_toy():
    return get_code("nr5g/bg2/52")


@pytest.mark.parametrize("spec", ["bsc:0.05", "bec:0.3", "rayleigh", "hard"])
def test_bit_channels_on_given_draws(spec):
    """bsc, bec, rayleigh and hard on given draws against a numpy formula,
    with the code's punctured and shortened masks (nr5g/bg2/52 punctures
    its first 2Z columns)."""
    code = _nr_toy()
    n, rate, ebn0 = code.n, code.rate, 2.0
    ch = pm.build_channel(code, spec)
    rng = np.random.default_rng(3)
    cw = _bits(rng, (4, n))
    if ch.draws == "uniforms":
        z = rng.uniform(0.0, 1.0, (4, ch.count)).astype(np.float32)
    else:
        z = rng.normal(0.0, 1.0, (4, ch.count)).astype(np.float32)
    got = ch(None, torch.as_tensor(cw), ebn0, torch.as_tensor(z)).numpy()
    keep, add = pawgn.channel_masks(code)
    sign = (1.0 - 2.0 * cw).astype(np.float32)
    sigma = np.float32(1.0 / math.sqrt(2.0 * rate * 10.0 ** (ebn0 / 10.0)))
    kw = pm.parse_channel_spec(spec)
    if kw["kind"] == "bsc":
        p = np.float32(kw["p"])
        flip = z < p
        mag = np.log1p(-p) - np.log(p)
        want = np.where(flip, -sign, sign) * mag
    elif kw["kind"] == "bec":
        want = np.where(z < kw["eps"], 0.0, sign * 60.0)
    elif kw["kind"] == "rayleigh":
        assert ch.count == 3 * n
        z3 = z.reshape(4, n, 3)
        h = np.sqrt((z3[..., 0] ** 2 + z3[..., 1] ** 2) * 0.5)
        y = h * sign + sigma * z3[..., 2]
        want = h * (2.0 * y / (sigma * sigma))
    else:
        y = sign + sigma * z
        p = float(jawgn.q_function(math.sqrt(2.0 * rate * 10 ** (ebn0 / 10))))
        mag = np.log1p(-np.float32(p)) - np.log(np.float32(p))
        want = np.sign(y) * mag
    want = want * keep + add
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-5,
                               atol=2e-5)


def test_build_channel_gates_match_jax():
    """Every gate raises as the JAX package's does: a symbol channel on a
    punctured code, an n that the bits a symbol do not divide; an unknown
    spec; and every bit channel builds on a masked code."""
    from ecc_ldpc_tpu.codes.registry import get_code as jget

    nr, jnr = _nr_toy(), jget("nr5g/bg2/52")
    for spec in ("qpsk", "8psk", "apsk16", "qam16:il"):
        for build, code in ((pm.build_channel, nr), (jm.build_channel, jnr)):
            with pytest.raises(NotImplementedError, match="punctured"):
                build(code, spec)
    odd = CodeSpec(name="odd", n=1001, m=0, row_cols=(), k=1001)
    for spec in ("qpsk", "8psk", "apsk32"):
        with pytest.raises(ValueError, match="divisible"):
            pm.build_channel(odd, spec)
    for spec in ("bpsk", "hard", "bsc:0.1", "bec:0.2", "rayleigh"):
        ch = pm.build_channel(nr, spec)
        assert ch.count == {"rayleigh": 3}.get(spec, 1) * nr.n
    for bad in ("qam8", "bsc:0.7", "bec:1.5", "apsk32:g2.8", "apsk16:r99"):
        with pytest.raises(ValueError):
            pm.parse_channel_spec(bad)
        with pytest.raises(ValueError):
            jm.parse_channel_spec(bad)


def test_anchors_match_jax():
    for e in (0.0, 4.0, 8.0):
        assert math.isclose(float(pawgn.uncoded_bpsk_ber(e)),
                            float(jawgn.uncoded_bpsk_ber(e)), rel_tol=1e-5)
        assert math.isclose(float(pm.uncoded_8psk_ber_approx(e)),
                            float(jm.uncoded_8psk_ber_approx(e)),
                            rel_tol=1e-5)
        assert math.isclose(float(pm.uncoded_rayleigh_ber(e)),
                            float(jm.uncoded_rayleigh_ber(e)), rel_tol=1e-5)
    assert math.isclose(float(pawgn.q_function(1.5)),
                        float(jawgn.q_function(1.5)), rel_tol=1e-6)


def _ber(spec, n, batch, ebn0, seed):
    code = CodeSpec(name="uncoded", n=n, m=0, row_cols=(), k=n)
    gen = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (batch, n), generator=gen, dtype=torch.uint8)
    llr = pm.build_channel(code, spec)(gen, bits, ebn0)
    return ((llr < 0).to(torch.uint8) != bits).double().mean().item()


def test_qpsk_equals_bpsk_ber():
    ber = _ber("qpsk", 2048, 512, 4.0, 4)
    theory = float(pawgn.uncoded_bpsk_ber(4.0))
    assert abs(ber - theory) < 0.15 * theory


@pytest.mark.parametrize("M,ebn0", [(16, 8.0), (64, 12.0)])
def test_qam_uncoded_ber_anchor(M, ebn0):
    b = int(math.log2(M))
    ber = _ber(f"qam{M}", 512 * b, 256, ebn0, 5)
    g = 10.0 ** (ebn0 / 10.0)
    theory = (4.0 / b) * (1 - 1 / math.sqrt(M)) * float(
        pawgn.q_function(math.sqrt(3.0 * b * g / (M - 1))))
    assert 0.8 * theory < ber < 1.2 * theory


def test_8psk_uncoded_ber_anchor():
    ber = _ber("8psk", 3 * 512, 256, 8.0, 6)
    theory = float(pm.uncoded_8psk_ber_approx(8.0))
    assert 0.8 * theory < ber < 1.25 * theory


@pytest.mark.parametrize("ebn0", [5.0, 10.0])
def test_rayleigh_uncoded_anchor(ebn0):
    code = CodeSpec(name="uncoded", n=2048, m=0, row_cols=(), k=2048)
    gen = torch.Generator().manual_seed(11)
    llr = pm.build_channel(code, "rayleigh")(
        gen, torch.zeros((512, 2048), dtype=torch.uint8), ebn0)
    ber = (llr < 0).double().mean().item()
    theory = float(pm.uncoded_rayleigh_ber(ebn0))
    assert abs(ber - theory) < 0.05 * theory + 2e-4


def test_rayleigh_fade_energy_is_jax_complex_normal():
    """The fade sqrt((a^2 + b^2)/2) of unit normals has E[h^2] = 1, as
    |jax.random.normal(.., complex64)| has."""
    z = torch.randn((2, 400_000), generator=torch.Generator().manual_seed(1))
    h2 = ((z[0] ** 2 + z[1] ** 2) * 0.5).double().mean().item()
    jh = jnp.abs(jax.random.normal(jax.random.key(2), (400_000,),
                                   jnp.complex64))
    jh2 = float(jnp.mean(jh.astype(jnp.float32) ** 2))
    assert abs(h2 - 1.0) < 0.01 and abs(jh2 - 1.0) < 0.01


def test_bsc_and_bec_rates():
    code = CodeSpec(name="uncoded", n=4096, m=0, row_cols=(), k=4096)
    gen = torch.Generator().manual_seed(9)
    zeros = torch.zeros((64, 4096), dtype=torch.uint8)
    llr = pm.build_channel(code, "bsc:0.05")(gen, zeros, 0.0)
    assert abs((llr < 0).double().mean().item() - 0.05) < 0.005
    llr = pm.build_channel(code, "bec:0.3")(gen, zeros, 0.0)
    assert abs((llr == 0).double().mean().item() - 0.3) < 0.01
    assert set(llr.unique().tolist()) <= {0.0, 60.0}


def _frames(a, b):
    return torch.arange(a, b, dtype=torch.int64)


@pytest.mark.parametrize("a,b", [(0, 5), (5, 13), (3, 11)])
def test_frame_uniforms_are_rows_of_the_whole(a, b):
    whole = frame_uniforms(7, 1, 2, _frames(0, 13), 1003)
    assert whole.shape == (13, 1003) and whole.dtype == torch.float32
    assert float(whole.min()) > 0.0 and float(whole.max()) <= 1.0
    assert torch.equal(frame_uniforms(7, 1, 2, _frames(a, b), 1003),
                       whole[a:b])
    # the channel stream's words: the uniforms under frame_normals' Box-Muller
    u = frame_uniforms(7, 1, 2, _frames(0, 2), 8)
    z = frame_normals(7, 1, 2, _frames(0, 2), 8)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
    assert torch.equal(z[:, 0::2], r * torch.cos(2.0 * math.pi * u[:, 1::2]))


def test_frame_draws_pinned():
    """frame_normals and frame_bits for one seed give the values the
    sharded sweep drew before the channel layer."""
    f = torch.arange(3)
    want = [[1.193986177444458, -0.40517881512641907, 0.7435935139656067,
             -1.08175528049469, -1.3335702419281006, -0.7598601579666138],
            [1.3612555265426636, 0.3749231696128845, -0.8950085043907166,
             1.214838981628418, 0.15578287839889526, 2.088465690612793],
            [-0.2891746759414673, 0.6663751006126404, 0.550650954246521,
             1.6838289499282837, 0.057138632982969284, -1.3058676719665527]]
    assert frame_normals(3, 1, 2, f, 6).tolist() == want
    bits = frame_bits(3, 1, 2, f, 40)
    assert bits.sum(1).tolist() == [21, 24, 13]
    assert bits[0, :16].tolist() == [0, 0, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1, 1,
                                     0, 0, 1]


_BPSK = SweepSpec(code="mackay1008", decoder="minsum/norm:0.8125/10",
                  ebn0_db=(1.5, 2.0), batch=16,
                  stopping=StoppingRule(min_frame_errors=10**9, max_frames=32))


def test_bpsk_counters_pinned():
    """bpsk's counters in run_sweep and in the sharded step are the ones
    the sweeps gave before the channel layer (the same draws, in the same
    order)."""
    got = [(p.bit_errors, p.frame_errors, p.iters_sum, p.bit_errors_sq)
           for p in run_sweep(_BPSK, device="cpu")]
    assert got == [(570, 23, 313, 18312.0), (155, 14, 285, 4347.0)]
    pipe = Pipeline.build(_BPSK, CPU)
    c, frames = sharded_sweep_counters(pipe, Mesh(batch=1, snr=1, device=CPU),
                                       16, (1.5, 2.0), seed=0, steps=2)
    assert frames == 32
    assert c.tolist() == [[612, 26, 313, 19328], [167, 15, 282, 3155]]


@pytest.mark.parametrize("channel,code,ebn0", [
    ("apsk16:r56:il", "bpsk/1000", (6.0, 7.0)),
    ("bec:0.45", "mackay1008", (0.0, 1.0)),
    ("rayleigh", "mackay1008", (2.0, 3.0))])
def test_sharded_modem_counters_mesh_invariant(channel, code, ebn0):
    """A modem or bit channel's per-frame draws make the sharded counters
    the same on a 2x1 mesh (the two ranks' local parts summed) as on 1x1."""
    spec = SweepSpec(code=code, decoder="minsum/norm:0.8125/10",
                     ebn0_db=ebn0, batch=8, channel=channel)
    pipe = Pipeline.build(spec, CPU)
    whole = make_sharded_step(pipe, Mesh(batch=1, snr=1, device=CPU), 8)
    parts = [make_sharded_step(pipe, Mesh(batch=2, snr=1, rank=r,
                                          device=CPU), 4).local
             for r in range(2)]
    errors = 0
    for step in range(2):
        want = whole(3, spec.ebn0_db, step)
        got = sum(p(3, spec.ebn0_db, step) for p in parts)
        assert torch.equal(got, want)
        errors += int(want[:, 1].sum())
    assert errors > 0  # the draws reached the decoder
