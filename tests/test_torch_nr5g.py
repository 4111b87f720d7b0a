"""The port's 5G NR code (codes/nr5g.py) against the JAX package's: the
base graphs and their reduction at Zc, the circular buffer's start rv_k0
and each redundancy version's punctured set, graph truncation, HARQ
combining, the channel's masks (LLR 0 on punctured columns, 60 on filler
columns) given the same unit normals, and the plain layered decode of a
small-Zc code with filler, punctured columns and a truncated graph
against the JAX XLA layered decoder.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.chan.awgn import make_channel as jax_make_channel
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu_torch.chan.awgn import channel_masks, make_channel
from ecc_ldpc_tpu_torch.codes import get_code, nr5g
from ecc_ldpc_tpu_torch.encode.structured import (
    NRCoreExtensionEncoder,
    build_encoder,
)
from test_torch_families import assert_layered_matches_jax, decode_case

torch.set_num_threads(1)
# the module (ecc_ldpc_tpu.codes exports the function of the same name)
jax_nr5g = importlib.import_module("ecc_ldpc_tpu.codes.nr5g")

RV_CODES = [f"nr5g/bg2/52/500/1200/rv{rv}" for rv in range(4)] + [
    f"nr5g/bg1/64/1200/2000/rv{rv}" for rv in range(4)]


def test_base_graphs_and_reduction_match():
    for bg in ("bg1", "bg2"):
        assert np.array_equal(nr5g.bg_table(bg), jax_nr5g.bg_table(bg))
        for Zc in (52, 208):
            assert np.array_equal(nr5g.reduced_bg_table(bg, Zc),
                                  jax_nr5g.reduced_bg_table(bg, Zc))
    assert nr5g.LIFTING_SIZES == jax_nr5g.LIFTING_SIZES


def test_rv_k0_matches():
    for bg in ("bg1", "bg2"):
        for Zc in (2, 52, 384):
            for rv in range(4):
                assert nr5g.rv_k0(bg, Zc, rv) == jax_nr5g.rv_k0(bg, Zc, rv)
    with pytest.raises(ValueError, match="rv must be 0..3"):
        nr5g.rv_k0("bg1", 384, 4)


@pytest.mark.parametrize("code", RV_CODES)
def test_circular_buffer_punctured_sets_match(code):
    """Each rv's window: the full-length graph, its punctured set (the
    leading 2*Zc and every buffer position outside the window, which
    wraps), filler skipped; the rate counts transmitted bits only."""
    spec, jspec = get_code(code), jax_get_code(code)
    assert (spec.name, spec.n, spec.k, spec.m) == (jspec.name, jspec.n,
                                                   jspec.k, jspec.m)
    assert spec.punctured_cols == jspec.punctured_cols
    assert spec.shortened_cols == jspec.shortened_cols
    assert np.array_equal(spec.qc.base, jspec.qc.base)
    n_tx = int(code.split("/")[4])
    sent = spec.n - len(spec.punctured_cols) - len(spec.shortened_cols)
    assert sent == n_tx and spec.rate == spec.k / n_tx
    Zc = spec.qc.Z
    assert set(range(2 * Zc)) <= set(spec.punctured_cols)
    assert not set(spec.punctured_cols) & set(spec.shortened_cols)


def test_graph_truncation_matches():
    """n_tx without rv: extension rows whose parity block-column is all
    punctured are dropped, with their columns."""
    for code in ("nr5g/bg1/384/8448/12672", "nr5g/bg2/52/500/1200",
                 "nr5g/bg1/48/1000/1300"):
        spec, jspec = get_code(code), jax_get_code(code)
        assert spec.qc.base.shape == jspec.qc.base.shape
        assert np.array_equal(spec.qc.base, jspec.qc.base)
        assert (spec.n, spec.punctured_cols, spec.name) == (
            jspec.n, jspec.punctured_cols, jspec.name)
    assert get_code("nr5g/bg1/384/8448/12672").qc.base.shape == (13, 35)
    with pytest.raises(ValueError, match="rv needs n_tx"):
        nr5g.nr5g("bg1", 384, 8448, None, 1)


def test_harq_combine_matches():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((3, 40)).astype(np.float32) for _ in range(4)]
    want = np.asarray(jax_nr5g.harq_combine(*[jnp.asarray(x) for x in xs]))
    got = nr5g.harq_combine(*[torch.from_numpy(x) for x in xs]).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("code", ["nr5g/bg1/208/3168",
                                  "nr5g/bg2/52/500/1200/rv2"])
def test_channel_masks_match(code):
    """Given JAX's unit normals, the port's channel gives JAX's LLRs: 0 on
    the punctured columns, 60 on the filler columns exactly, the rest
    within 1e-6 relative (the f32 arithmetic's order)."""
    spec, jspec = get_code(code), jax_get_code(code)
    enc = build_encoder(spec)
    assert isinstance(enc, NRCoreExtensionEncoder)
    msg = np.random.default_rng(1).integers(0, 2, (2, spec.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_make_channel(jspec)(key, jnp.asarray(cw.numpy()),
                                              1.5))
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, tuple(cw.shape), jnp.float32)))
    got = make_channel(spec)(None, cw, 1.5, noise).numpy()
    keep, add = channel_masks(spec)
    punct, short = list(spec.punctured_cols), list(spec.shortened_cols)
    assert not keep[punct].any() and (add[short] == 60).all()
    assert np.array_equal(got[:, punct], want[:, punct])
    assert (got[:, punct] == 0).all() and not np.signbit(got[:, punct]).any()
    assert (got[:, short] == 60).all() and (want[:, short] == 60).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def filler_case():
    # k = 1000 of kb*Zc = 1056 (56 filler), 2*Zc + the tail punctured,
    # the graph truncated to 9 layers
    return decode_case("nr5g/bg1/48/1000/1300", 2.5)


@pytest.mark.parametrize("cn", ["minsum", "spa"])
def test_plain_layered_matches_jax(filler_case, cn):
    g, jg, llr = filler_case
    spec = get_code("nr5g/bg1/48/1000/1300")
    assert g.mb == 9 and spec.shortened_cols and spec.punctured_cols
    got = assert_layered_matches_jax(g, jg, llr, cn)
    assert bool(got.ok.any()) and not bool(got.ok.all())
