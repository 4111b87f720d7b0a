"""The accumulate ("classic") form of the port's layered decoders on QC
graphs that repeat a block-column in a layer, against the JAX package's
XLA layered oracle (make_decoder(g, "layered", backend="xla"), which
counts signs on such graphs) on the same graphs, built in both packages by
qc_graph_from_block_edges, and the same LLR arrays from a numpy seed:

- a xor graph (Z = 8, block-column 0 twice in layer 0; every rule) and
  a seeded Z = 16 xor multi-edge graph (bench/multi_edge.py; min-sum),
  which the JAX package's QCXorCode cannot build but
  graph/qc.qc_graph_from_block_edges can;
- a circulant multi-edge graph of row degree 40 (the card's 64-wide
  classic build; min-sum, track mode).

Tolerances, as tests/test_torch_layered_classic.py states them: min-sum
bits, ok and iterations identical; spa and minstar decisions identical
and the posteriors after one sweep within atol 1e-3 / rtol 1e-4 (XLA:CPU
and PyTorch transcendentals differ by ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.decode.api import make_decoder as jax_make_decoder
from ecc_ldpc_tpu.decode.xla import layered as jax_layered
from ecc_ldpc_tpu.graph.qc import (
    qc_graph_from_block_edges as jax_qc_graph_from_block_edges,
)
from ecc_ldpc_tpu_torch.bench.multi_edge import multi_edge_graph
from ecc_ldpc_tpu_torch.decode import layered_qc as lq
from ecc_ldpc_tpu_torch.graph.qc import qc_graph_from_block_edges

torch.set_num_threads(1)

T = 8
ATOL, RTOL = 1e-3, 1e-4
KW = {"minsum": dict(alpha=0.8125), "spa": {}, "minstar": {}}


def _awgn_llr(n, B, ebn0_db, rate, rng):
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _twin(g):
    """The JAX package's QCGraph of the port graph g (same triples)."""
    return jax_qc_graph_from_block_edges(
        g.Z, g.mb, g.nb, np.asarray(g.be_row), np.asarray(g.be_col),
        np.asarray(g.be_shift), k=g.k, name=g.name, perm=g.perm)


def _graphs():
    tiny = qc_graph_from_block_edges(8, 2, 3, [0, 0, 1, 1], [0, 0, 1, 2],
                                     [1, 2, 0, 3], k=8, perm="xor")
    return {"xor_z8": tiny,
            "xor_z16": multi_edge_graph(16, 4, 12, 6, "xor", seed=2),
            "roll_d40": multi_edge_graph(4, 2, 48, 40, "roll", seed=3)}


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, g in _graphs().items():
        assert not g.intra_layer_dup_free
        rate = max(g.k, 1) / g.n
        llr = _awgn_llr(g.n, 16, 2.0 if g.dcb_max < 40 else 4.0,
                        max(rate, 0.5), np.random.default_rng(len(name)))
        llr[0] = 4.0  # noiseless: done before the first sweep
        out[name] = (g, _twin(g), llr)
    return out


def _posteriors(jg, llr, kw, monkeypatch):
    """The JAX oracle's posteriors [B, n] after one fixed sweep."""
    seen = {}
    orig = jax.lax.fori_loop

    def rec(*a, **k):
        out = orig(*a, **k)
        seen["total"] = out[0]
        return out

    monkeypatch.setattr(jax.lax, "fori_loop", rec)
    jax_layered.decode_layered(jg, jnp.asarray(llr), max_iters=1,
                               early_term=False, **kw)
    return np.asarray(seen["total"]).reshape(jg.nb * jg.Z, -1).T


MINSUM_CASES = [("xor_z8", False), ("xor_z8", True), ("xor_z16", False),
                ("xor_z16", True), ("roll_d40", True)]


@pytest.mark.parametrize("name,track", MINSUM_CASES,
                         ids=[f"{'track' if t else 'fixed'}-{n}"
                              for n, t in MINSUM_CASES])
def test_minsum_matches_xla_oracle(graphs, name, track):
    g, jg, llr = graphs[name]
    want = jax_make_decoder(jg, "layered", alpha=0.8125, max_iters=T,
                            early_term=track, backend="xla")(
        jnp.asarray(llr))
    got = lq.make_layered_decoder(g, alpha=0.8125, max_iters=T,
                                  early_term=track, device="cpu")(
        torch.from_numpy(llr))
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())
    assert bool(got.ok[0]) and int(got.iterations[0]) == (0 if track else T)


@pytest.mark.parametrize("cn", ["spa", "minstar"])
def test_exact_rules_match_xla_oracle(graphs, cn, monkeypatch):
    g, jg, llr = graphs["xor_z8"]
    want = jax_make_decoder(jg, "layered", cn=cn, max_iters=T,
                            backend="xla")(jnp.asarray(llr))
    got = lq.layered_decode_plain(g, torch.from_numpy(llr), cn=cn,
                                  max_iters=T)
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())
    ref = _posteriors(jg, llr, dict(cn=cn), monkeypatch)
    _, post = lq.plain_with_posteriors(g, torch.from_numpy(llr), cn=cn,
                                       max_iters=1, early_term=False)
    np.testing.assert_allclose(post.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_classic_tables_above_32_slots(graphs):
    """Degree 40: the kernel's table carries two mask words a layer, the
    low word first, each layer's barriers classic_barriers' bits; the
    classic plan takes 512 threads and its tables' bytes count them."""
    g, _, _ = graphs["roll_d40"]
    assert g.dcb_max == 40 and lq.mask_words(g.dcb_max) == 2
    tab = lq._classic_table(g, "cpu", "minsum").numpy().view(np.uint32)
    masks = tab[g.mb + 1 + 2 * g.num_block_edges:]
    want = lq.classic_barriers(g, "minsum")
    assert len(masks) == 2 * g.mb
    assert [int(lo) | int(hi) << 32 for lo, hi in masks.reshape(-1, 2)] == want
    plan = lq.tile_plan(g, 601, form="classic")
    assert plan.threads <= 512
    assert lq._state_tables(g, "classic") == (
        12 * g.num_block_edges + 4 * (g.mb + 1) + 8 * g.mb)
