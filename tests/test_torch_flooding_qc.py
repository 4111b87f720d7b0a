"""The port's flooding decoder on QC graphs (decode/flooding_qc.py) against
the JAX package: decode/xla/flooding_qc.py::decode_flooding_qc on the z16
surrogate and on wimax/576/12, and the Pallas kernel
(decode/pallas/flooding_qc.py, K3) in interpret mode at f32.

Same graph (carried across with convert.graph_from_numpy), same LLR array
from a numpy seed. Tolerances, as in tests/test_torch_flooding.py:
- minsum bit-identical (bits, ok, iterations, and posteriors after 3
  sweeps);
- spa and minstar: decisions equal, posteriors after one iteration within
  atol 1e-3 / rtol 1e-4 (XLA:CPU and PyTorch transcendentals differ by
  ulps).
Track mode holds frames that pass on their PRE-sweep state: one noiseless
frame (done before any sweep) and frames that converge mid-decode, whose
reported state is the verified one (fault class 2 of ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.decode.pallas.flooding_qc import make_flooding_pallas_decoder
from ecc_ldpc_tpu.decode.xla import flooding_qc as jax_fqc
from ecc_ldpc_tpu.encode.structured import build_encoder as jax_build_encoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.decode.flooding_qc import (
    _flooding_table,
    flooding_qc_decode_cuda,
    flooding_qc_decode_plain,
    flooding_qc_with_posteriors_plain,
    make_flooding_qc_decoder,
)

torch.set_num_threads(1)

T = 8
ATOL, RTOL = 1e-3, 1e-4
KW = {"minsum": dict(alpha=0.8125, beta=0.0), "spa": {}, "minstar": {}}
KINDS = ["minsum", "spa", "minstar"]


def _llr(cw, rate, ebn0_db, rng):
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX QCGraph, port QCGraph, llr f32 [B, n])}: the z16
    surrogate (B=24, 2.6 dB) and wimax/576/12 (B=16, 2.2 dB), each with a
    noiseless frame 0."""
    out = {}
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    cases = [
        ("z16", jax_expand_qc(JaxQCCode(Z=16, base=base), name="test.z16",
                              k=8 * 16), 24, 2.6),
        ("wimax576", jax_get_code("wimax/576/12"), 16, 2.2),
    ]
    for i, (name, spec, B, ebn0) in enumerate(cases):
        jg = jax_compile_qc_graph(spec)
        rng = np.random.default_rng(21 + i)
        msg = rng.integers(0, 2, (B, spec.k), dtype=np.uint8)
        cw = jax_build_encoder(spec).encode_numpy(msg)
        llr = _llr(cw, spec.rate, ebn0, rng)
        llr[0] = 4.0 * (1.0 - 2.0 * cw[0])
        g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                             jg.be_col_np, jg.be_shift_np, jg.name)
        out[name] = (jg, g, llr)
    return out


def _jax_posteriors(jg, llr, kind, T, monkeypatch):
    """Posteriors after T fixed sweeps of decode_flooding_qc, rebuilt from
    the last sweep's check messages by the oracle's own accumulation (run
    eagerly, recording each call of the row rule)."""
    calls = []
    op = jax_fqc._CN_QC[kind]

    def recording(V, alpha, beta):
        C = op(V, alpha, beta)
        calls.append(C)
        return C

    monkeypatch.setitem(jax_fqc._CN_QC, kind, recording)
    rows = [jg.layer_edges(i) for i in jg.layer_order]
    B = llr.shape[0]
    with jax.disable_jit():
        jax_fqc.decode_flooding_qc(jg, jnp.asarray(llr), kind=kind,
                                   max_iters=T, early_term=False, **KW[kind])
        acc = jnp.asarray(llr).T.reshape(jg.nb, jg.Z, B)
        for edges, C in zip(rows, calls[-len(rows):]):
            for j, (e, col, s) in enumerate(edges):
                acc = acc.at[col].add(jg.to_var(C[j], s))
    return np.asarray(acc.reshape(jg.nb * jg.Z, B)).T


@pytest.mark.parametrize("name", ["z16", "wimax576"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["fixed", "track"])
def test_flooding_qc_plain_matches_jax(graphs, name, kind, mode,
                                       monkeypatch):
    jg, g, llr = graphs[name]
    et = mode == "track"
    want = jax.jit(lambda x: jax_fqc.decode_flooding_qc(
        jg, x, kind=kind, max_iters=T, early_term=et, **KW[kind]))(
            jnp.asarray(llr))
    got, post = flooding_qc_with_posteriors_plain(
        g, torch.from_numpy(llr), kind=kind, max_iters=T, early_term=et,
        **KW[kind])
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations),
                          got.iterations.numpy())
    ok = got.ok.numpy()
    assert 0 < ok.sum() < len(ok)  # some frames decode, some do not
    if et:
        # frame 0 passed before any sweep; others passed mid-decode and
        # report the state that passed
        assert got.iterations[0] == 0
        assert ((got.iterations.numpy() < T) & ok)[1:].any()
    else:
        # posteriors after a few sweeps (the eager rebuild is slow):
        # minsum bit-identical, the exact rules within the tolerance
        n_post = 3 if kind == "minsum" else 1
        _, post = flooding_qc_with_posteriors_plain(
            g, torch.from_numpy(llr), kind=kind, max_iters=n_post,
            early_term=False, **KW[kind])
        ref = _jax_posteriors(jg, llr, kind, n_post, monkeypatch)
        if kind == "minsum":
            assert np.array_equal(post.numpy().view(np.int32),
                                  ref.view(np.int32))
        else:
            np.testing.assert_allclose(post.numpy(), ref, atol=ATOL,
                                       rtol=RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_flooding_qc_plain_matches_pallas_interpret(graphs, kind):
    """K3 in interpret mode at f32 on wimax/576/12 (Z=24): identical
    decisions (the kernel's spa takes the log1p difference where the
    oracle takes 2*atanh, so only decisions are compared for all kinds)."""
    jg, g, llr = graphs["wimax576"]
    want = make_flooding_pallas_decoder(
        jg, kind=kind, max_iters=T, early_term=True, interpret=True,
        batch_tile=16, **KW[kind])(jnp.asarray(llr))
    got = flooding_qc_decode_plain(g, torch.from_numpy(llr), kind=kind,
                                   max_iters=T, **KW[kind])
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations),
                          got.iterations.numpy())


def test_kernel_table_follows_the_sweep_order(graphs):
    """Each block-column lists its edges as (sweep slot, shift) in the
    order the oracle adds them: rows in layer_order, edges in id order."""
    jg, g, _ = graphs["wimax576"]
    tab = _flooding_table(g, "cpu").numpy()
    mb, nb, BE = g.mb, g.nb, g.num_block_edges
    rptr, scol, sshift = tab[:mb + 1], tab[mb + 1:mb + 1 + BE], \
        tab[mb + 1 + BE:mb + 1 + 2 * BE]
    cptr = tab[mb + 1 + 2 * BE:mb + nb + 2 + 2 * BE]
    cslot = tab[mb + nb + 2 + 2 * BE:mb + nb + 2 + 3 * BE]
    cshift = tab[mb + nb + 2 + 3 * BE:]
    assert len(cshift) == BE and rptr[-1] == BE and cptr[-1] == BE
    order = [(c, s) for i in g.layer_order for _, c, s in g.layer_edges(i)]
    assert list(zip(scol, sshift)) == order
    for c in range(nb):
        slots = cslot[cptr[c]:cptr[c + 1]]
        assert list(slots) == sorted(slots)
        assert all(scol[p] == c and sshift[p] == s
                   for p, s in zip(slots, cshift[cptr[c]:cptr[c + 1]]))


def test_flooding_qc_decoder_routes_and_rejects(graphs):
    _, g, llr = graphs["z16"]
    x = torch.from_numpy(llr)
    dec = make_flooding_qc_decoder(g, kind="minstar", max_iters=3,
                                   device="cpu")
    assert torch.equal(dec(x).bits, flooding_qc_decode_plain(
        g, x, kind="minstar", max_iters=3).bits)
    with pytest.raises(ValueError, match="scalar"):
        make_flooding_qc_decoder(g, beta=np.zeros(3), device="cpu")
    before = (flooding_qc_decode_cuda.launches, flooding_qc_decode_cuda.frames)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flooding_qc_decode_cuda(g, x, kind="spa", max_iters=2)
    assert (flooding_qc_decode_cuda.launches,
            flooding_qc_decode_cuda.frames) == before
