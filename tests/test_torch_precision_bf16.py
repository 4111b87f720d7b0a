"""Message precision in the port's layered decoders, second half: the
TPU kernel's bf16 message and LLR storage against the JAX package's
Pallas kernel in interpret mode (decode/pallas/layered_qc.py::
make_layered_pallas_decoder with msg_dtype = llr_dtype = bf16), and the
exact rules (spa, minstar) under the q: grid against
decode/xla/layered.py::decode_layered(quant=).

Graphs: the Z = 16 8x24 surrogate of tests/ber/test_bf16_parity.py
(dup-free) and the AR4JA protograph at M = 32, rate 2/3 (a block-column
repeated in a layer); LLRs of the all-zero codeword from a numpy seed.

Tolerances. bf16 min-sum, dup-free (fixed mode adds the unrounded message
to the posteriors, track mode the rounded one) and accumulate form: bits,
ok and iterations identical. bf16 spa and minstar: bits, ok and
iterations identical, the contract of tests/test_torch_layered_exact.py
(XLA:CPU's and PyTorch's exp, log, tanh and log1p differ by ulps; that
file also bounds messages by atol 1e-3 / rtol 1e-4, which the Pallas
kernel does not expose). The exact rules under q: must give identical
bits and ok; their posteriors after one sweep lie within one quantizer
step of the oracle's (an ulp at a rounding boundary moves a message by one
step), and at least 99% of the entries are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import ccsds as jax_ccsds
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.decode.pallas.layered_qc import make_layered_pallas_decoder
from ecc_ldpc_tpu.decode.xla.layered import decode_layered
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes import ccsds
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    layered_decode_plain,
    plain_with_posteriors,
)
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

T = 8
B = 32


def _zero_cw_llr(n, rate, ebn0_db, rng, punctured=()):
    """LLRs of the all-zero codeword over BPSK + AWGN (f32 [B, n])."""
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = 1.0 + sigma * rng.standard_normal((B, n))
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    llr[:, list(punctured)] = 0.0
    return llr


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX QCGraph, port QCGraph, llr f32 [B, n])} at Eb/N0 points
    where T sweeps decode some frames, not all."""
    base = surrogate_base(mb=8, nb=24, Z=16, seed=44)
    jg = jax_compile_qc_graph(jax_expand_qc(JaxQCCode(Z=16, base=base),
                                            name="bf16.z16", k=16 * 16))
    g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name)
    out = {"roll": (jg, g, _zero_cw_llr(g.n, 2 / 3, 2.0,
                                        np.random.default_rng(21)))}
    spec = ccsds.ar4ja(rate="23", M=32)
    out["dup"] = (jax_compile_qc_graph(jax_ccsds.ar4ja(rate="23", M=32)),
                  compile_qc_graph(spec),
                  _zero_cw_llr(spec.n, spec.rate, 2.2,
                               np.random.default_rng(22),
                               spec.punctured_cols))
    return out


def _same_decisions(want, got):
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())


# (graph, rule, track mode)
BF16_CASES = [("roll", "minsum", False), ("roll", "minsum", True),
              ("dup", "minsum", False), ("dup", "minsum", True),
              ("roll", "spa", False), ("roll", "spa", True),
              ("roll", "minstar", True)]


@pytest.mark.parametrize("code,cn,track", BF16_CASES,
                         ids=[f"{c}_{r}_{'track' if t else 'fixed'}"
                              for c, r, t in BF16_CASES])
def test_bf16_matches_pallas_interpret(graphs, code, cn, track):
    """The plain version with bf16 storage against the Pallas kernel with
    msg_dtype = llr_dtype = bf16: bits, ok and iterations identical."""
    jg, g, llr = graphs[code]
    ab = dict(alpha=0.8125) if cn == "minsum" else {}
    want = make_layered_pallas_decoder(
        jg, max_iters=T, early_term=track, interpret=True, batch_tile=B,
        msg_dtype=jnp.bfloat16, llr_dtype=jnp.bfloat16, kind=cn,
        **ab)(jnp.asarray(llr))
    got = layered_decode_plain(g, torch.from_numpy(llr), max_iters=T,
                               early_term=track, cn=cn, precision=("bf16",),
                               **ab)
    _same_decisions(want, got)
    ok = got.ok.numpy()
    assert 0 < ok.sum() < len(ok)
    if cn == "minsum":
        # the rounding reaches the posteriors: bf16 is not f32 here
        _, p16 = plain_with_posteriors(g, torch.from_numpy(llr), max_iters=T,
                                       early_term=track, cn=cn,
                                       precision=("bf16",), **ab)
        _, p32 = plain_with_posteriors(g, torch.from_numpy(llr), max_iters=T,
                                       early_term=track, cn=cn, **ab)
        assert not torch.equal(p16, p32)


def test_bf16_fixed_and_track_add_different_messages(graphs):
    """One sweep in bf16: fixed mode adds the unrounded messages to the
    posteriors (the Pallas kernel's fixed path), track mode the rounded
    ones (its freeze path), so the frames live in both differ; frames
    that pass before the sweep keep their rounded LLRs."""
    _, g, llr = graphs["roll"]
    x = torch.from_numpy(llr)
    _, fixed = plain_with_posteriors(g, x, alpha=0.8125, max_iters=1,
                                     early_term=False, precision=("bf16",))
    res, track = plain_with_posteriors(g, x, alpha=0.8125, max_iters=1,
                                       early_term=True, precision=("bf16",))
    live = res.iterations == 1
    assert bool(live.any())
    assert not torch.equal(fixed[live], track[live])
    rounded = x.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(track[~live], rounded[~live])


def _jax_decode(jg, llr, monkeypatch, **kw):
    """(DecodeResult, posteriors f32 [B, n]) of decode_layered, the
    posteriors from the state its loop returns."""
    seen = {}
    for name in ("fori_loop", "while_loop"):
        orig = getattr(jax.lax, name)

        def rec(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            seen["total"] = out[0]
            return out

        monkeypatch.setattr(jax.lax, name, rec)
    res = decode_layered(jg, jnp.asarray(llr), **kw)
    total = np.asarray(seen["total"])
    return res, total.reshape(jg.nb * jg.Z, -1).T


@pytest.mark.parametrize("code,cn", [("roll", "spa"), ("roll", "minstar"),
                                     ("dup", "spa")])
def test_exact_rules_quant_match_jax(graphs, code, cn, monkeypatch):
    """spa/minstar under q:6:0.25, track mode: bits and ok identical; after
    one sweep every posterior within one step, >= 99% identical."""
    jg, g, llr = graphs[code]
    quant = (6, 0.25)
    want, _ = _jax_decode(jg, llr, monkeypatch, cn=cn, max_iters=T,
                          early_term=True, quant=quant)
    got, _ = plain_with_posteriors(g, torch.from_numpy(llr), cn=cn,
                                   max_iters=T, early_term=True,
                                   precision=("q", *quant))
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    _, wpost = _jax_decode(jg, llr, monkeypatch, cn=cn, max_iters=1,
                           early_term=False, quant=quant)
    _, post = plain_with_posteriors(g, torch.from_numpy(llr), cn=cn,
                                    max_iters=1, early_term=False,
                                    precision=("q", *quant))
    diff = np.abs(post.numpy() - wpost)
    assert diff.max() <= quant[1] * (1 + 1e-6)
    assert (diff == 0).mean() >= 0.99
