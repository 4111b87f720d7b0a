"""Message precision in the port's layered decoders against the JAX
package: the q:BITS:STEP fixed-point emulation of
decode/xla/layered.py::decode_layered(quant=), the quantizer and bf16
round trip themselves, the TPU kernel's storage rule (tpu_msg_dtype
against decode/pallas/layered_qc.supports), and the spec forms.

Graphs: the Z = 16 surrogate of tests/test_torch_layered_exact.py
(dup-free, circulant), the AR4JA protograph at M = 32, rate 2/3 of
tests/test_torch_layered_classic.py (a block-column repeated in a layer:
the accumulate form) and the toy Z = 16 XOR code of
tests/test_torch_layered_xor.py. LLRs of the all-zero codeword from a
numpy seed (the punctured block at LLR 0).

Tolerances. Min-sum under q: must give identical bits, ok, iterations and
posteriors. With an offset the oracle runs op by op (jax.disable_jit):
compiled, XLA:CPU fuses alpha*m - beta into one multiply-add
(tests/test_torch_layered_classic.py). The step 0.3, not a power of two,
checks that both sides divide: x / 0.3 and x * (1 / 0.3) differ in f32,
and the compiled oracle divides. The exact rules under q: and the bf16
storage against the Pallas kernel are tests/test_torch_precision_bf16.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import ccsds as jax_ccsds
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import QCXorCode as JaxQCXorCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.codes.qc import expand_qc_xor as jax_expand_qc_xor
from ecc_ldpc_tpu.decode.api import get_decoder as jax_get_decoder
from ecc_ldpc_tpu.decode.api import parse_decoder_spec as jax_parse
from ecc_ldpc_tpu.decode.pallas import layered_qc as jax_pallas
from ecc_ldpc_tpu.decode.xla.layered import decode_layered
from ecc_ldpc_tpu.decode.xla.layered import quantize as jax_quantize
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes import ccsds
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.decode.api import get_decoder, parse_decoder_spec
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    kernel_precision,
    layered_decode_cuda,
    make_layered_decoder,
    plain_with_posteriors,
    tpu_msg_dtype,
)
from ecc_ldpc_tpu_torch.decode.quant import quantize, round_bf16
from ecc_ldpc_tpu_torch.ecc import build_ecc
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
    """{name: (JAX QCGraph, port QCGraph, llr f32 [B, n])}, each at an
    Eb/N0 where T sweeps of q:6:0.25 min-sum decode some frames, not all."""
    out = {}
    base = surrogate_base(mb=8, nb=24, Z=16, seed=44)
    jg = jax_compile_qc_graph(jax_expand_qc(JaxQCCode(Z=16, base=base),
                                            name="q.z16", k=16 * 16))
    g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name)
    out["roll"] = (jg, g, _zero_cw_llr(g.n, 2 / 3, 2.0,
                                       np.random.default_rng(21)))
    spec = ccsds.ar4ja(rate="23", M=32)
    jg = jax_compile_qc_graph(jax_ccsds.ar4ja(rate="23", M=32))
    out["dup"] = (jg, compile_qc_graph(spec),
                  _zero_cw_llr(spec.n, spec.rate, 2.2,
                               np.random.default_rng(22),
                               spec.punctured_cols))
    xbase = np.random.default_rng(3).integers(0, 16, size=(4, 8)).astype(
        np.int32)
    jg = jax_compile_qc_graph(jax_expand_qc_xor(
        JaxQCXorCode(Z=16, base=xbase), name="q.toyxor16"))
    g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name, perm="xor")
    out["xor"] = (jg, g, _zero_cw_llr(g.n, 0.5, 1.6,
                                      np.random.default_rng(23)))
    assert out["roll"][1].intra_layer_dup_free
    assert not out["dup"][1].intra_layer_dup_free
    return out


def _jax_decode(jg, llr, monkeypatch, eager=False, **kw):
    """(DecodeResult, posteriors f32 [B, n]) of decode_layered, the
    posteriors from the state its loop returns; op by op when `eager`."""
    seen = {}
    for name in ("fori_loop", "while_loop"):
        orig = getattr(jax.lax, name)

        def rec(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            seen["total"] = out[0]
            return out

        monkeypatch.setattr(jax.lax, name, rec)
    if eager:
        with jax.disable_jit():
            res = decode_layered(jg, jnp.asarray(llr), **kw)
    else:
        res = decode_layered(jg, jnp.asarray(llr), **kw)
    total = np.asarray(seen["total"])
    return res, total.reshape(jg.nb * jg.Z, -1).T


def _same_decisions(want, got):
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())


def test_quantizer_and_bf16_match_jax():
    """quantize and round_bf16 bit for bit on ±0.0, exact ties (half a
    step, and bf16's halfway points), values past the clip, 1e12 and a
    random spread, at steps 0.25, 0.5, 1.0 and 0.3."""
    rng = np.random.default_rng(1)
    ties = np.arange(-20, 21, dtype=np.float32) + 0.5
    x = np.concatenate([
        np.float32([0.0, -0.0, 1e12, -1e12, 1e-30, -1e-30, 3.4e38]),
        ties * 0.25, ties * 0.5, ties, ties * np.float32(0.3),
        np.float32(1.0) + np.float32(2.0 ** -8) * np.arange(-4, 5),
        (rng.standard_normal(4000) * 12).astype(np.float32),
    ]).astype(np.float32)
    xt = torch.from_numpy(x)
    for bits, step in ((6, 0.25), (5, 0.5), (3, 1.0), (4, 1.0), (5, 0.3),
                       (16, 0.125), (2, 2.0)):
        want = np.asarray(jax_quantize(jnp.asarray(x), bits, step))
        got = quantize(xt, bits, step).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (bits, step)
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(round_bf16(xt).numpy().view(np.int32),
                          want.view(np.int32))
    assert torch.signbit(quantize(torch.tensor([-0.1]), 4, 1.0)).item()


# (graph, mode, quant, alpha/beta, the oracle op by op)
Q_CASES = [
    ("roll", "fixed", (6, 0.25), dict(alpha=0.8125), False),
    ("roll", "track", (6, 0.25), dict(alpha=0.8125), False),
    ("roll", "track", (5, 0.3), dict(alpha=0.8125), False),
    ("roll", "track", (4, 1.0), dict(alpha=0.75, beta=0.5), True),
    ("dup", "fixed", (6, 0.25), dict(alpha=0.8125), False),
    ("dup", "track", (6, 0.25), dict(alpha=0.8125), False),
    ("xor", "fixed", (6, 0.25), dict(alpha=0.8125), False),
    ("xor", "track", (5, 0.5), dict(alpha=0.8125), False),
]


@pytest.mark.parametrize("code,mode,quant,ab,eager", Q_CASES,
                         ids=[f"{c[0]}_{c[1]}_q{c[2][0]}_{c[2][1]}"
                              + ("_offset" if c[4] else "")
                              for c in Q_CASES])
def test_minsum_quant_matches_jax(graphs, code, mode, quant, ab, eager,
                                  monkeypatch):
    """Min-sum under q: — bits, ok, iterations and posteriors identical."""
    jg, g, llr = graphs[code]
    track = mode == "track"
    want, wpost = _jax_decode(jg, llr, monkeypatch, eager=eager, max_iters=T,
                              early_term=track, quant=quant, **ab)
    got, post = plain_with_posteriors(g, torch.from_numpy(llr), max_iters=T,
                                      early_term=track,
                                      precision=("q", *quant), **ab)
    _same_decisions(want, got)
    assert np.array_equal(post.numpy().view(np.int32), wpost.view(np.int32))
    ok = got.ok.numpy()
    assert 0 < ok.sum() < len(ok)  # some frames decode, some do not
    if track:
        assert int(got.iterations.min()) < T
    # the posteriors hold Q(llr) plus messages on the grid: every decode
    # differs from f32 somewhere
    f32 = plain_with_posteriors(g, torch.from_numpy(llr), max_iters=T,
                                early_term=track, **ab)[1]
    assert not torch.equal(f32, post)


def test_precision_arguments():
    """kernel_precision: f32, bf16, q:, and both at once refused; a wrong
    dtype or quantizer raises; the CUDA wrapper refuses both before any
    launch."""
    assert kernel_precision() is None
    assert kernel_precision(torch.bfloat16) == ("bf16",)
    assert kernel_precision(quant=(5, 0.5)) == ("q", 5, 0.5)
    with pytest.raises(ValueError, match="not both"):
        kernel_precision(torch.bfloat16, (5, 0.5))
    with pytest.raises(TypeError):
        kernel_precision(torch.float16)
    with pytest.raises(ValueError):
        kernel_precision(quant=(1, 0.5))
    g = compile_qc_graph(get_code("80211n/648/12"))
    llr = torch.zeros((2, g.n))
    before = layered_decode_cuda.launches
    with pytest.raises(ValueError, match="not both"):
        layered_decode_cuda(g, llr, msg_dtype=torch.bfloat16, quant=(5, 0.5))
    assert layered_decode_cuda.launches == before


TPU_CODES = ["dvbs2/64800/12", "dvbs2/64800/34", "dvbs2/16200/12",
             "80211n/1944/12", "wimax/2304/12", "wimax/2304/56",
             "nr5g/bg1/384", "nr5g/bg2/384", "ccsds/4096/12", "8023an"]


def test_tpu_msg_dtype_matches_jax_dispatch():
    """tpu_msg_dtype against the JAX package's rule (decode/api.py:141-145
    there): bf16 where supports(msg_bytes=2) holds and supports(
    msg_bytes=4) does not, f32 elsewhere (xor graphs and the graphs the
    kernel refuses included); today bf16 only on dvbs2/64800."""
    seen = {}
    for code in TPU_CODES:
        jg = jax_compile_qc_graph(jax_get_code(code))
        g = compile_qc_graph(get_code(code))
        for cn in ("minsum", "spa", "minstar"):
            bf16 = (jax_pallas.supports(jg, msg_bytes=2, kind=cn)
                    and not jax_pallas.supports(jg, msg_bytes=4, kind=cn))
            want = torch.bfloat16 if bf16 else torch.float32
            assert tpu_msg_dtype(g, cn) == want, (code, cn)
            seen[code, cn] = want
    assert {c for (c, _), d in seen.items() if d == torch.bfloat16} == {
        "dvbs2/64800/12", "dvbs2/64800/34"}


SPECS = ["layered/norm:0.8125/q:5:0.5/25", "layered/q:6:0.25/25/noet",
         "layered/spa/q:6:0.25/25", "layered/norm:0.8125/50/cleanup",
         "layered/norm:0.8125/25/pallas", "bitflip/50",
         "gdbf/theta:-0.5/50", "gdbf/theta:-0.5/50/noet",
         "layered/norm:0.8125/q:3:1.0/25;retry=spa/50"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parsing_matches_jax(spec):
    assert parse_decoder_spec(spec) == jax_parse(spec)


def test_spec_errors_match_jax():
    """The error cases of the JAX package's tests/decode/test_quantized.py,
    each with the JAX package's exception type; /pallas on a layered
    decoder picks the TPU's storage."""
    for bad in ("layered/q:1:0.5/25", "layered/q:17:0.5/25",
                "layered/q:5/25", "layered/q:x:0.5/25"):
        with pytest.raises(ValueError):
            jax_parse(bad)
        with pytest.raises(ValueError):
            parse_decoder_spec(bad)
    code = "80211n/648/12"
    jg = jax_compile_qc_graph(jax_get_code(code))
    g = compile_qc_graph(get_code(code))
    for spec, kw in (("minsum/q:5:0.5/25", {}),
                     ("layered/q:5:0.5/25", dict(backend="pallas")),
                     ("bitflip/50", dict(backend="pallas")),
                     ("layered/q:5:0.5/25/pallas", {})):
        with pytest.raises(KeyError):
            jax_get_decoder(jg, spec, **kw)
        with pytest.raises(KeyError):
            get_decoder(g, spec, device="cpu", **kw)
    from ecc_ldpc_tpu_torch.graph.compile import compile_graph

    with pytest.raises(TypeError, match="QCGraph"):
        get_decoder(compile_graph(get_code("mackay1008")),
                    "minsum/norm:0.8125/25/cleanup", device="cpu")
    # /pallas: f32 on this graph (the TPU kernel fits it at f32), the
    # same decode as the spec without it
    llr = torch.from_numpy(_zero_cw_llr(g.n, g.k / g.n, 2.0,
                                        np.random.default_rng(4)))
    a = get_decoder(g, "layered/norm:0.8125/8/pallas", device="cpu")(llr)
    b = get_decoder(g, "layered/norm:0.8125/8", device="cpu")(llr)
    assert torch.equal(a.bits, b.bits) and torch.equal(a.iterations,
                                                        b.iterations)


def test_make_layered_decoder_routes_precision(graphs):
    """The decoder's CPU path is the plain version at its precision."""
    _, g, llr = graphs["roll"]
    x = torch.from_numpy(llr)
    for kw, prec in ((dict(quant=(5, 0.5)), ("q", 5, 0.5)),
                     (dict(msg_dtype=torch.bfloat16), ("bf16",))):
        dec = make_layered_decoder(g, alpha=0.8125, max_iters=T,
                                   device="cpu", **kw)
        want = plain_with_posteriors(g, x, alpha=0.8125, max_iters=T,
                                     precision=prec)[0]
        got = dec(x)
        assert torch.equal(got.bits, want.bits)
        assert torch.equal(got.iterations, want.iterations)


def _fer(spec_str, ebn0=2.4, batch=256):
    """FER (ok false) of build_ecc(80211n/648/12) on the CPU, one seed."""
    ecc = build_ecc("80211n/648/12", spec_str, device="cpu")
    gen = torch.Generator().manual_seed(0)
    msg = torch.randint(0, 2, (batch, ecc.k), generator=gen,
                        dtype=torch.uint8)
    out = ecc.decode(ecc.transmit(gen, ecc.encode(msg), ebn0))
    return float((~out.ok).float().mean())


def test_quantized_fer_ordering():
    """The JAX package's property (tests/decode/test_quantized.py:58-66)
    on the port's CPU path: 6-bit/0.25 sits near float, 3-bit/1.0 is
    clearly broken."""
    f_float = _fer("layered/norm:0.8125/25")
    f_q6 = _fer("layered/norm:0.8125/q:6:0.25/25")
    f_q3 = _fer("layered/norm:0.8125/q:3:1.0/25")
    assert f_q6 <= 4 * max(f_float, 1e-3)
    assert f_q3 > 10 * f_q6
