"""The port's layered decoding on multi-edge graphs (a block-column repeated
inside a layer: CCSDS AR4JA) against the JAX package: the accumulate form
of decode/xla/layered.py::decode_layered (count signs, each slot's
Cnew - Cold added to the posteriors in layer order, reverse for minstar,
a sign-flip check after every slot), and once the Pallas kernel's
sweep_classic in interpret mode.

Codes: ccsds/1024/12 (Z=512, row degrees 3/6/6) and ar4ja(M=32) at rates
2/3 and 4/5 (row degrees up to 10 and 18), both packages built from their
own code modules (tests/test_torch_ccsds.py holds them equal). LLRs from a
numpy seed, with the punctured block at LLR 0.

Tolerances: min-sum must match bit for bit, posteriors included; the exact
rules (spa, minstar) must give identical bits, ok and iterations, with
posteriors after one sweep within atol 1e-3 / rtol 1e-4 (XLA:CPU's and
PyTorch's exp, log, tanh and log1p differ by ulps;
tests/test_torch_layered_exact.py says why that is the contract).

With an offset (beta != 0) the oracle runs op by op (jax.disable_jit):
compiled, XLA:CPU contracts the magnitude's alpha*m - beta into one fused
multiply-add, one rounding where the JAX source writes two; the port and
the CUDA kernel (built with -fmad=false) round the product first, as the
source reads. With beta = 0 the two agree bit for bit either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import ccsds as jax_ccsds
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.decode.pallas.layered_qc import make_layered_pallas_decoder
from ecc_ldpc_tpu.decode.xla.layered import (
    _cn_minsum_axis0,
    _cn_spa_seq,
    decode_layered,
)
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.bench.throughput import (
    CCSDS_LEGS,
    CCSDS_PRODUCTION_SWEEP,
    decode_bound,
    decode_ops,
)
from ecc_ldpc_tpu_torch.cli.main import main as cli_main
from ecc_ldpc_tpu_torch.codes import ccsds
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import get_decoder, parse_decoder_spec
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    _cn_minsum,
    _cn_spa,
    layered_classic_cuda,
    layered_decode_cuda,
    layered_decode_plain,
    layered_exact_cuda,
    make_layered_decoder,
    plain_with_posteriors,
)
from ecc_ldpc_tpu_torch.encode.structured import build_encoder
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

T = 8
B = 16
ATOL, RTOL = 1e-3, 1e-4
_SCHED = np.random.default_rng(11)
SCHED = dict(alpha=_SCHED.uniform(0.7, 0.95, T).astype(np.float32),
             beta=_SCHED.uniform(0.0, 0.1, T).astype(np.float32))
# (name, rule, alpha/beta, track mode)
CASES = [
    ("minsum_fixed", "minsum", dict(alpha=0.8125), False),
    ("minsum_track", "minsum", dict(alpha=0.8125), True),
    ("minsum_offset", "minsum", dict(alpha=0.8125, beta=0.15), True),
    ("minsum_sched", "minsum", SCHED, True),
    ("spa_fixed", "spa", {}, False),
    ("spa_track", "spa", {}, True),
    ("minstar_fixed", "minstar", {}, False),
    ("minstar_track", "minstar", {}, True),
]
# (name, port code, JAX code, Eb/N0 where T sweeps decode some frames)
CODES = {
    "ccsds1024_12": (lambda: get_code("ccsds/1024/12"),
                     lambda: jax_get_code("ccsds/1024/12"), 2.5),
    "m32_23": (lambda: ccsds.ar4ja(rate="23", M=32),
               lambda: jax_ccsds.ar4ja(rate="23", M=32), 2.5),
    "m32_45": (lambda: ccsds.ar4ja(rate="45", M=32),
               lambda: jax_ccsds.ar4ja(rate="45", M=32), 3.5),
}


@pytest.fixture(scope="module")
def codes():
    """{name: (port spec, port graph, JAX graph, llr f32 [B, n])}."""
    out = {}
    for i, (name, (port, jax_code, ebn0)) in enumerate(CODES.items()):
        spec, jspec = port(), jax_code()
        rng = np.random.default_rng(30 + i)
        msg = rng.integers(0, 2, (B, spec.k), dtype=np.uint8)
        cw = build_encoder(spec)(torch.from_numpy(msg)).numpy()
        sigma = (2.0 * spec.rate * 10.0 ** (ebn0 / 10.0)) ** -0.5
        y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
        llr = (2.0 * y / sigma ** 2).astype(np.float32)
        llr[:, list(spec.punctured_cols)] = 0.0
        out[name] = (spec, compile_qc_graph(spec),
                     jax_compile_qc_graph(jspec), llr)
    return out


def _jax_decode(jg, llr, monkeypatch, **kw):
    """(DecodeResult, posteriors f32 [B, n]) of decode_layered, the
    posteriors taken from the state its loop returns; op by op when a
    min-sum offset is given."""
    seen = {}
    for name in ("fori_loop", "while_loop"):
        orig = getattr(jax.lax, name)

        def rec(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            seen["total"] = out[0]
            return out

        monkeypatch.setattr(jax.lax, name, rec)
    if np.any(np.asarray(kw.get("beta", 0.0)) != 0):
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


@pytest.mark.parametrize("code", list(CODES))
@pytest.mark.parametrize("name,cn,ab,track", CASES,
                         ids=[c[0] for c in CASES])
def test_accumulate_form_matches_jax(codes, code, name, cn, ab, track,
                                     monkeypatch):
    spec, g, jg, llr = codes[code]
    want, wpost = _jax_decode(jg, llr, monkeypatch, cn=cn, max_iters=T,
                              early_term=track, **ab)
    got, post = plain_with_posteriors(g, torch.from_numpy(llr), cn=cn,
                                      max_iters=T, early_term=track, **ab)
    _same_decisions(want, got)
    ok = got.ok.numpy()
    assert 0 < ok.sum() < len(ok)  # some frames decode, some do not
    if track:
        assert int(got.iterations.min()) < T
    if cn == "minsum":
        assert np.array_equal(post.numpy().view(np.int32),
                              wpost.view(np.int32))
    elif not track:
        one = dict(cn=cn, max_iters=1, early_term=False)
        _, wpost = _jax_decode(jg, llr, monkeypatch, **one)
        _, post = plain_with_posteriors(g, torch.from_numpy(llr), **one)
        np.testing.assert_allclose(post.numpy(), wpost, atol=ATOL, rtol=RTOL)


def test_count_sign_rules_match_jax():
    """The count-sign check rules on ±0.0, ties and saturated inputs."""
    rng = np.random.default_rng(4)
    V = rng.normal(0.0, 3.0, (6, 4, 16)).astype(np.float32)
    V[0, 0, :4] = [0.0, -0.0, 55.0, -1e9]
    V[1, 0, :4] = [-0.0, 0.0, 0.0, 2.0]
    V[:, 1, 3] = 1.5  # every slot ties
    V[2, 2, :3] = [-0.0, -0.0, -0.0]
    for a, b in ((0.8125, 0.0), (1.0, 0.15)):
        want = np.asarray(_cn_minsum_axis0(jnp.asarray(V), a, b,
                                           signbit=False))
        got = _cn_minsum(torch.from_numpy(V), a, b, signbit=False).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(_cn_spa_seq(jnp.asarray(V), signbit=False))
    got = _cn_spa(torch.from_numpy(V), signbit=False).numpy()
    assert np.array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_interpret(codes):
    """Min-sum, track mode, against the Pallas kernel's sweep_classic."""
    _, g, jg, llr = codes["ccsds1024_12"]
    want = make_layered_pallas_decoder(
        jg, alpha=0.8125, max_iters=T, early_term=True, interpret=True,
        batch_tile=16)(jnp.asarray(llr))
    got = layered_decode_plain(g, torch.from_numpy(llr), alpha=0.8125,
                               max_iters=T, early_term=True)
    _same_decisions(want, got)
    assert 0 < int(got.ok.sum()) < B


def test_frozen_frames_keep_negative_zero(codes):
    """A frame that passes before the first sweep keeps its LLRs bit for
    bit, the punctured block's -0.0 included; the others still decode."""
    spec, g, _, llr = codes["m32_23"]
    x = llr.copy()
    cw0 = build_encoder(spec)(torch.zeros((1, spec.k), dtype=torch.uint8))
    x[0] = 3.0 * (1.0 - 2.0 * cw0[0].numpy())
    x[0, list(spec.punctured_cols)] = -0.0
    for cn in ("minsum", "spa", "minstar"):
        res, post = plain_with_posteriors(g, torch.from_numpy(x), cn=cn,
                                          max_iters=T, early_term=True)
        assert res.iterations[0] == 0 and bool(res.ok[0])
        assert np.array_equal(post[0].numpy().view(np.int32),
                              x[0].view(np.int32))
        assert int(res.iterations.max()) > 0


def test_cli_sweep_on_the_cpu(tmp_path):
    """The slice end to end on the CPU: code, dense encoder, channel with
    the punctured block, primary min-sum and the spa fallback, both in
    the accumulate form."""
    import json

    out = tmp_path / "ccsds.json"
    rc = cli_main(["sweep", "--code", "ccsds/1024/12", "--decoder",
                   "layered/norm:0.8125/10;retry=layered/spa/10",
                   "--ebn0", "1.0,3.0", "--batch", "4", "--max-frames", "4",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    pts = json.loads(out.read_text())
    assert [p["ebn0_db"] for p in pts] == [1.0, 3.0]
    assert all(p["frames"] == 4 and p["code"] == "ccsds/1024/12"
               for p in pts)
    # at 1.0 dB the primary fails frames and the fallback runs them on
    assert pts[0]["iters_sum"] > 4 * 10 or pts[0]["frame_errors"] > 0
    assert pts[1]["frame_errors"] == 0


def test_cuda_paths_refuse_the_cpu(codes):
    """No card and no device="cpu": the decoders raise, and no counter
    moves; with device="cpu" they decode."""
    _, g, _, llr = codes["m32_45"]
    x = torch.from_numpy(llr)
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py drives the kernel")
    before = (layered_classic_cuda.launches, layered_classic_cuda.frames,
              layered_decode_cuda.launches, layered_exact_cuda.launches)
    with pytest.raises(RuntimeError):
        make_layered_decoder(g, alpha=0.8125, max_iters=2)
    with pytest.raises(RuntimeError):
        get_decoder(g, "layered/spa/2")
    for cn in ("minsum", "spa", "minstar"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            layered_classic_cuda(g, x, max_iters=2, cn=cn)
    assert (layered_classic_cuda.launches, layered_classic_cuda.frames,
            layered_decode_cuda.launches,
            layered_exact_cuda.launches) == before
    dec = make_layered_decoder(g, alpha=0.8125, max_iters=2, device="cpu")
    assert torch.equal(dec(x).bits, layered_decode_plain(
        g, x, alpha=0.8125, max_iters=2).bits)


def test_accumulate_bound_counts():
    """decode_ops(accumulate=True): the layered counts plus the message
    change and its add into the posterior (2 per edge visit); spa keeps 5
    transcendentals. At the CCSDS legs' shape the operations bound it."""
    E, m = 30720, 6144  # ccsds/4096/12
    assert decode_ops(E, m, "minsum", accumulate=True) == (0, 14 * E)
    assert decode_ops(E, m, "spa", accumulate=True) == (5 * E, 16 * E)
    assert decode_ops(E, m, "minstar", accumulate=True) == (
        12 * (E - 2 * m), 48 * (E - 2 * m) + 6 * E)
    with pytest.raises(ValueError, match="layered"):
        decode_ops(E, m, "spa", "flooding", accumulate=True)
    want = {"minsum": 0.6573e-3, "spa": 3.7612e-3, "minstar": 5.4162e-3}
    for cn, cfg in CCSDS_LEGS.items():
        assert cfg["code"] == "ccsds/4096/12" and cfg["batch"] == 4096
        assert parse_decoder_spec(cfg["decoder"])["early_term"] is False
        s, form = decode_bound(10240, E, 4096, 4096 * 25, cn, m,
                               accumulate=True)
        assert form == "operations" and abs(s - want[cn]) < 1e-6
    assert CCSDS_PRODUCTION_SWEEP["decoder"] == \
        "layered/norm:0.8125/50;retry=layered/spa/50"
