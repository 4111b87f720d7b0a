"""The port's flooding decoder on unstructured graphs (decode/cn_ops.py,
decode/flooding.py) against the JAX package: the check rules against
decode/xla/cn_ops.py, whole decodes of mackay1008 against
decode/xla/flooding.py::decode_flooding, and the fused Pallas kernel
(decode/pallas/fused_mm.py, K2) in interpret mode at f32.

Same graph (carried across with convert.compiled_graph_from_numpy), same
LLR array from a numpy seed. Tolerances:
- minsum is bit-identical: the same adds, multiplies and compares in the
  same order, sums in slot order, no fused multiply-add;
- spa and minstar: decisions (bits, ok, iterations) equal and messages
  (and the posteriors after one iteration) within atol 1e-3 / rtol 1e-4,
  because XLA:CPU and PyTorch compute tanh,
  log, exp, atanh and log1p to within a few ulps of each other, not bit
  for bit, and near t -> 1 the spa magnitude 2*atanh(t) magnifies one ulp
  of t by up to 1/(1-t) = 1e7 before the clip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import gallager_36, mackay_1008
from ecc_ldpc_tpu.decode.pallas.fused_mm import make_pallas_decoder
from ecc_ldpc_tpu.decode.xla import cn_ops as jax_cn
from ecc_ldpc_tpu.decode.xla.flooding import decode_flooding
from ecc_ldpc_tpu.encode import DenseEncoder as JaxDenseEncoder
from ecc_ldpc_tpu.graph import compile_graph as jax_compile_graph
from ecc_ldpc_tpu_torch.convert import compiled_graph_from_numpy
from ecc_ldpc_tpu_torch.decode import cn_ops
from ecc_ldpc_tpu_torch.decode.flooding import (
    flooding_decode_cuda,
    flooding_decode_plain,
    flooding_with_posteriors_plain,
    make_flooding_decoder,
)

torch.set_num_threads(1)

T = 8
ATOL, RTOL = 1e-3, 1e-4
KW = {"minsum": dict(alpha=0.8125, beta=0.0), "spa": {}, "minstar": {}}


def _port_graph(jg):
    return compiled_graph_from_numpy(
        jg.n, jg.m, jg.k, np.asarray(jg.cn_vn), np.asarray(jg.cn_mask),
        np.asarray(jg.vn_edge), np.asarray(jg.vn_mask), jg.name)


def _llr(cw, rate, ebn0_db, rng):
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def mackay():
    """(JAX graph, port graph, llr f32 [8, 1008]) at 1.8 dB, where 8
    iterations decode some frames and not others; frame 0 is noiseless, so
    its channel hard decisions already pass (done before any sweep)."""
    spec = mackay_1008()
    jg = jax_compile_graph(spec)
    enc = JaxDenseEncoder.build(spec)
    rng = np.random.default_rng(11)
    msg = rng.integers(0, 2, (8, spec.k), dtype=np.uint8)
    cw = np.asarray(enc(jnp.asarray(msg)))
    llr = _llr(cw, spec.rate, 1.8, rng)
    llr[0] = 4.0 * (1.0 - 2.0 * cw[0])
    return jg, _port_graph(jg), llr


def _jax_op(kind):
    if kind == "minsum":
        return lambda V, m: jax_cn.cn_minsum(V, m, **KW["minsum"])
    return {"spa": jax_cn.cn_spa, "minstar": jax_cn.cn_minstar}[kind]


def _rule_input(dc: int):
    """V f32 [6, dc, 16] with ±0.0, tied minima, big magnitudes, and mask
    [6, dc, 1] whose rows have 1..dc real slots (a prefix, as
    compile_graph lays them out)."""
    rng = np.random.default_rng(200 + dc)
    V = rng.normal(0.0, 3.0, (6, dc, 16)).astype(np.float32)
    V[0, :, 0] = 0.0
    V[0, 0, 1] = -0.0
    if dc > 1:
        V[1, :2, 2] = [1.5, -1.5]  # a tied minimum
    V[1, :, 3] = -2.25             # every slot tied
    V[2, 0, 4:7] = [45.0, -1e9, 55.0]
    deg = np.minimum(np.arange(6) + 1, dc)
    mask = (np.arange(dc)[None, :] < deg[:, None])[:, :, None]
    V[~np.broadcast_to(mask, V.shape)] = 7.0  # padded slots are ignored
    return V, mask


@pytest.mark.parametrize("dc", [1, 3, 6])
@pytest.mark.parametrize("kind", ["minsum", "spa", "minstar"])
def test_cn_rules_match_jax(kind, dc):
    V, mask = _rule_input(dc)
    want = np.asarray(_jax_op(kind)(jnp.asarray(V), jnp.asarray(mask)))
    got = cn_ops.get_rule(kind, **KW[kind])(
        torch.from_numpy(V), torch.from_numpy(mask), 1).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if kind == "minsum":
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _jax_posteriors(jg, llr, kind, T):
    """Posteriors after T fixed iterations of decode_flooding, rebuilt from
    its last check messages by the oracle's own expression (run eagerly,
    recording each call of the check rule)."""
    calls = []
    op = _jax_op(kind)

    def recording(V, m):
        C = op(V, m)
        calls.append(C)
        return C

    with jax.disable_jit():
        decode_flooding(jg, jnp.asarray(llr), cn_op=recording, max_iters=T,
                        early_term=False)
        B = llr.shape[0]
        Cv = calls[-1].reshape(jg.m * jg.dc_max, B)[jg.vn_edge]
        total = jnp.asarray(llr).T + jnp.sum(
            jnp.where(jg.vn_mask[:, :, None], Cv, 0.0), axis=1)
    return np.asarray(total).T


@pytest.mark.parametrize("kind", ["minsum", "spa", "minstar"])
@pytest.mark.parametrize("mode", ["fixed", "track"])
def test_flooding_plain_matches_jax(mackay, kind, mode):
    jg, g, llr = mackay
    et = mode == "track"
    want = jax.jit(lambda x: decode_flooding(
        jg, x, cn_op=_jax_op(kind), max_iters=T, early_term=et))(
            jnp.asarray(llr))
    got, post = flooding_with_posteriors_plain(
        g, torch.from_numpy(llr), kind=kind, max_iters=T, early_term=et,
        **KW[kind])
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations),
                          got.iterations.numpy())
    ok = got.ok.numpy()
    assert 0 < ok.sum() < len(ok)  # some frames decode, some do not
    if et:
        # frame 0 passed before any sweep; another converged mid-decode
        assert got.iterations[0] == 0
        assert ((got.iterations.numpy() < T) & ok)[1:].any()
    elif kind == "minsum":
        ref = _jax_posteriors(jg, llr, kind, T)
        assert np.array_equal(post.numpy().view(np.int32), ref.view(np.int32))
    else:
        # a few ulps per rule application grow over T iterations of
        # saturating messages, so the tolerance applies after one
        _, post1 = flooding_with_posteriors_plain(
            g, torch.from_numpy(llr), kind=kind, max_iters=1,
            early_term=False)
        ref = _jax_posteriors(jg, llr, kind, 1)
        np.testing.assert_allclose(post1.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def small():
    """A (3,6)-regular n=96 code as tests/pallas/test_fused_mm.py sets it
    up, with LLRs at 2.5 dB."""
    spec = gallager_36(96, seed=4)
    jg = jax_compile_graph(spec)
    enc = JaxDenseEncoder.build(spec)
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, (32, spec.k), dtype=np.uint8)
    cw = np.asarray(enc(jnp.asarray(msg)))
    return jg, _port_graph(jg), _llr(cw, spec.rate, 2.5, rng)


@pytest.mark.parametrize("kind", ["minsum", "spa"])
def test_flooding_plain_matches_pallas_interpret(small, kind):
    """K2 in interpret mode at f32: identical decisions."""
    jg, g, llr = small
    kw = KW[kind]
    want = make_pallas_decoder(jg, kind, max_iters=12, interpret=True,
                               mxu_dtype=jnp.float32, **kw)(jnp.asarray(llr))
    got = flooding_decode_plain(g, torch.from_numpy(llr), kind=kind,
                                max_iters=12, **kw)
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations),
                          got.iterations.numpy())


def test_flooding_decoder_routes_and_rejects(small):
    _, g, llr = small
    x = torch.from_numpy(llr)
    dec = make_flooding_decoder(g, kind="spa", max_iters=4, device="cpu")
    assert torch.equal(dec(x).bits, flooding_decode_plain(
        g, x, kind="spa", max_iters=4).bits)
    with pytest.raises(KeyError):
        make_flooding_decoder(g, kind="bp", device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        make_flooding_decoder(g, alpha=np.full(4, 0.8), device="cpu")
    before = (flooding_decode_cuda.launches, flooding_decode_cuda.frames)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flooding_decode_cuda(g, x, max_iters=2)
    assert (flooding_decode_cuda.launches, flooding_decode_cuda.frames) \
        == before


SPECS = [
    "minsum/norm:0.8125/25",
    "minsum/offset:0.15/25/noet",
    "spa/50",
    "minstar/25/pallas",
    "spa/25/xla",
    "minsum/25/auto",
    "minsum/25/xla-mm",
    "layered/norm:0.8125/50;retry=spa/50",
    "gdbf/theta:-0.5/50",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_choose_graph_match_jax(spec):
    """parse_decoder_spec gives the JAX package's kwargs, and choose_graph
    its graph view: the QC view for a QC code, the expanded graph for
    mackay1008 (the ;retry= fallback shares the primary's)."""
    from ecc_ldpc_tpu.codes import get_code as jax_get_code
    from ecc_ldpc_tpu.decode.api import choose_graph as jax_choose
    from ecc_ldpc_tpu.decode.api import parse_decoder_spec as jax_parse
    from ecc_ldpc_tpu_torch.codes.registry import get_code
    from ecc_ldpc_tpu_torch.decode.api import choose_graph, parse_decoder_spec

    assert parse_decoder_spec(spec) == jax_parse(spec)
    for code in ("dvbs2/16200/12", "mackay1008"):
        if spec.startswith("layered") and code == "mackay1008":
            continue
        want = type(jax_choose(jax_get_code(code), spec)).__name__
        assert type(choose_graph(get_code(code), spec)).__name__ == want


def test_backends_and_kinds_route(small):
    from ecc_ldpc_tpu_torch.decode.api import get_decoder

    _, g, llr = small
    x = torch.from_numpy(llr)
    ref = flooding_decode_plain(g, x, kind="spa", max_iters=5)
    # spa keeps f32 under every backend (the TPU's bf16 matmul inputs are
    # min-sum's); xla-mm is K2's arithmetic at f32
    for part in ("pallas", "xla", "auto", "xla-mm"):
        got = get_decoder(g, f"spa/5/{part}", device="cpu")(x)
        assert torch.equal(got.bits, ref.bits)
    with pytest.raises(KeyError, match="spa/minsum"):
        get_decoder(g, "minstar/5/xla-mm", device="cpu")
    with pytest.raises(KeyError, match="cn="):
        from ecc_ldpc_tpu_torch.decode.api import make_decoder

        make_decoder(g, "spa", cn="minstar", device="cpu")
    with pytest.raises(TypeError, match="QCGraph"):
        get_decoder(g, "layered/norm:0.8/5", device="cpu")


def test_cpu_sweeps_run_both_paths(tmp_path):
    """Both paths of the slice through run_sweep on the CPU, a few frames
    each: mackay1008 with spa/50 (dense encoder, K2's plain version), and
    dvbs2/16200/12 with the layered primary and the QC flooding fallback."""
    from ecc_ldpc_tpu_torch.sim import StoppingRule, SweepSpec, run_sweep

    stop = StoppingRule(min_frame_errors=1000, max_frames=8)
    (pr,) = run_sweep(SweepSpec(code="mackay1008", decoder="spa/50",
                                ebn0_db=(3.0,), batch=8, stopping=stop),
                      device="cpu")
    assert pr.frames == 8 and pr.message_bits_per_frame == 506
    assert pr.frame_errors == 0 and 0 < pr.mean_iters < 50
    (pr,) = run_sweep(SweepSpec(
        code="dvbs2/16200/12", decoder="layered/norm:0.8125/10;retry=spa/10",
        ebn0_db=(1.0,), batch=4, stopping=StoppingRule(
            min_frame_errors=1000, max_frames=4)), device="cpu")
    # at 1.0 dB 10 layered iterations fail these frames: every one went to
    # the flooding fallback and ran its 10 sweeps on top
    assert pr.frames == 4 and pr.mean_iters == 20
