"""The TPU kernels' roundings under `/pallas` and the `/xla-mm` backend in
the port's plain versions, against the JAX package on the same graphs and
LLR arrays:

- K3's bf16 storage (decode/flooding_qc.py, precision ("bf16",)) against
  decode/pallas/flooding_qc.py with msg, total, llr and acc dtypes bf16 in
  interpret mode on wimax/576/12 (Z = 24), each rule, track mode: bits, ok
  and iterations identical.
- K2's bf16 matmul inputs (decode/flooding.py, ("bf16",)) against
  decode/pallas/fused_mm.py with mxu_dtype bf16 in interpret mode on
  mackay1008, fixed and track: bits, ok and iterations identical.
- K4's bf16 permutations (("bf16-perm",)): XLA:CPU runs the TPU's one-pass
  bf16 matmul (Precision.DEFAULT) at full f32, so no JAX function on the
  CPU computes them. The plain version's frame errors on the toy xor code
  stay within the binomial band tests/ber/test_bf16_parity.py allows of
  the JAX f32 xor kernel's (interpret mode), layered and flooding, and
  every posterior the layered form stores is bf16-representable.
- `/xla-mm` against JAX make_decoder(g, kind, backend="xla-mm") on
  mackay1008, minsum and spa: bits, ok and iterations identical (spa's
  magnitudes take other transcendentals; its decisions agree here).
- choose_graph's view and the precision make_decoder picks, against the
  JAX package's choose_graph and Pallas routing, for the codes of the
  rounding table in PERF.md.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.qc import QCXorCode as JaxQCXorCode
from ecc_ldpc_tpu.codes.qc import expand_qc_xor as jax_expand_qc_xor
from ecc_ldpc_tpu.decode.api import choose_graph as jax_choose_graph
from ecc_ldpc_tpu.decode.api import make_decoder as jax_make_decoder
from ecc_ldpc_tpu.decode.pallas import flooding_qc as jax_k3
from ecc_ldpc_tpu.decode.pallas import fused_mm as jax_k2
from ecc_ldpc_tpu.decode.pallas.layered_xor import make_layered_xor_decoder
from ecc_ldpc_tpu.graph import compile_graph as jax_compile_graph
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode import flooding as fl
from ecc_ldpc_tpu_torch.decode import flooding_qc as fq
from ecc_ldpc_tpu_torch.decode import layered_qc as lq
from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder
from ecc_ldpc_tpu_torch.decode.quant import BF16, PERM
from ecc_ldpc_tpu_torch.graph.compile import compile_graph
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

KW = {"minsum": dict(alpha=0.8125), "spa": {}, "minstar": {}}


def _awgn_llr(n, B, ebn0_db, rate, rng):
    """LLRs of the all-zero codeword over BPSK + AWGN (f32 [B, n])."""
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _same(want, got):
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())


@pytest.fixture(scope="module")
def wimax():
    spec = get_code("wimax/576/12")
    llr = _awgn_llr(spec.n, 16, 1.8, spec.rate, np.random.default_rng(11))
    llr[0] = 3.0  # noiseless: done before the first sweep
    return (jax_compile_qc_graph(jax_get_code("wimax/576/12")),
            compile_qc_graph(spec), llr)


@pytest.fixture(scope="module")
def mackay():
    spec = get_code("mackay1008")
    llr = _awgn_llr(spec.n, 16, 2.0, spec.rate, np.random.default_rng(12))
    return jax_compile_graph(jax_get_code("mackay1008")), compile_graph(spec), llr


@pytest.mark.parametrize("kind", ["minsum", "spa", "minstar"])
def test_k3_bf16_matches_pallas_interpret(wimax, kind):
    jg, g, llr = wimax
    T = 8
    bf = jnp.bfloat16
    want = jax_k3.make_flooding_pallas_decoder(
        jg, kind=kind, max_iters=T, early_term=True, interpret=True,
        batch_tile=16, msg_dtype=bf, total_dtype=bf, llr_dtype=bf,
        acc_dtype=bf, **KW[kind])(jnp.asarray(llr))
    got = fq.flooding_qc_decode_plain(g, torch.from_numpy(llr), kind=kind,
                                      max_iters=T, precision=BF16,
                                      **KW[kind])
    _same(want, got)
    f32 = fq.flooding_qc_decode_plain(g, torch.from_numpy(llr), kind=kind,
                                      max_iters=T, **KW[kind])
    assert bool(got.ok[0]) and int(got.iterations[0]) == 0
    # the rounding is seen: the posteriors differ from f32's
    _, p16 = fq.flooding_qc_with_posteriors_plain(
        g, torch.from_numpy(llr), kind=kind, max_iters=2, early_term=False,
        precision=BF16, **KW[kind])
    assert torch.equal(p16, p16.to(torch.bfloat16).float())
    assert f32.bits.shape == got.bits.shape


@pytest.mark.parametrize("track", [False, True], ids=["fixed", "track"])
def test_k2_bf16_matches_pallas_interpret(mackay, track):
    jg, g, llr = mackay
    T = 10
    want = jax_k2.make_pallas_decoder(
        jg, "minsum", alpha=0.8125, max_iters=T, early_term=track,
        interpret=True, mxu_dtype=jnp.bfloat16)(jnp.asarray(llr))
    got = fl.flooding_decode_plain(g, torch.from_numpy(llr), alpha=0.8125,
                                   max_iters=T, early_term=track,
                                   precision=BF16)
    _same(want, got)
    # the rounding is seen: bf16 and f32 posteriors differ
    _, a = fl.flooding_with_posteriors_plain(
        g, torch.from_numpy(llr), alpha=0.8125, max_iters=2,
        early_term=False, precision=BF16)
    _, b = fl.flooding_with_posteriors_plain(
        g, torch.from_numpy(llr), alpha=0.8125, max_iters=2,
        early_term=False)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="min-sum"):
        fl.flooding_decode_plain(g, torch.from_numpy(llr), kind="spa",
                                 max_iters=2, precision=BF16)


def test_k4_bf16_fer_band_and_storage():
    """FER within test_bf16_parity.py's band of the JAX f32 xor kernel in
    interpret mode (HIGHEST: an exact selection), layered and flooding;
    the layered posteriors bf16-representable."""
    Z = 16
    base = np.random.default_rng(3).integers(0, Z, size=(4, 8)).astype(
        np.int32)
    jspec = jax_expand_qc_xor(JaxQCXorCode(Z=Z, base=base), name="toyxor16")
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toyxor16")
    jg, g = jax_compile_qc_graph(jspec), compile_qc_graph(spec)
    B, T = 256, 20
    llr = _awgn_llr(spec.n, B, 2.2, 0.5, np.random.default_rng(21))
    x = torch.from_numpy(llr)
    assert lq.tpu_precision(g) == PERM
    assert fq.tpu_flooding_precision(g) == PERM
    for schedule in ("layered", "flooding"):
        want = make_layered_xor_decoder(
            jg, alpha=0.8125, max_iters=T, early_term=True, interpret=True,
            schedule=schedule)(jnp.asarray(llr))
        plain = (lq.plain_with_posteriors if schedule == "layered"
                 else fq.flooding_qc_with_posteriors_plain)
        got, post = plain(g, x, alpha=0.8125, max_iters=T, precision=PERM)
        _, f32 = plain(g, x, alpha=0.8125, max_iters=T)
        e_jax = int(np.asarray(want.bits).any(1).sum())
        e_port = int(got.bits.any(1).sum())
        assert 0 < e_jax < B
        assert abs(e_port - e_jax) <= max(5, 0.5 * e_jax + 5), (schedule,
                                                                 e_port,
                                                                 e_jax)
        assert not torch.equal(post, f32)  # the rounding is seen
        if schedule == "layered":
            assert torch.equal(post, post.to(torch.bfloat16).float())


@pytest.mark.parametrize("kind", ["minsum", "spa"])
def test_xla_mm_matches_jax(mackay, kind):
    jg, g, llr = mackay
    want = jax_make_decoder(jg, kind, max_iters=12, backend="xla-mm",
                            **KW[kind])(jnp.asarray(llr))
    spec = f"{'minsum/norm:0.8125' if kind == 'minsum' else 'spa'}/12/xla-mm"
    graph = choose_graph(get_code("mackay1008"), spec, backend="xla-mm")
    got = get_decoder(graph, spec, device="cpu")(torch.from_numpy(llr))
    _same(want, got)
    with pytest.raises(KeyError, match="spa/minsum"):
        get_decoder(graph, "minstar/5/xla-mm", device="cpu")


# the JAX graph view, and the precision /pallas decodes with (None: f32)
ROUTES = [
    ("nr5g/bg1/384", "minsum", "QCGraph", BF16),
    ("nr5g/bg1/384", "spa", "QCGraph", BF16),
    ("nr5g/bg1/384", "minstar", "QCGraph", BF16),
    ("dvbs2/16200/12", "minsum", "QCGraph", None),
    ("wimax/576/12", "spa", "QCGraph", None),
    ("nr5g/bg2/384", "minsum", "QCGraph", None),
    ("ccsds/1024/12", "minsum", "QCGraph", None),
    ("80211n/648/12", "minsum", "CompiledGraph", BF16),
    ("80211n/648/12", "spa", "CompiledGraph", None),
    ("80211n/648/12", "minstar", "QCGraph", None),
    ("80211n/1944/12", "minsum", "QCGraph", None),
    ("8023an", "minsum", "QCGraph", PERM),
    ("8023an", "spa", "QCGraph", None),
    ("mackay1008", "minsum", "CompiledGraph", BF16),
]


@pytest.mark.parametrize("code,kind,view,prec", ROUTES,
                         ids=[f"{c}-{k}" for c, k, _, _ in ROUTES])
def test_choose_graph_matches_jax(code, kind, view, prec):
    spec = f"{kind}/25"
    # a QC code's other backends route every kind alike: min-sum's case
    # checks them
    for backend in (("pallas", "xla-mm", None) if kind == "minsum"
                    or code == "80211n/648/12" else ("pallas",)):
        want = type(jax_choose_graph(jax_get_code(code), spec,
                                     backend=backend)).__name__
        got = choose_graph(get_code(code), spec, backend=backend)
        assert type(got).__name__ == want, (code, kind, backend)
    graph = choose_graph(get_code(code), spec, backend="pallas")
    assert type(graph).__name__ == view
    mod = fq if view == "QCGraph" else fl
    assert mod.tpu_flooding_precision(graph, kind) == prec
