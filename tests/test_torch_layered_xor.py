"""The port's plain layered and QC flooding decoders on XOR-permutation
graphs (K4's two modes) against the JAX package: the XLA oracle
(decode/xla/layered.py with sign_mode="bitxor", decode/xla/flooding_qc.py)
and the Pallas kernel decode/pallas/layered_xor.py in interpret mode (its
one-hot permutation is an exact f32 selection there).

Most cases run a toy QCXorCode (Z = 16, a 4x8 base from default_rng(3), as
tests/pallas/test_layered_xor.py builds it); a few run 8023an (Z = 64, row
degree 32), whose oracle takes ~15 s to compile per decoder. Same graph,
same LLR array from a numpy seed. Tolerances:
- min-sum, layered and flooding: bits, ok, iterations and final posteriors
  identical (atol 0). With an offset the oracle runs op by op
  (jax.disable_jit), because XLA:CPU fuses alpha*m - beta into an FMA.
- spa and minstar: decisions identical; posteriors after one sweep within
  atol 1e-3 / rtol 1e-4 (XLA:CPU and PyTorch transcendentals differ by
  ulps).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.qc import QCXorCode as JaxQCXorCode
from ecc_ldpc_tpu.codes.qc import expand_qc_xor as jax_expand_qc_xor
from ecc_ldpc_tpu.decode.api import get_decoder as jax_get_decoder
from ecc_ldpc_tpu.decode.pallas.layered_xor import make_layered_xor_decoder
from ecc_ldpc_tpu.decode.xla import flooding_qc as jax_fqc
from ecc_ldpc_tpu.decode.xla import layered as jax_layered
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.bench.throughput import XOR_LEGS, decode_bound
from ecc_ldpc_tpu_torch.cli.main import main as cli_main
from ecc_ldpc_tpu_torch.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import (
    get_decoder,
    make_decoder,
    parse_decoder_spec,
)
from ecc_ldpc_tpu_torch.decode.flooding_qc import (
    _plain_tables,
    flooding_qc_decode_cuda,
    flooding_qc_with_posteriors_plain,
)
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    _plain_layers,
    layered_classic_cuda,
    layered_decode_cuda,
    layered_decode_plain,
    layered_exact_cuda,
    make_layered_decoder,
    plain_with_posteriors,
)
from ecc_ldpc_tpu_torch.graph.qc import (
    check_index,
    compile_qc_graph,
    qc_graph_from_block_edges,
    var_index,
)

torch.set_num_threads(1)

T = 10
B = 32
ATOL, RTOL = 1e-3, 1e-4
_SCHED = np.random.default_rng(13)
SCHED = dict(alpha=_SCHED.uniform(0.7, 0.95, T).astype(np.float32),
             beta=_SCHED.uniform(0.0, 0.1, T).astype(np.float32))


def _awgn_llr(n, B, ebn0_db, rate, rng):
    """LLRs of the all-zero codeword over BPSK + AWGN (f32 [B, n])."""
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def toy():
    """(JAX graph, port graph, llr [B, n]) of the toy xor code; frame 0 is
    noiseless, so track mode freezes a frame before its first sweep."""
    Z = 16
    base = np.random.default_rng(3).integers(0, Z, size=(4, 8)).astype(
        np.int32)
    jspec = jax_expand_qc_xor(JaxQCXorCode(Z=Z, base=base), name="toyxor16")
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toyxor16")
    llr = _awgn_llr(spec.n, B, 2.0, 0.5, np.random.default_rng(7))
    llr[0] = 2.0
    return jax_compile_qc_graph(jspec), compile_qc_graph(spec), llr


@pytest.fixture(scope="module")
def an():
    """(JAX graph, port graph, port spec) of 8023an."""
    spec = get_code("8023an")
    return (jax_compile_qc_graph(jax_get_code("8023an")),
            compile_qc_graph(spec), spec)


def _jax_run(fn, jg, llr, monkeypatch, **kw):
    """(DecodeResult, posteriors f32 [B, n]) of a JAX oracle decode, the
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
            res = fn(jg, jnp.asarray(llr), **kw)
    else:
        res = fn(jg, jnp.asarray(llr), **kw)
    total = np.asarray(seen["total"])
    return res, total.reshape(jg.nb * jg.Z, -1).T


def _same(want, got, post=None, wpost=None):
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())
    if post is not None:
        assert np.array_equal(post.numpy().view(np.int32),
                              wpost.view(np.int32))


def _port(schedule):
    return (plain_with_posteriors if schedule == "layered"
            else flooding_qc_with_posteriors_plain)


def _oracle(schedule):
    if schedule == "layered":
        return jax_layered.decode_layered
    return lambda g, x, **kw: jax_fqc.decode_flooding_qc(g, x, kind="minsum",
                                                         **kw)


MINSUM_CASES = [  # (name, alpha/beta, track mode)
    ("fixed", dict(alpha=0.8125), False),
    ("track", dict(alpha=0.8125), True),
    ("offset_track", dict(alpha=0.8125, beta=0.15), True),
]


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("name,ab,track", MINSUM_CASES,
                         ids=[c[0] for c in MINSUM_CASES])
def test_toy_minsum_matches_oracle(toy, schedule, name, ab, track,
                                   monkeypatch):
    jg, g, llr = toy
    want, wpost = _jax_run(_oracle(schedule), jg, llr, monkeypatch,
                           max_iters=T, early_term=track, **ab)
    got, post = _port(schedule)(g, torch.from_numpy(llr), max_iters=T,
                                early_term=track, **ab)
    _same(want, got, post, wpost)
    ok = got.ok.numpy()
    assert 0 < ok.sum() < len(ok)  # some frames decode, some do not
    if track:
        its = got.iterations.numpy()
        assert its[0] == 0 and 0 < its[1:].min() < T


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("track", [False, True], ids=["fixed", "track"])
def test_toy_minsum_matches_pallas_interpret(toy, schedule, track):
    """K4 in interpret mode (f32, HIGHEST: an exact selection) in both of
    its modes: bits, ok and iterations identical."""
    jg, g, llr = toy
    want = make_layered_xor_decoder(
        jg, alpha=0.8125, max_iters=T, early_term=track, batch_tile=B,
        interpret=True, schedule=schedule)(jnp.asarray(llr))
    if schedule == "layered":
        got = layered_decode_plain(g, torch.from_numpy(llr), alpha=0.8125,
                                   max_iters=T, early_term=track)
    else:
        got, _ = flooding_qc_with_posteriors_plain(
            g, torch.from_numpy(llr), alpha=0.8125, max_iters=T,
            early_term=track)
    _same(want, got)


def test_toy_schedule_matches_oracle(toy, monkeypatch):
    """Per-iteration alpha/beta on a xor graph (the JAX package's Pallas
    K4 refuses them; its XLA tier and the port take them)."""
    jg, g, llr = toy
    want, wpost = _jax_run(jax_layered.decode_layered, jg, llr, monkeypatch,
                           max_iters=T, early_term=True, **SCHED)
    got, post = plain_with_posteriors(g, torch.from_numpy(llr), max_iters=T,
                                      early_term=True, **SCHED)
    _same(want, got, post, wpost)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("cn", ["spa", "minstar"])
@pytest.mark.parametrize("track", [False, True], ids=["fixed", "track"])
def test_toy_exact_rules_match_oracle(toy, schedule, cn, track,
                                      monkeypatch):
    jg, g, llr = toy
    if schedule == "layered":
        def fn(G, x, **kw):
            return jax_layered.decode_layered(G, x, cn=cn, **kw)

        def port(G, x, **kw):
            return plain_with_posteriors(G, x, cn=cn, **kw)
    else:
        def fn(G, x, **kw):
            return jax_fqc.decode_flooding_qc(G, x, kind=cn, **kw)

        def port(G, x, **kw):
            return flooding_qc_with_posteriors_plain(G, x, kind=cn, **kw)
    want, _ = _jax_run(fn, jg, llr, monkeypatch, max_iters=T,
                       early_term=track)
    got, _ = port(g, torch.from_numpy(llr), max_iters=T, early_term=track)
    _same(want, got)
    assert 0 < int(got.ok.sum()) < B
    if not track:
        one = dict(max_iters=1, early_term=False)
        _, wpost = _jax_run(fn, jg, llr, monkeypatch, **one)
        _, post = port(g, torch.from_numpy(llr), **one)
        np.testing.assert_allclose(post.numpy(), wpost, atol=ATOL, rtol=RTOL)


def test_xor_index_and_tables(toy):
    """var_index and check_index: inverses for both perms, and each its
    own inverse for xor; the plain tables read z ^ s on a xor graph."""
    _, g, _ = toy
    Z = g.Z
    z = np.arange(Z)
    for s in range(Z):
        for perm in ("roll", "xor"):
            v = var_index(z, s, Z, perm)
            assert sorted(v) == list(z)
            assert np.array_equal(check_index(v, s, Z, perm), z)
        assert np.array_equal(var_index(var_index(z, s, Z, "xor"), s, Z,
                                        "xor"), z)
        assert np.array_equal(check_index(z, s, Z, "xor"),
                              var_index(z, s, Z, "xor"))
    for L, (idx, _, d) in zip(g.layer_order, _plain_layers(g, "cpu")):
        want = np.concatenate([c * Z + (z ^ s) for _, c, s in
                               g.layer_edges(L)])
        assert np.array_equal(idx.numpy(), want)
    groups, gathers = _plain_tables(g, "cpu")
    assert sum(len(vidx) // (d * Z) for d, _, vidx in groups) == g.mb
    # every message reaches the variable its check read
    for idx, has in gathers:
        e, zc = np.divmod(idx.numpy(), Z)
        col = np.repeat(np.arange(g.nb), Z)
        zv = np.tile(z, g.nb)
        live = has.numpy().ravel()
        assert np.array_equal(g.be_col[e[live]], col[live])
        assert np.array_equal(zc[live] ^ g.be_shift[e[live]], zv[live])


def test_xor_graph_with_repeated_column_is_refused():
    """A xor graph whose layer repeats a block-column decodes in the
    accumulate form (tests/test_torch_multi_edge.py holds it against the
    JAX oracle); it is refused where the JAX package refuses it on
    meaning: the TPU's xor kernel's bf16 permutations (dup-free graphs
    only) and the Z-sharded graph-parallel tier (circulant blocks only)."""
    from ecc_ldpc_tpu_torch.dist.graph_parallel import (
        make_qc_graph_parallel_decoder,
    )

    g = qc_graph_from_block_edges(8, 2, 3, [0, 0, 1, 1], [0, 0, 1, 2],
                                  [1, 2, 0, 3], k=8, perm="xor")
    assert not g.intra_layer_dup_free
    x = torch.zeros((2, g.n))
    res = make_layered_decoder(g, max_iters=2, device="cpu")(x)
    assert res.bits.shape == (2, g.n) and bool(res.ok.all())
    with pytest.raises(ValueError, match="repeat no block-column"):
        make_layered_decoder(g, max_iters=2, device="cpu",
                             perm_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="circulant blocks"):
        make_qc_graph_parallel_decoder(g, kind="minsum", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        layered_classic_cuda(g, x, max_iters=2)
    # flooding has no such limit
    dec = make_decoder(g, "minsum", max_iters=2, device="cpu")
    assert dec(x).bits.shape == (2, g.n)


@pytest.mark.parametrize("track", [False, True], ids=["fixed", "track"])
def test_8023an_layered_and_flooding_match_oracle(an, track, monkeypatch):
    """Full size: 16 noisy frames, fixed iterations or track mode, each
    schedule."""
    jg, g, spec = an
    llr = _awgn_llr(spec.n, 16, 3.3, spec.rate, np.random.default_rng(41))
    for schedule in ("layered", "flooding"):
        want, wpost = _jax_run(_oracle(schedule), jg, llr, monkeypatch,
                               alpha=0.8125, max_iters=8, early_term=track)
        got, post = _port(schedule)(g, torch.from_numpy(llr), alpha=0.8125,
                                    max_iters=8, early_term=track)
        _same(want, got, post, wpost)
        assert 0 < int(got.ok.sum()) < 16
        if track:
            assert int(got.iterations.min()) < 8


def test_8023an_noiseless_decodes_in_zero_iterations(an):
    _, g, spec = an
    llr = torch.full((4, spec.n), 3.0)
    for spec_str in ("layered/norm:0.8125/25", "minsum/norm:0.8125/25",
                     "layered/spa/25", "spa/25"):
        res = get_decoder(g, spec_str, device="cpu")(llr)
        assert bool(res.ok.all()) and int(res.iterations.max()) == 0
        assert not res.bits.any()


def test_8023an_slice_matches_jax(an):
    """The production retry decoder end to end on the CPU: the port's
    get_decoder against the JAX package's on the same LLRs."""
    jg, g, spec = an
    llr = _awgn_llr(spec.n, 16, 3.4, spec.rate, np.random.default_rng(43))
    prod = "layered/norm:0.8125/25;retry=layered/spa/25"
    got = get_decoder(g, prod, device="cpu")(torch.from_numpy(llr))
    want = jax_get_decoder(jg, prod)(jnp.asarray(llr))
    _same(want, got)
    primary = get_decoder(g, prod.split(";retry=")[0], device="cpu")(
        torch.from_numpy(llr))
    # the fallback got frames, and rescued some
    assert not bool(primary.ok.all())
    assert int(got.ok.sum()) > int(primary.ok.sum())
    assert int(got.iterations.max()) > 25


def test_8023an_cli_sweep_on_the_cpu(tmp_path):
    out = tmp_path / "8023an.json"
    rc = cli_main(["sweep", "--code", "8023an", "--decoder",
                   "layered/norm:0.8125/10;retry=layered/spa/10",
                   "--ebn0", "3,4", "--batch", "8", "--max-frames", "16",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    pts = json.loads(out.read_text())
    assert [p["ebn0_db"] for p in pts] == [3.0, 4.0]
    assert all(p["frames"] == 16 and p["code"] == "8023an" for p in pts)


def test_cuda_paths_refuse_the_cpu(toy):
    """No card and no device="cpu": the decoders raise, and no counter
    moves; the kernel wrappers refuse CPU tensors."""
    _, g, llr = toy
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py drives the kernels")
    counters = (layered_decode_cuda.launches_by_perm,
                layered_exact_cuda.launches_by_perm,
                flooding_qc_decode_cuda.launches_by_perm)
    before = [dict(c) for c in counters]
    with pytest.raises(RuntimeError):
        make_decoder(g, "layered", alpha=0.8125, max_iters=2)
    with pytest.raises(RuntimeError):
        get_decoder(g, "minsum/norm:0.8125/2")
    x = torch.from_numpy(llr)
    with pytest.raises(ValueError, match="CUDA tensor"):
        layered_decode_cuda(g, x, max_iters=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        layered_exact_cuda(g, x, max_iters=2, cn="spa")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flooding_qc_decode_cuda(g, x, max_iters=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        layered_classic_cuda(g, x, max_iters=2)
    assert [dict(c) for c in counters] == before


def test_xor_legs_and_bound():
    """The two K4 legs of bench.XOR_LEGS (JAX bench/families.py:29 and its
    flooding twin) and their bounds: operations, 12 (layered) and 14
    (flooding) per edge visit."""
    assert XOR_LEGS["layered"] == dict(
        code="8023an", decoder="layered/norm:0.8125/25/noet", batch=2048,
        ebn0_db=4.0)
    assert XOR_LEGS["flooding"] == dict(
        XOR_LEGS["layered"], decoder="minsum/norm:0.8125/25/noet")
    for leg, ops in (("layered", 12), ("flooding", 14)):
        kw = parse_decoder_spec(XOR_LEGS[leg]["decoder"])
        assert kw["early_term"] is False and kw["max_iters"] == 25
        s, form = decode_bound(2048, 12288, 2048, 2048 * 25, "minsum", 384,
                               leg)
        assert form == "operations"
        assert abs(s - ops * 12288 * 25 * 2048 / 67e12) < 1e-12


def test_kernel_signatures_match_wrappers():
    """Each kernel library's C entry point takes what its ctypes wrapper
    passes, the xor_perm flag included (a mismatch would only show on the
    card)."""
    import ctypes
    import re

    from ecc_ldpc_tpu_torch import _build
    from ecc_ldpc_tpu_torch.decode import flooding_qc, layered_qc

    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    for src, entry, args in (
            ("layered_qc", "layered_qc_decode", layered_qc._QC_ARGS),
            ("layered_exact", "layered_exact_decode", layered_qc._EXACT_ARGS),
            ("layered_classic", "layered_classic_decode",
             layered_qc._CLASSIC_ARGS),
            ("flooding_qc", "flooding_qc_decode", flooding_qc._ARGS)):
        text = (_build.CSRC / f"{src}.cu").read_text()
        params = re.search(rf"int {entry}\(([^)]*)\)", text).group(1)
        types = [re.sub(r"\s+", "", p.rsplit(None, 1)[0])
                 for p in params.split(",")]
        assert [ctype[t] for t in types] == list(args), src
        if src != "layered_classic":
            assert "int xor_perm" in params and '#include "qc_index.cuh"' in text
