"""Rows wider than 64 slots on the CPU: sc/2/80/6/32 (row degree 80)
decodes through the port's plain layered version bit-identical to the JAX
XLA layered oracle in f32 min-sum (bits, ok, iterations), and with the
same decisions for spa and minstar (their messages within ulps); the
tile plans of the wide builds; a CPU emulation of K1a's wide build
(csrc/layered_qc.cu MinsumWide: the row read twice from the posteriors,
its check state 3 + ceil(d/32) words) against the plain version bit for
bit; and the wide check rules of csrc/bp_rules.cuh (the row walked in
memory, minstar's prefixes in a scratch row) against the plain rules.
On the card the wide builds of K1a, K1c, K3 and K2 take these rows
(chip_smoke.py phase 30)."""
import jax
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu_torch.codes import get_code
from ecc_ldpc_tpu_torch.decode import flooding as fl
from ecc_ldpc_tpu_torch.decode import layered_qc as lq
from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder
from ecc_ldpc_tpu_torch.graph.compile import compile_graph
from test_torch_families import assert_layered_matches_jax, decode_case

torch.set_num_threads(1)

CODE = "sc/2/80/6/32"
EBN0 = 6.0  # some of the frames stop early, some never
T = 10
ATOL, RTOL = 1e-3, 1e-4  # spa/minstar messages: CPU transcendentals


@pytest.fixture(scope="module")
def wide():
    return decode_case(CODE, EBN0)


@pytest.mark.parametrize("cn", ["minsum", "spa", "minstar"])
def test_plain_layered_matches_jax(wide, cn):
    """layered/norm:0.8125/10, layered/spa/10 and layered/minstar/10 in
    track mode: bits, ok and iterations identical. The oracle runs eagerly:
    XLA:CPU compiles its 80-slot box-plus scans for minutes."""
    g, jg, llr = wide
    assert g.dcb_max == jg.dcb_max == 80 and g.intra_layer_dup_free
    with jax.disable_jit():
        got = assert_layered_matches_jax(g, jg, llr, cn, max_iters=T)
    assert bool(got.ok.any()) or cn != "minsum"


def test_wide_plans():
    """K1a and K1c plan their wide builds at degree 80 and 96, K3 its wide
    build, K2 its wide build one frame an item; the classic form refuses."""
    for code, d in (("sc/2/80/6/32", 80), ("sc/3/96/10/64", 96)):
        spec = get_code(code)
        g = choose_graph(spec, "layered/norm:0.8125/25")
        assert g.dcb_max == d
        for B in (13, 4096):
            ms = lq.tile_plan(g, B, "minsum")
            assert ms.stride % 4 == 0
            assert ms.stride >= lq.min_sum_words(d) * ms.rows * ms.frames
            ex = lq.tile_plan(g, B, "spa")
            assert ex.stride >= d * ex.rows * ex.frames
            fq = lq.tile_plan(g, B, form="flooding")
            assert fq.threads <= 512
        plan = fl.flooding_plan(compile_graph(spec), 4096, "minstar")
        assert (plan.width, plan.lanes) == (d, 1)
        with pytest.raises(ValueError, match=f"row degree {d} .*Queue 3"):
            lq.tile_plan(g, 8, form="classic")


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint32)


def _float(u: np.ndarray) -> np.ndarray:
    return u.astype(np.uint32).view(np.float32)


def emulate_k1a_wide(graph, llr: np.ndarray, alpha: float, max_iters: int,
                     early_term: bool):
    """csrc/layered_qc.cu's wide build (MinsumWide through
    cluster_tile.cuh's decode_tiles) on the CPU, every (check, frame) of a
    layer at once and each row walked slot by slot in f32: pass 1 the
    extrinsic inputs against the old record, pass 2 the same inputs formed
    again, the messages and the posteriors, the new record 3 + ceil(d/32)
    words. Returns (bits, ok, iterations, posteriors [B, n])."""
    Z, B = graph.Z, llr.shape[0]
    a = np.float32(alpha)
    cap = np.float32(1e12)
    post = llr.astype(np.float32).T.copy()  # [n, B]
    layers = lq._plain_layers(graph, "cpu")
    words = lq.min_sum_words(graph.dcb_max)
    state = [np.zeros((words, Z, B), np.uint32) for _ in layers]
    sign = np.uint32(1 << 31)

    def syndrome_fail(p):
        fail = np.zeros(B, bool)
        for idx, _, d in layers:
            par = (p[idx.numpy()] < 0).reshape(d, Z, B).sum(0) % 2
            fail |= (par != 0).any(0)
        return fail

    done = ~syndrome_fail(post) if early_term else np.zeros(B, bool)
    used = np.zeros(B, np.int32)
    for t in range(max_iters):
        if early_term and done.all():
            break
        flag = np.zeros(B, bool)
        for L, (idx, _, d) in enumerate(layers):
            at = idx.numpy().reshape(d, Z)
            old = state[L]
            old1, old2, oldslot = old[0], old[1], old[2].astype(np.int64)

            def cold(j):
                w = old[3 + (j >> 5)]
                bit = (w >> np.uint32(j & 31)) & np.uint32(1)
                mag = np.where(oldslot == j, old2, old1)
                return _float(mag | (bit << np.uint32(31)))

            live = ~done if early_term else np.ones(B, bool)
            min1 = np.full((Z, B), np.inf, np.float32)
            min2 = np.full((Z, B), np.inf, np.float32)
            sg = np.zeros((Z, B), np.uint32)
            par = np.zeros((Z, B), bool)
            for j in range(d):
                r = post[at[j]]
                par ^= r < 0
                x = (r - cold(j)).astype(np.float32)
                ax = np.abs(x)
                min2 = np.minimum(min2, np.maximum(min1, ax))
                min1 = np.minimum(min1, ax)
                sg ^= _bits(x)
            mag1 = np.maximum(a * np.minimum(min1, cap) - np.float32(0), 0)
            mag2 = np.maximum(a * np.minimum(min2, cap) - np.float32(0), 0)
            mag1, mag2 = mag1.astype(np.float32), mag2.astype(np.float32)
            new = np.zeros_like(old)
            slot = np.full((Z, B), -1, np.int64)
            flip = np.zeros((Z, B), bool)
            for j in range(d):
                r = post[at[j]]
                x = (r - cold(j)).astype(np.float32)
                is_min = np.abs(x) == min1
                slot = np.where(is_min & (slot < 0), j, slot)
                neg = (sg ^ _bits(x)) & sign
                new[3 + (j >> 5)] |= (neg >> np.uint32(31)) << np.uint32(j & 31)
                cn = _float(_bits(np.where(is_min, mag2, mag1)) | neg)
                y = (x + cn).astype(np.float32)
                flip |= (_bits(y) ^ _bits(r)) >> np.uint32(31) != 0
                post[at[j]] = np.where(live, y, r)
            new[0], new[1] = _bits(mag1), _bits(mag2)
            new[2] = slot.astype(np.uint32)
            state[L] = np.where(live, new, old)
            flag |= ((par | flip) & live).any(0)
        if early_term:
            used += (~done).astype(np.int32)
            done = done | ~flag
    ok = ~syndrome_fail(post)
    iters = used if early_term else np.full(B, max_iters, np.int32)
    return (post < 0).T.astype(np.uint8), ok, iters, post.T


@pytest.mark.parametrize("early_term", [True, False])
def test_k1a_wide_emulation_matches_plain(wide, early_term):
    g, _, llr = wide
    bits, ok, iters, post = emulate_k1a_wide(g, llr, 0.8125, T, early_term)
    want, wpost = lq.plain_with_posteriors(
        g, torch.from_numpy(llr), alpha=0.8125, max_iters=T,
        early_term=early_term)
    assert np.array_equal(bits, want.bits.numpy())
    assert np.array_equal(ok, want.ok.numpy())
    assert np.array_equal(iters, want.iterations.numpy())
    assert np.array_equal(post.view(np.int32),
                          wpost.contiguous().numpy().view(np.int32))


def wide_rule(kind: str, V: torch.Tensor, alpha=0.8125, beta=0.0):
    """csrc/bp_rules.cuh's wide rules on V [d, N] (one row a column, in
    memory): slot by slot in f32, minsum and spa reading each slot twice
    (spa recomputing log|tanh|), minstar keeping its forward prefixes in a
    scratch row; the messages in place."""
    v = V.clone()
    d = v.shape[0]
    lth = lambda x: torch.log(torch.tanh(x.abs().clamp(1e-10, 40.0) * 0.5))
    if kind == "minsum":
        neg = torch.zeros(v.shape[1], dtype=torch.bool)
        m1 = torch.full((v.shape[1],), float("inf"))
        m2 = m1.clone()
        for j in range(d):
            a = v[j].abs()
            neg ^= v[j] < 0
            m2 = torch.where(a < m1, m1, torch.where(a < m2, a, m2))
            m1 = torch.where(a < m1, a, m1)
        sp = torch.where(neg, -1.0, 1.0)
        for j in range(d):
            x = v[j]
            mag = torch.where(x.abs() == m1, m2, m1).clamp_max(1e12)
            mag = (alpha * mag - beta).clamp_min(0.0)
            v[j] = sp * torch.where(x < 0, -1.0, 1.0) * mag
        return v
    if kind == "spa":
        acc = lth(v[0])
        neg = v[0] < 0
        for j in range(1, d):
            acc = acc + lth(v[j])
            neg ^= v[j] < 0
        sp = torch.where(neg, -1.0, 1.0)
        for j in range(d):
            x = v[j]
            t = torch.exp(acc - lth(x)).clamp_max(1.0 - 1e-7)
            v[j] = sp * torch.where(x < 0, -1.0, 1.0) * 2.0 * torch.atanh(t)
        return v
    w = torch.empty_like(v)  # the scratch row
    w[0] = v[0]
    for j in range(1, d - 1):
        w[j] = lq._boxplus(w[j - 1], v[j])
    bwd = torch.zeros_like(v[0])
    for j in range(d - 1, -1, -1):
        x = v[j].clone()
        out = w[j - 1] if j == d - 1 else (
            bwd if j == 0 else lq._boxplus(w[j - 1], bwd))
        if j == d - 1:
            bwd = x
        elif j > 0:
            bwd = lq._boxplus(bwd, x)
        v[j] = out.clamp(-1e12, 1e12)
    return v


@pytest.mark.parametrize("kind", ["minsum", "spa", "minstar"])
@pytest.mark.parametrize("d", [65, 80, 96])
def test_wide_rules_match_plain(kind, d):
    from ecc_ldpc_tpu_torch.decode.cn_ops import get_rule

    g = torch.Generator().manual_seed(d)
    V = torch.randn((d, 40), generator=g) * 3.0
    V[3, :5] = 0.0  # zero inputs and a tied minimum
    V[7, 5:10] = V[9, 5:10]
    got = wide_rule(kind, V)
    want = get_rule(kind, 0.8125, 0.0)(
        V.t().unsqueeze(-1), torch.ones((40, d, 1), dtype=torch.bool), 1)
    want = want.squeeze(-1).t()
    if kind == "minsum":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dec", ["layered/norm:0.8125/10/noet",
                                 "minsum/norm:0.8125/10", "spa/10",
                                 "minstar/10"])
def test_decoders_take_degree_80_on_the_cpu(wide, dec, tmp_path):
    """The decoders built from spec strings, layered and QC flooding, and
    (K2's plain version) flooding on a mat: load of the same H."""
    from ecc_ldpc_tpu_torch.codes.matrixio import dumps_matlab_sparse

    _, _, llr = wide
    x = torch.from_numpy(llr)
    spec = get_code(CODE)
    ref = get_decoder(choose_graph(spec, "layered/norm:0.8125/25"),
                      "layered/norm:0.8125/25", device="cpu")(x)
    res = get_decoder(choose_graph(spec, dec), dec, device="cpu")(x)
    path = tmp_path / "h.mat"
    path.write_text(dumps_matlab_sparse(spec))
    mat = get_code(f"mat:{path}")
    flat = "minsum/norm:0.8125/10" if dec.startswith("layered") else dec
    res2 = get_decoder(choose_graph(mat, flat), flat, device="cpu")(x)
    for r in (res, res2):
        ok = ref.ok.numpy() & r.ok.numpy()
        assert np.array_equal(r.bits.numpy()[ok], ref.bits.numpy()[ok])
    assert bool(ref.ok.any())
