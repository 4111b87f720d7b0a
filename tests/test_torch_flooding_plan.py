"""K2's plan and tile walk (decode/flooding.flooding_plan, csrc/flooding.cu)
on the CPU.

- The plan: F, threads and dynamic shared bytes (within a block's 232,448 B
  beside the static arrays), tiles x F >= B with no empty tile, at
  mackay1008 and ragged batches (13, 601, 2048); the form "global" exactly
  where one frame's posteriors and messages stop fitting a block.
- The kernel's tables: the slot-major message rows (slot j of check i at
  row j * m + i) that each variable slot names.
- A CPU emulation of the kernel's tile walk (emulate below: tiles of the
  plan's F, per-frame freeze on the parity the CN phase takes of the stale
  posteriors, the VN phase skipped for frames that passed, messages of
  frames not advancing overwritten, dead lanes of a ragged tile filled
  with NaN and never read) against
  flooding_decode_plain and against the JAX oracle (decode_flooding at
  f32, and the fused Pallas kernel in interpret mode): frames of one tile
  stopping at different iterations, a ragged last tile, -0.0 inputs and
  tied minima. Tolerances as in tests/test_torch_flooding.py: min-sum bit
  for bit; spa and minstar decisions equal and posteriors within atol
  1e-3 / rtol 1e-4: after one iteration against the JAX oracle (XLA:CPU's
  transcendentals are not PyTorch's bit for bit), and at the end against
  the plain version (PyTorch's CPU transcendentals round a value one ulp
  apart in tensors of another shape).
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
from ecc_ldpc_tpu_torch.bench.flooding_probe import regular_graph
from ecc_ldpc_tpu_torch.convert import compiled_graph_from_numpy
from ecc_ldpc_tpu_torch.decode import flooding as fl
from ecc_ldpc_tpu_torch.decode.cn_ops import get_rule
from ecc_ldpc_tpu_torch.graph.compile import CompiledGraph

torch.set_num_threads(1)

ROOM = 232_448 - 2304  # a block's shared memory less the static arrays
ATOL, RTOL = 1e-3, 1e-4
KW = {"minsum": dict(alpha=0.8125, beta=0.0), "spa": {}, "minstar": {}}


def _port_graph(jg):
    return compiled_graph_from_numpy(
        jg.n, jg.m, jg.k, np.asarray(jg.cn_vn), np.asarray(jg.cn_mask),
        np.asarray(jg.vn_edge), np.asarray(jg.vn_mask), jg.name)


def _shape_graph(n, m, dc):
    """A CompiledGraph with the given sizes (the plan reads nothing else)."""
    return CompiledGraph(n=n, m=m, k=n - m, num_edges=m * dc, dc_max=dc,
                         dv_max=1, name=f"shape_{n}_{m}_{dc}",
                         cn_vn=np.zeros((m, dc), np.int32),
                         cn_mask=np.ones((m, dc), bool),
                         vn_edge=np.zeros((n, 1), np.int32),
                         vn_mask=np.ones((n, 1), bool))


@pytest.fixture(scope="module")
def mackay():
    """(JAX graph, port graph, llr f32 [16, 1008]) at 1.8 dB: frame 0
    noiseless (done before any sweep), the others stopping at different
    iterations or not at all; frames 12-15 with -0.0 and tied magnitudes
    (LLRs rounded to multiples of 0.5, every tenth a signed zero)."""
    spec = mackay_1008()
    jg = jax_compile_graph(spec)
    enc = JaxDenseEncoder.build(spec)
    rng = np.random.default_rng(11)
    msg = rng.integers(0, 2, (16, spec.k), dtype=np.uint8)
    cw = np.asarray(enc(jnp.asarray(msg)))
    sigma = (2.0 * spec.rate * 10.0 ** (1.8 / 10.0)) ** -0.5
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    llr[0] = 4.0 * (1.0 - 2.0 * cw[0])
    q = np.round(llr[12:] * 2.0) / 2.0
    q[:, ::10] = np.where(cw[12:, ::10] == 1, -0.0, 0.0)
    llr[12:] = q.astype(np.float32)
    return jg, _port_graph(jg), llr


def test_plan_of_the_mackay_leg():
    g = _port_graph(jax_compile_graph(mackay_1008()))
    p = fl.flooding_plan(g, 2048, "minsum", 132)
    # two even waves of 8 frames an SM, the LLRs on chip beside the state
    assert (p.form, p.frames, p.tiles, p.threads, p.llr_chip) == \
        ("chip", 8, 256, 1024, True)
    assert p.words == 2 * 1008 + 504 * 6
    assert p.smem == 4 * p.words * 8 == 161_280
    assert p.lanes == 2  # two frames a thread's item
    # at most CHIP_FRAMES a tile, and F even where it can be
    p = fl.flooding_plan(g, 4096, "minsum", 132)
    assert (p.frames, p.tiles, p.lanes) == (8, 512, 2)
    p = fl.flooding_plan(g, 601, "minsum", 132)
    assert (p.frames, p.tiles, p.lanes) == (6, 101, 2)
    # track mode: tiles of at most TRACK_FRAMES, so slow frames spread
    p = fl.flooding_plan(g, 4096, "spa", 132, track=True)
    assert (p.frames, p.tiles) == (2, 2048) and fl.TRACK_FRAMES == 2
    assert fl.flooding_plan(g, 13, "spa", 132, track=True).lanes == 1


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("B", [1, 13, 601, 2048, 4096])
def test_plans_fit_and_cover_the_batch(B, track):
    g = _port_graph(jax_compile_graph(mackay_1008()))
    p = fl.flooding_plan(g, B, "minstar", 132, track)
    assert p.form == "chip" and 1 <= p.frames <= 64
    assert p.tiles * p.frames >= B and (p.tiles - 1) * p.frames < B
    assert p.smem == 16 * -(-p.words * p.frames // 4) and p.smem <= ROOM
    assert p.words == g.n * (2 if p.llr_chip else 1) + g.m * g.dc_max
    assert p.threads % 32 == 0 and p.frames <= p.threads <= 1024
    # F fills the fewest waves that the largest tile allows (at most
    # CHIP_FRAMES, in track mode TRACK_FRAMES), so tiles spread evenly
    # over the SMs, and is even where it can be
    most = fl.TRACK_FRAMES if track else fl.CHIP_FRAMES
    waves = -(-B // (p.blocks * most))
    F = -(-B // (p.blocks * waves))
    assert p.frames == F + (F > 1 and F % 2) <= most
    assert p.lanes == (2 if p.frames % 2 == 0 else 1)
    if B in (601, 13) and track:
        assert (B % p.frames != 0) == (B == 601)  # 601: a ragged last tile
        assert p.frames == (2 if B == 601 else 1)


def test_global_form_exactly_where_a_frame_stops_fitting():
    # one frame's posteriors and messages: n + m * dc words
    words = ROOM // 4
    fits = fl.flooding_plan(_shape_graph(words - 6 * 8000, 8000, 6), 64)
    over = fl.flooding_plan(_shape_graph(words - 6 * 8000 + 1, 8000, 6), 64)
    assert (fits.form, fits.frames, fits.llr_chip, fits.smem) == \
        ("chip", 1, False, ROOM)
    assert (over.form, over.smem, over.llr_chip) == ("global", 0, False)
    assert over.words == words + 1 and over.tiles * over.frames >= 64
    big = fl.flooding_plan(regular_graph(16384), 4096, "spa", 132)
    assert (big.form, big.frames, big.tiles) == ("global", 8, 512)
    big = fl.flooding_plan(regular_graph(16384), 4096, "spa", 132, True)
    assert (big.form, big.frames) == ("global", 2)
    assert fl.flooding_plan(regular_graph(16384), 32, track=True).frames == 1


def test_plan_refuses():
    g = _port_graph(jax_compile_graph(mackay_1008()))
    with pytest.raises(KeyError, match="kind"):
        fl.flooding_plan(g, 8, "bp")
    with pytest.raises(ValueError, match="batch"):
        fl.flooding_plan(g, 0)
    with pytest.raises(ValueError, match="row degree 33"):
        fl.flooding_plan(_shape_graph(64, 8, 33), 8)
    with pytest.raises(ValueError, match="do not fit"):
        fl.flooding_plan(g, 2048, frames=20)


def test_kernel_tables_are_slot_major():
    g = _port_graph(jax_compile_graph(mackay_1008()))
    cn, vn = (t.numpy() for t in fl._kernel_tables(g, "cpu"))
    m, dc = g.m, g.dc_max
    for i in (0, 17, m - 1):
        for j in range(dc):
            want = g.cn_vn[i, j] if g.cn_mask[i, j] else -1
            assert cn[j * m + i] == want
    # variable u's k-th message row holds the edge its vn_edge names
    vn = vn.reshape(g.n, g.dv_max)
    for u in (0, 5, g.n - 1):
        for k in range(g.dv_max):
            e = g.vn_edge[u, k]
            assert vn[u, k] == (e % dc) * m + e // dc
            i, j = divmod(int(e), dc)
            assert cn[j * m + i] == u


def emulate(graph, llr: torch.Tensor, kind: str, alpha=1.0, beta=0.0,
            max_iters: int = 25, early_term: bool = True, frames: int = 0):
    """csrc/flooding.cu's walk of the plan's tiles on the CPU, with the
    tables the wrapper gives it: returns (bits, ok, iterations,
    posteriors) like flooding_with_posteriors_plain."""
    B, n = llr.shape
    m, dc, dv = graph.m, graph.dc_max, graph.dv_max
    plan = fl.flooding_plan(graph, B, kind, 132, early_term, frames)
    cn, vn = fl._kernel_tables(graph, "cpu")
    cn, vn = cn.view(dc, m).long(), vn.view(n, dv).long()
    real = (cn >= 0).unsqueeze(-1)             # [dc, m, 1]
    mask3 = real.permute(1, 0, 2)              # [m, dc, 1]: the rule's view
    rule = get_rule(kind, float(alpha), float(beta))
    F = plan.frames
    bits = torch.empty((B, n), dtype=torch.uint8)
    post_out = torch.empty((B, n))
    ok = torch.empty(B, dtype=torch.bool)
    iters = torch.empty(B, dtype=torch.int32)
    for tile in reversed(range(plan.tiles)):  # any order the counter gives
        b0 = tile * F
        nf = min(F, B - b0)
        live = torch.arange(F) < nf
        post = torch.full((n, F), float("nan"))  # a dead lane's garbage
        post[:, :nf] = llr[b0:b0 + nf].t()
        L = post.clone()                          # the on-chip LLRs
        C = torch.full((dc, m, F), float("nan"))  # unwritten before t = 0
        done = ~live
        used = torch.zeros(F, dtype=torch.int32)
        for t in range(max_iters):
            if early_term and bool(done.all()):
                break
            active = live & ~done
            r = post[cn.clamp(min=0)]             # [dc, m, F] stale
            par = (((r < 0) & real).sum(0) % 2 != 0).any(0)  # [F]
            v = r - (torch.zeros_like(r) if t == 0 else C)
            new = rule(v.permute(1, 0, 2), mask3, 1).permute(1, 0, 2)
            # a frame not advancing may get its extrinsics stored (the
            # kernel's item of two frames does): never read again
            C = torch.where(real, torch.where(active, new, v), C)
            adv = active & par if early_term else active
            s = torch.zeros((n, F))
            for k in range(dv):
                has = (vn[:, k] >= 0).unsqueeze(-1)
                row = vn[:, k].clamp(min=0)
                s = s + torch.where(has, C.view(dc * m, F)[row], 0.0)
            post = torch.where(adv, L + s, post)
            if early_term:
                used += adv.to(torch.int32)
                done = done | (active & ~par)
        r = post[cn.clamp(min=0)]
        fail = (((r < 0) & real).sum(0) % 2 != 0).any(0)
        sl = slice(b0, b0 + nf)
        ok[sl] = ~fail[:nf]
        iters[sl] = used[:nf] if early_term else max_iters
        bits[sl] = (post[:, :nf] < 0).t().to(torch.uint8)
        post_out[sl] = post[:, :nf].t()
    return bits, ok, iters, post_out


def _same_decisions(got, want):
    assert torch.equal(got[0], want.bits)
    assert torch.equal(got[1], want.ok)
    assert torch.equal(got[2], want.iterations)


@pytest.mark.parametrize("kind", ["minsum", "spa", "minstar"])
@pytest.mark.parametrize("mode,frames", [("track", 4), ("track", 5),
                                         ("fixed", 3), ("track", 0)])
def test_tile_walk_matches_plain(mackay, kind, mode, frames):
    """F = 4: four tiles of 4 frames whose frames stop at different
    iterations; F = 5 and 3: a ragged last tile (16 = 3 x 5 + 1, 5 x 3 + 1);
    F = 0: the plan's own (one frame a tile)."""
    _, g, llr = mackay
    x = torch.from_numpy(llr)
    et = mode == "track"
    got = emulate(g, x, kind, max_iters=12, early_term=et, frames=frames,
                  **KW[kind])
    want, post = fl.flooding_with_posteriors_plain(
        g, x, kind=kind, max_iters=12, early_term=et, **KW[kind])
    _same_decisions(got, want)
    if kind == "minsum":
        assert torch.equal(got[3].view(torch.int32), post.view(torch.int32))
    else:
        # PyTorch's CPU transcendentals take a vectorised path on whole
        # vectors and a scalar one on a tensor's tail, so a value at another
        # position of a tensor of another shape may round one ulp apart
        torch.testing.assert_close(got[3], post, atol=ATOL, rtol=RTOL)
    if et:
        it = got[2].numpy()
        assert it[0] == 0 and len(set(it[:4].tolist())) > 1
        assert 0 < got[1].sum() < 16


@pytest.mark.parametrize("kind", ["minsum", "spa", "minstar"])
def test_tile_walk_matches_jax_oracle(mackay, kind):
    """decode_flooding (XLA, f32) on the same LLRs: decisions equal in
    track mode (ragged tiles of 5), and the posteriors after one iteration
    bit for bit for min-sum, within the stated tolerance for the exact
    rules."""
    jg, g, llr = mackay
    op = {"minsum": lambda V, m: jax_cn.cn_minsum(V, m, **KW["minsum"]),
          "spa": jax_cn.cn_spa, "minstar": jax_cn.cn_minstar}[kind]
    want = jax.jit(lambda z: decode_flooding(jg, z, cn_op=op, max_iters=12,
                                             early_term=True))(
        jnp.asarray(llr))
    bits, ok, it, _ = emulate(g, torch.from_numpy(llr), kind, max_iters=12,
                              frames=5, **KW[kind])
    assert np.array_equal(np.asarray(want.bits), bits.numpy())
    assert np.array_equal(np.asarray(want.ok), ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), it.numpy())
    # one fixed iteration: the oracle's posteriors from its check messages
    calls = []

    def recording(V, m):
        calls.append(op(V, m))
        return calls[-1]

    with jax.disable_jit():
        decode_flooding(jg, jnp.asarray(llr), cn_op=recording, max_iters=1,
                        early_term=False)
        Cv = calls[-1].reshape(jg.m * jg.dc_max, -1)[jg.vn_edge]
        ref = np.asarray(jnp.asarray(llr).T + jnp.sum(
            jnp.where(jg.vn_mask[:, :, None], Cv, 0.0), axis=1)).T
    post1 = emulate(g, torch.from_numpy(llr), kind, max_iters=1,
                    early_term=False, frames=5, **KW[kind])[3].numpy()
    if kind == "minsum":
        assert np.array_equal(post1.view(np.int32), ref.view(np.int32))
    else:
        np.testing.assert_allclose(post1, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["minsum", "spa"])
def test_tile_walk_matches_pallas_interpret(kind):
    """K2's TPU kernel in interpret mode at f32 on a (3,6)-regular n = 96
    code (as tests/pallas/test_fused_mm.py sets it up), 32 frames at
    2.5 dB in tiles of 6 (a ragged last tile): identical decisions."""
    spec = gallager_36(96, seed=4)
    jg = jax_compile_graph(spec)
    enc = JaxDenseEncoder.build(spec)
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, (32, spec.k), dtype=np.uint8)
    cw = np.asarray(enc(jnp.asarray(msg)))
    sigma = (2.0 * spec.rate * 10.0 ** (2.5 / 10.0)) ** -0.5
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    want = make_pallas_decoder(jg, kind, max_iters=12, interpret=True,
                               mxu_dtype=jnp.float32, **KW[kind])(
        jnp.asarray(llr))
    bits, ok, it, _ = emulate(_port_graph(jg), torch.from_numpy(llr), kind,
                              max_iters=12, frames=6, **KW[kind])
    assert np.array_equal(np.asarray(want.bits), bits.numpy())
    assert np.array_equal(np.asarray(want.ok), ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), it.numpy())
