"""The tile plan and the ownership map of the cluster-tile kernels (K1a,
K1c; csrc/cluster_tile.cuh), on the CPU.

- For every dup-free QC code of the port's registry that the layered
  kernels take (dvbs2/64800 and dvbs2/16200 at every rate, 8023an, the
  toy Z = 16 xor code) and B in {1, 13, 2048, 4096}, for min-sum and exact
  BP: the plan fits a block's 232,448 B of shared memory with its tables,
  buffers and static arrays; the cluster size is 1, 2, 4, 8 or 16 and
  divides Z; tiles x F >= B; only a cluster of one leaves block-columns
  in the L2 scratch, within the spill budget, read by no more layers than
  the lowest-degree ones would be; the
  index map is a bijection from (block-column, row) onto the ranks'
  buffers and the scratch.
- A CPU emulation of layered_decode_plain that reads and writes the
  posteriors only through the per-rank buffers and the map: bit-identical
  bits, ok, iterations and posteriors on dvbs2/16200/12 and 8023an,
  min-sum and spa, fixed and track, with a plan that spreads 13 frames
  one to a cluster, one that packs them into ragged tiles, and one that
  leaves half the block-columns in the L2 scratch.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from ecc_ldpc_tpu_torch.chan.awgn import awgn_llr
from ecc_ldpc_tpu_torch.codes.dvbs2 import RATES
from ecc_ldpc_tpu_torch.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode import layered_qc as lq
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph, var_index

torch.set_num_threads(1)

# every rate, dvbs2/16200/910 (row degree 34) on the 64-wide builds
DVBS2 = [f"dvbs2/{n}/{r}" for n in (64800, 16200) for r in RATES]
CODES = DVBS2 + ["8023an", "toyxor16"]
BATCHES = (1, 13, 2048, 4096)
# cluster_tile.cuh's static arrays: reduction slots, flags, peer pointers
STATIC_SMEM = 4 * (3 * 65 + 4 * 64) + 8 * 16


@functools.lru_cache(maxsize=None)
def graph_of(code: str):
    if code == "toyxor16":
        base = np.random.default_rng(3).integers(0, 16, size=(4, 8))
        spec = expand_qc_xor(QCXorCode(Z=16, base=base.astype(np.int32)),
                             name="toyxor16")
        return compile_qc_graph(spec)
    return compile_qc_graph(get_code(code))


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("code", CODES)
def test_plan_fits_and_map_is_a_bijection(code, B):
    g = graph_of(code)
    lq.check_graph(g)
    assert g.intra_layer_dup_free
    for cn in ("minsum", "spa"):
        p = lq.tile_plan(g, B, cn)
        assert p.cluster in (1, 2, 4, 8, 16) and g.Z % p.cluster == 0
        assert p.rows * p.cluster == g.Z
        assert 1 <= p.frames <= 64 and p.tiles * p.frames >= B
        assert (p.tiles - 1) * p.frames < B  # no empty tile
        # the waves end even: one frame fewer a tile would need another
        waves = -(-p.tiles // p.clusters)
        assert p.frames == 1 or -(-B // (p.frames - 1)) > waves * p.clusters
        words = ((3 if g.dcb_max <= 16 else 4 if g.dcb_max <= 32 else 5)
                 if cn == "minsum" else g.dcb_max)
        assert p.stride % 4 == 0 and p.stride >= words * p.rows * p.frames
        post = -(-p.chip * p.rows * p.frames // 4) * 4 * 4
        tables = (12 * g.num_block_edges + 4 * (g.mb + 1) + 4 * g.nb)
        assert p.smem == post + 2 * 4 * p.stride + tables
        assert p.smem + STATIC_SMEM <= 232_448
        assert p.frames <= p.threads <= 512 and p.threads % 32 == 0
        # only a cluster of one a single frame spills (when the frame does
        # not fit), within the budget, and its spilled columns reach no more
        # layers than the lowest-degree ones would
        assert p.spill == 0 or (p.cluster, p.frames) == (1, 1)
        assert (p.spill * g.Z * p.frames * 4 * p.clusters
                <= lq.SPILL_BUDGET)
        home = np.asarray(p.home)
        assert sorted(home[home >= 0]) == list(range(p.chip))
        assert sorted(-1 - home[home < 0]) == list(range(p.spill))
        if 0 < p.chip < g.nb:
            deg = np.bincount(g.be_col, minlength=g.nb)
            low = np.argsort(deg, kind="stable")[:p.spill]
            rows = g.be_row[np.isin(g.be_col, np.flatnonzero(home < 0))]
            rows_low = g.be_row[np.isin(g.be_col, low)]
            assert len(set(rows)) <= len(set(rows_low))
        # the map: every (col, row, frame) of a tile lands on its own word
        # of its own rank's buffer or of the scratch (rank -1), and every
        # word of every buffer is hit
        col, z, f = np.meshgrid(np.arange(g.nb), np.arange(g.Z),
                                np.arange(p.frames), indexing="ij")
        rank, word = p.slot(col, z, f)
        assert rank.min() >= -1 and rank.max() < p.cluster
        size = p.chip * p.rows * p.frames
        flat = np.where(rank >= 0, rank * size + word,
                        p.cluster * size + word).ravel()
        assert np.array_equal(np.sort(flat),
                              np.arange(g.nb * g.Z * p.frames))
        # rank r owns rows z = r (mod CS): its checks read its own rows
        assert np.array_equal(rank[rank >= 0], (z % p.cluster)[rank >= 0])


def test_small_batch_spreads_over_the_card():
    """The production fallback's ~13 frames: one frame to a cluster of 8
    on dvbs2/64800 (104 SMs busy, not 2); the headline batch takes the
    plan with the fewest waves, a cluster of one a frame; 8023an's frames
    fit one SM (CS = 1)."""
    g = graph_of("dvbs2/64800/12")
    for cn in ("minsum", "spa"):
        p = lq.tile_plan(g, 13, cn)
        assert (p.cluster, p.frames, p.tiles) == (8, 1, 13)
        big = lq.tile_plan(g, 4096, cn)
        waves = [-(-q.tiles // q.clusters)
                 for _, _, q in lq.candidate_plans(g, 4096, cn)]
        assert -(-big.tiles // big.clusters) == min(waves)
    an = graph_of("8023an")
    p = lq.tile_plan(an, 2048, "minsum")
    assert p.cluster == 1 and p.frames >= 8 and p.spill == 0
    # track mode: four waves of smaller tiles, so clusters whose frames
    # stop early take more; the fallback's 13 frames still spread
    p = lq.tile_plan(an, 4096, "minsum", track=True)
    assert (p.cluster, p.frames) == (1, 8)
    assert -(-p.tiles // p.clusters) == lq.TRACK_WAVES
    assert lq.tile_plan(g, 13, "spa", track=True).cluster == 8
    # the headline batch: a cluster of one a frame, its spilled columns (a
    # run of adjacent degree-2 parity columns, and info columns whose layers
    # that run already reads) read by fewer than 40% of the layers
    p = lq.tile_plan(g, 4096, "minsum")
    assert (p.cluster, p.frames) == (1, 1) and 0 < p.spill < g.nb // 2
    spilled = np.flatnonzero(np.asarray(p.home) < 0)
    assert len(set(g.be_row[np.isin(g.be_col, spilled)])) < 0.4 * g.mb


def test_no_plan_raises():
    """A frame whose posteriors outgrow 16 blocks' shared memory, and a
    single-layer graph, have no plan; the wrapper never falls back."""
    g = graph_of("toyxor16")
    with pytest.raises(ValueError):
        lq.tile_plan(g, 0)

    class Huge:  # 16 blocks x 227 KB < 1e6 f32 posteriors
        Z, nb, mb, num_block_edges, dcb_max, n = 16, 65536, 4, 64, 8, 1 << 20
        name = "huge"

    with pytest.raises(ValueError, match="no tile plan fits"):
        lq.tile_plan(Huge, 1)

    class OneLayer(Huge):
        nb, mb, n = 8, 1, 128

    with pytest.raises(ValueError, match="2 layers"):
        lq.tile_plan(OneLayer, 1)


def emulate(graph, llr, plan, *, alpha, max_iters, early_term, cn):
    """layered_decode_plain with the posteriors held in per-rank buffers:
    buffer [tiles, CS, nb * R * F] f32, variable (col, z) of frame f of a
    tile at plan.slot(col, z, f); every layer gathers and scatters its
    posteriors through the map. Returns (DecodeResult, posteriors [B, n])."""
    B, n, Z, nb = llr.shape[0], graph.n, graph.Z, graph.nb
    F, cs, tiles = plan.frames, plan.cluster, plan.tiles
    size = plan.chip * plan.rows * F  # words of a rank's buffer
    # rows (F words each) of the ranks' buffers, then of the L2 scratch:
    # view [(CS * chip * R + spill * Z), F * tiles]
    col, z = np.meshgrid(np.arange(nb), np.arange(Z), indexing="ij")
    rank, word0 = plan.slot(col, z, 0)
    for f in range(F):
        assert np.array_equal(plan.slot(col, z, f)[1], word0 + f)
    flat = np.where(rank >= 0, rank * size + word0, cs * size + word0)
    row_of = torch.as_tensor(flat // F).view(-1)  # var -> row
    buf = torch.zeros((cs * size + plan.spill * Z * F, tiles))
    rows = buf.view(-1, F * tiles)  # column f * tiles + tile
    pad = torch.zeros((tiles * F, n), dtype=torch.float32)
    pad[:B] = llr
    rows[row_of] = pad.view(tiles, F, n).permute(2, 1, 0).reshape(n, -1)
    layers = []
    zz = np.arange(Z)
    for idx, eids, d in lq._plain_layers(graph, "cpu"):
        var = idx.view(d, Z)  # the plain version's variables, slot-major
        for j, (_, c, s) in enumerate(graph.layer_edges(
                graph.layer_order[len(layers)])):
            assert np.array_equal(var[j].numpy(),
                                  c * Z + var_index(zz, s, Z, graph.perm))
        layers.append((row_of[idx], eids, d))
    alphas, betas, _ = lq._schedule(alpha, 0.0, max_iters, cn)
    C = torch.zeros((graph.num_block_edges, Z, F * tiles))

    def rule(t):
        return lq._check_rule(cn, float(alphas[t]), float(betas[t]))

    Bp = F * tiles
    if early_term:
        done = ~lq._syndrome_fail_plain(layers, rows, Z)
        iters = torch.zeros(Bp, dtype=torch.int32)
        for t in range(max_iters):
            if bool(done.all()):
                break
            fail = lq._sweep_plain(layers, rows, C, Z, rule(t), done)
            iters += (~done).to(torch.int32)
            done = done | ~fail
    else:
        for t in range(max_iters):
            lq._sweep_plain(layers, rows, C, Z, rule(t), None)
        iters = torch.full((Bp,), max_iters, dtype=torch.int32)
    ok = ~lq._syndrome_fail_plain(layers, rows, Z)
    # frames back in batch order: column f * tiles + tile is frame tile*F+f
    order = torch.arange(Bp).view(F, tiles).t().reshape(-1)[:B]
    post = rows[row_of][:, order].t().contiguous()
    res = lq.DecodeResult(bits=(post < 0).to(torch.uint8), ok=ok[order],
                          iterations=iters[order])
    return res, post


@pytest.mark.parametrize("layout", ["spread", "packed", "spilled"])
@pytest.mark.parametrize("mode", ["fixed", "track"])
@pytest.mark.parametrize("cn", ["minsum", "spa"])
@pytest.mark.parametrize("code,ebn0", [("dvbs2/16200/12", 1.4),
                                       ("8023an", 3.4)])
def test_emulation_bit_identical_to_plain(code, ebn0, cn, mode, layout):
    g = graph_of(code)
    B, T = 13, 12
    # spread: the card's plan (one frame to a cluster of 8); packed: a
    # 4-SM card's, several frames a tile and a ragged last tile; spilled: a
    # cluster of one whose lowest-degree block-columns are in the scratch
    sms = 132 if layout == "spread" else 4
    plan = lq.tile_plan(g, B, cn, sms=sms)
    if layout == "spilled":
        plan = dataclasses.replace(
            plan, chip=g.nb // 2, home=lq.column_homes(g, g.nb // 2))
        assert plan.cluster == 1 and plan.spill > 0
    if layout == "spread":
        assert plan.cluster == 8 and plan.frames == 1
    else:
        assert plan.frames > 1 and B % plan.frames != 0
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    llr = awgn_llr(gen, torch.zeros((B, g.n), dtype=torch.uint8), ebn0,
                   g.k / g.n)
    kw = dict(alpha=0.8125, max_iters=T, early_term=mode == "track", cn=cn)
    want, wpost = lq.plain_with_posteriors(g, llr, **kw)
    got, gpost = emulate(g, llr, plan, **kw)
    assert torch.equal(want.bits, got.bits)
    assert torch.equal(want.ok, got.ok)
    assert torch.equal(want.iterations, got.iterations)
    assert torch.equal(wpost.contiguous().view(torch.int32),
                       gpost.view(torch.int32))
    if mode == "track":  # some frames freeze early, some run on
        assert int(got.iterations.min()) < T or bool(got.ok.all())


def test_degree_caps_are_the_cards():
    """Rows of 33-64 get a plan of the 64-wide builds (5 words of min-sum
    check state); above 64 every form plans its wide build (3 + ceil(d/32)
    words of min-sum check state; the classic form's barrier masks
    ceil(d/32) words a layer); the plain version decodes any degree."""
    from ecc_ldpc_tpu_torch.codes.qc import QCCode, expand_qc

    g = graph_of("dvbs2/16200/910")
    assert g.dcb_max == 34
    assert lq.tile_plan(g, 4096, "minsum").stride % 4 == 0
    assert lq.MAX_DEG == 64 and not hasattr(lq, "MAX_DEG_CLASSIC")
    wide = compile_qc_graph(expand_qc(
        QCCode(Z=4, base=np.zeros((2, 67), np.int32)), name="wide67",
        k=65 * 4))
    assert wide.dcb_max == 67
    lq.check_graph(wide)  # the plain version takes any degree
    for form in ("set", "flooding", "classic"):
        plan = lq.tile_plan(wide, 8, form=form)
        assert plan.threads <= 512 and plan.smem <= lq._SMEM_BLOCK
    assert lq.tile_plan(wide, 8, "minsum").stride % 4 == 0
    assert lq.min_sum_words(67) == 6 and lq.min_sum_words(64) == 5
    assert [lq.mask_words(d) for d in (8, 32, 33, 64, 67)] == [1, 1, 2, 2, 3]
    assert lq.tile_plan(g, 8, form="classic").threads <= 512
    llr = torch.ones((2, wide.n))
    res = lq.layered_decode_plain(wide, llr, alpha=0.8125, max_iters=2)
    assert bool(res.ok.all()) and not bool(res.bits.any())

