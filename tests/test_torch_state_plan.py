"""The plans and the ownership maps of the kernels that hold a tile's whole
decoder state on chip (csrc/state_tile.cuh: K1b/K1c' in
csrc/layered_classic.cu, form "classic"; K3 and K4 flooding in
csrc/flooding_qc.cu, form "flooding"), on the CPU.

- Every registered QC graph that the kernels take gets a plan at
  B in {1, 13, 4096}: the classic form for every CCSDS AR4JA size and rate
  (the graphs that repeat a block-column in a layer), the flooding form
  for every DVB-S2 table, the CCSDS graphs and 802.3an. The plan's bytes
  are what the kernel carves and fit a block's 232,448 B with the static
  arrays; dvbs2/16200/910 (row degree 34) raises the documented
  ValueError.
- The expected shapes: a ccsds/4096/12 frame an SM and several
  ccsds/1024 frames an SM, a ccsds/16384 frame over a cluster of 4, a
  dvbs2/64800 frame over a cluster of 8 (the largest table, rate 3/5, with
  its LLRs), dvbs2/16200 over 2, several 802.3an frames an SM, and the
  retry fallback's ~13 frames spread over clusters of 8.
- The ownership map covers every variable, check and message of a tile
  exactly once, and the kernel's edge arithmetic (state_tile.cuh's `meet`
  and `at`, transcribed here) reaches, from each rank's rows, the word the
  map gives for the posterior a check reads and the message a variable
  reads, circulant and xor.
- The classic kernel's barrier masks (classic_barriers) are the clash
  rule of the earlier kernel, reverse for minstar, and are enough: a CPU
  emulation that applies the slots of each barrier group in reverse order
  is bit-identical to the plain version.
"""
import functools

import numpy as np
import pytest
import torch

from ecc_ldpc_tpu_torch.chan.awgn import awgn_llr
from ecc_ldpc_tpu_torch.codes import ccsds
from ecc_ldpc_tpu_torch.codes.dvbs2 import RATES
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode import layered_qc as lq
from ecc_ldpc_tpu_torch.decode.flooding_qc import MAX_DEG as FLOOD_MAX_DEG
from ecc_ldpc_tpu_torch.graph.qc import (
    check_index,
    compile_qc_graph,
    var_index,
)

torch.set_num_threads(1)

CCSDS = [f"ccsds/{k}/{r}" for k in (1024, 4096, 16384)
         for r in ("12", "23", "45")]
DVBS2 = ([f"dvbs2/64800/{r}" for r in RATES]
         + ["dvbs2/16200/12", "dvbs2/16200/910"])
# csrc/state_tile.cuh's st::Shared: peer pointers, reduction slots, flags
STATIC_SMEM = 8 * 16 + 4 * (3 * 65 + 4 * 64)


@functools.lru_cache(maxsize=None)
def graph_of(code: str):
    if code.startswith("m32_"):
        return compile_qc_graph(ccsds.ar4ja(rate=code[4:], M=32))
    return compile_qc_graph(get_code(code))


def check_plan(g, p, B, form):
    """The plan is whole: its bytes are the kernel's carve-up and fit."""
    assert p.form == form and p.stride == 0 and p.chip == g.nb
    assert p.cluster in lq.CLUSTER_SIZES and g.Z % p.cluster == 0
    assert p.rows * p.cluster == g.Z
    assert 1 <= p.frames <= 64 and p.tiles * p.frames >= B
    assert (p.tiles - 1) * p.frames < B  # no empty tile
    # 1024 threads where a check of 8 fits 64 registers (__launch_bounds__)
    cap = 1024 if g.dcb_max <= 8 else 512
    assert p.frames <= p.threads <= cap and p.threads % 32 == 0
    BE, mb, nb = g.num_block_edges, g.mb, g.nb
    if form == "classic":
        words, tables = nb + BE + g.dcb_max, 12 * BE + 4 * (mb + 1) + 4 * mb
        assert not p.llr_chip
    else:
        words = nb + BE + (nb if p.llr_chip else 0)
        tables = 24 * BE + 4 * (mb + 1) + 4 * (nb + 1)
    assert p.smem == -(-words * p.rows * p.frames // 4) * 16 + tables
    assert p.smem + STATIC_SMEM <= 232_448


@pytest.mark.parametrize("B", (1, 13, 4096))
@pytest.mark.parametrize("code", CCSDS + DVBS2 + ["8023an"])
def test_every_graph_gets_a_plan(code, B):
    g = graph_of(code)
    forms = ["flooding"] + (["classic"] if code.startswith("ccsds") else [])
    assert g.intra_layer_dup_free != code.startswith("ccsds")
    for form in forms:
        # dvbs2/16200/910 (row degree 34) takes K3's 64-wide build
        assert g.dcb_max <= FLOOD_MAX_DEG
        check_plan(g, lq.tile_plan(g, B, form=form), B, form)


def test_plans_take_the_expected_shapes():
    def plan(code, B, form, track=False):
        p = lq.tile_plan(graph_of(code), B, form=form, track=track)
        return p.cluster, p.frames

    # classic: a frame an SM, several an SM, a frame over 4 SMs
    assert plan("ccsds/4096/12", 4096, "classic") == (1, 1)
    assert plan("ccsds/1024/12", 4096, "classic") == (1, 4)
    assert plan("ccsds/1024/12", 601, "classic") == (1, 3)
    assert plan("ccsds/16384/12", 4096, "classic") == (4, 1)
    # the retry fallback's ~16 frames spread one to a cluster of 8
    assert plan("ccsds/4096/12", 16, "classic", track=True) == (8, 1)
    # flooding: every DVB-S2 normal frame over a cluster of 8 with its LLRs
    for r in RATES:
        p = lq.tile_plan(graph_of(f"dvbs2/64800/{r}"), 4096, form="flooding")
        assert (p.cluster, p.frames, p.llr_chip) == (8, 1, True)
    assert plan("dvbs2/64800/12", 13, "flooding", track=True) == (8, 1)
    assert plan("dvbs2/16200/12", 4096, "flooding") == (2, 1)
    assert plan("8023an", 2048, "flooding") == (1, 3)
    assert plan("8023an", 601, "flooding") == (1, 3)
    assert plan("ccsds/4096/12", 4096, "flooding") == (1, 1)
    # a plan whose LLRs stay in [B, n]: the variable phase reads them there
    p = lq.tile_plan(graph_of("ccsds/4096/45"), 601, form="flooding")
    assert (p.cluster, p.frames, p.llr_chip) == (1, 2, False)


def test_no_state_plan_raises():
    class Huge:  # 16 blocks x 227 KB < a frame's messages
        Z, nb, mb, num_block_edges, dcb_max, n = 16, 64, 4, 65536, 8, 1024
        name = "huge"

    for form in ("classic", "flooding"):
        with pytest.raises(ValueError, match="messages a frame"):
            lq.tile_plan(Huge, 1, form=form)
    with pytest.raises(KeyError, match="form"):
        lq.tile_plan(graph_of("8023an"), 1, form="other")


def meet(rank, s, inverse, Z, cs, F, perm):
    """csrc/state_tile.cuh's meet: (owner rank, offset) of the rows that
    rank's rows meet across a block with shift s."""
    lg = cs.bit_length() - 1
    if perm == "xor":
        return (rank ^ s) & (cs - 1), s >> lg
    t = (rank - s if inverse else rank + s) % Z
    return t & (cs - 1), (t >> lg) * F


def at(off, zl, f, R, F, perm):
    """csrc/state_tile.cuh's at: the word of row zl, frame f."""
    zf = zl * F + f
    if perm == "xor":
        return zf + ((zl ^ off) - zl) * F
    o = zf + off
    return np.where(o >= R * F, o - R * F, o)


@pytest.mark.parametrize("code,B,form", [
    ("ccsds/1024/12", 13, "classic"),      # CS 8, F 1
    ("ccsds/1024/12", 601, "classic"),     # CS 1, F 3, a ragged last tile
    ("ccsds/16384/12", 4096, "classic"),   # CS 4
    ("dvbs2/16200/12", 4096, "flooding"),  # CS 2
    ("8023an", 601, "flooding"),           # CS 1, F 3, xor
    ("8023an", 13, "flooding"),            # CS 8, xor
    ("ccsds/4096/23", 32, "flooding"),     # CS 4, multi-edge
])
def test_map_covers_everything_once(code, B, form):
    g = graph_of(code)
    p = lq.tile_plan(g, B, form=form)
    Z, nb, BE, R, F, cs = g.Z, g.nb, g.num_block_edges, p.rows, p.frames, \
        p.cluster
    # variables: each (col, z, f) on its own word of its own rank's region
    col, z, f = np.meshgrid(np.arange(nb), np.arange(Z), np.arange(F),
                            indexing="ij")
    rank, word = p.slot(col, z, f)
    assert np.array_equal(rank, z % cs)
    assert np.array_equal(np.sort((rank * nb * R * F + word).ravel()),
                          np.arange(nb * Z * F))
    # messages: each (slot, check, f) likewise, on the check's owner
    s, zc, f2 = np.meshgrid(np.arange(BE), np.arange(Z), np.arange(F),
                            indexing="ij")
    mrank, mword = p.message_slot(s, zc, f2)
    assert np.array_equal(mrank, zc % cs)
    assert np.array_equal(np.sort((mrank * BE * R * F + mword).ravel()),
                          np.arange(BE * Z * F))
    # checks: rank r's items (L, zl, f) are the checks z = zl * CS + r, each
    # check of each layer once over the ranks
    zl, r = np.meshgrid(np.arange(R), np.arange(cs), indexing="ij")
    assert np.array_equal(np.sort((zl * cs + r).ravel()), np.arange(Z))
    # the edge arithmetic: from rank r's row zl, slot `slot` (column c,
    # shift sh) reaches the posterior check z reads, and a variable's k-th
    # edge the message of the check that reads it
    zl = np.arange(R)
    ff = np.arange(F)[:, None]
    slot = 0
    for i in g.layer_order:
        for _, c, sh in g.layer_edges(i):
            for rk in range(cs):
                zc = zl * cs + rk
                owner, off = meet(rk, sh, False, Z, cs, F, g.perm)
                zz = var_index(zc, sh, Z, g.perm)
                want_rank, want = p.slot(np.full_like(zz, c), zz, ff)
                assert (want_rank == owner).all()
                assert np.array_equal(at(off, zl, ff, R, F, g.perm)
                                      + c * R * F, want)
                # the variable phase: variable zv = zl * CS + rk of column c
                # reads the message of check check_index(zv, sh) in `slot`
                owner, off = meet(rk, sh, True, Z, cs, F, g.perm)
                zchk = check_index(zc, sh, Z, g.perm)
                want_rank, want = p.message_slot(slot, zchk, ff)
                assert (want_rank == owner).all()
                assert np.array_equal(at(off, zl, ff, R, F, g.perm)
                                      + slot * R * F, want)
            slot += 1


def clash_masks(graph, cn):
    """The clash rule of the earlier classic kernel (its state in HBM): a
    barrier before visit position q when a slot in [since, q) has q's
    column; since = q after it."""
    masks = []
    for i in graph.layer_order:
        cols = [c for _, c, _ in graph.layer_edges(i)]
        d = len(cols)

        def j_of(q):
            return d - 1 - q if cn == "minstar" else q

        mask, since = 0, 0
        for q in range(d):
            if any(cols[j_of(q2)] == cols[j_of(q)] for q2 in range(since, q)):
                mask |= 1 << q
                since = q
        masks.append(mask)
    return masks


@pytest.mark.parametrize("cn", ["minsum", "minstar"])
@pytest.mark.parametrize("code", ["ccsds/1024/12", "ccsds/4096/23",
                                  "ccsds/4096/45", "m32_45"])
def test_barriers_follow_the_clash_rule(code, cn):
    g = graph_of(code)
    masks = lq.classic_barriers(g, cn)
    assert masks == clash_masks(g, cn)
    assert any(masks)  # every CCSDS layer set repeats a block-column
    tab = lq._classic_table(g, "cpu", cn).numpy()
    assert np.array_equal(tab[:-g.mb], lq._kernel_table(g, "cpu").numpy())
    assert list(tab[-g.mb:].view(np.uint32)) == masks


def emulate_groups(graph, llr, cn, max_iters, early_term):
    """plain_with_posteriors with the accumulate step in the kernel's
    barrier groups, each group's slots applied in reverse order: any order
    within a group must give the same floats."""
    masks = lq.classic_barriers(graph, cn)
    orig = lq._sweep_plain

    def sweep(layers, total, C, Z, rule, frozen, accumulate=False,
              reverse=False):
        assert accumulate
        B = total.shape[1]
        track = frozen is not None
        fail = torch.zeros(B, dtype=torch.bool)
        for (idx, eids, d), mask in zip(layers, masks):
            rolled = total[idx].view(d, Z, B)
            if track:
                fail |= ((rolled < 0).sum(0) % 2 != 0).any(0)
                keep = frozen.view(1, 1, B)
            Cold = C[eids]
            Cnew = rule(rolled - Cold)
            if track:
                Cnew = torch.where(keep, Cold, Cnew)
            delta = Cnew - Cold
            order = list(range(d - 1, -1, -1) if reverse else range(d))
            groups, cur = [], []
            for q, j in enumerate(order):
                if (mask >> q) & 1:
                    groups.append(cur)
                    cur = []
                cur.append(j)
            groups.append(cur)
            for grp in groups:
                for j in reversed(grp):
                    ij = idx[j * Z:(j + 1) * Z]
                    old = total[ij]
                    new = old + delta[j]
                    if track:
                        new = torch.where(keep[0], old, new)
                        fail |= (torch.signbit(new)
                                 != torch.signbit(old)).any(0)
                    total[ij] = new
            C[eids] = Cnew
        return fail

    lq._sweep_plain = sweep
    try:
        return lq.plain_with_posteriors(graph, llr, alpha=0.8125,
                                        max_iters=max_iters,
                                        early_term=early_term, cn=cn)
    finally:
        lq._sweep_plain = orig


@pytest.mark.parametrize("mode", ["fixed", "track"])
@pytest.mark.parametrize("cn", ["minsum", "spa", "minstar"])
def test_barrier_groups_commute(cn, mode):
    g = graph_of("m32_45")  # row degree 18, several repeats a layer
    gen = torch.Generator().manual_seed(5)
    llr = awgn_llr(gen, torch.zeros((8, g.n), dtype=torch.uint8), 3.0,
                   g.k / g.n)
    kw = dict(max_iters=6, early_term=mode == "track")
    want, wpost = lq.plain_with_posteriors(g, llr, alpha=0.8125, cn=cn, **kw)
    got, gpost = emulate_groups(g, llr, cn, **kw)
    assert torch.equal(want.bits, got.bits) and torch.equal(want.ok, got.ok)
    assert torch.equal(want.iterations, got.iterations)
    assert torch.equal(wpost.contiguous().view(torch.int32),
                       gpost.contiguous().view(torch.int32))


@pytest.mark.parametrize("src,inst", [("layered_qc", 4), ("layered_exact", 4),
                                      ("layered_classic", 3),
                                      ("flooding_qc", 4)])
def test_cluster_queries_take_what_the_wrappers_pass(src, inst):
    """resident_clusters passes the kernel instance's ints, then cs,
    threads and smem, then the result's address."""
    import re

    from ecc_ldpc_tpu_torch import _build

    text = (_build.CSRC / f"{src}.cu").read_text()
    params = re.search(rf"int {src}_clusters\(([^)]*)\)", text).group(1)
    types = [re.sub(r"\s+", "", q.rsplit(None, 1)[0])
             for q in params.split(",")]
    assert types == ["int"] * (inst + 3) + ["void*"]
