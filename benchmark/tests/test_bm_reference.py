"""The reference against the port's plain versions on small QC codes of both
parity shapes, the frozen tables against the port's registry and against
what the standards fix, and the frozen roofline against PERF.md's
figures."""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib

import pytest
import torch

from benchmark import freeze_code, roofline
from benchmark.reference import layered, qc
from benchmark.reference import qc_dual_diagonal as encode

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
# a dual-diagonal code and a 5G NR code (core, extension rows, punctured
# columns), small enough for the CPU, each at an Eb/N0 in its waterfall,
# where some frames fail every decoder below and the fallback runs
CODES = {"80211n/648/12": 1.0, "nr5g/bg1/32": 1.0}
SPECS = ("layered/norm:0.8125/10/noet", "layered/norm:0.8125/20",
         "layered/spa/8", "layered/norm:0.8125/4;retry=layered/spa/10")


def table_of(code: str) -> qc.QCTable:
    t = freeze_code.table(code)
    return qc.QCTable(Z=t["Z"], mb=t["mb"], nb=t["nb"], k=t["k"],
                      edges=tuple(map(tuple, t["edges"])),
                      punctured=tuple(map(tuple, t["punctured"])))


def draws(table, batch, seed=7):
    g = torch.Generator().manual_seed(seed)
    msg = torch.randint(0, 2, (batch, table.k), generator=g,
                        dtype=torch.uint8)
    return msg, torch.randn((batch, table.n), generator=g)


@pytest.mark.parametrize("code", CODES)
def test_encode_and_channel_match_the_port(code):
    from ecc_ldpc_tpu_torch.chan.awgn import make_channel
    from ecc_ldpc_tpu_torch.codes.registry import get_code
    from ecc_ldpc_tpu_torch.encode.structured import build_encoder

    table = table_of(code)
    spec = get_code(code)
    msg, noise = draws(table, 16)
    cw = encode.encode(table, msg)
    assert torch.equal(cw, build_encoder(spec)(msg))
    assert not qc.syndrome_fail(table, cw).any()
    ebn0 = CODES[code]
    got = encode.llr(table, cw, noise, ebn0)
    want = make_channel(spec)(None, cw, ebn0, noise)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("code", CODES)
def test_decode_matches_the_port(code, spec):
    from ecc_ldpc_tpu_torch.codes.registry import get_code
    from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder

    table = table_of(code)
    msg, noise = draws(table, 24, seed=11)
    llr = encode.llr(table, encode.encode(table, msg), noise, CODES[code])
    port = get_code(code)
    res = get_decoder(choose_graph(port, spec), spec, device="cpu")(llr)
    parsed = layered.parse(spec)
    bits, ok, iters = layered.decode(table, llr, parsed, block=10)
    # some frames decode, some fail (or, with a retry, reach the fallback)
    assert ok.any()
    assert (iters > parsed.iters).any() if parsed.fallback else not ok.all()
    assert torch.equal(bits, res.bits)
    assert torch.equal(ok, res.ok)
    assert torch.equal(iters, res.iterations)


def test_control_differs_from_the_reference():
    table = table_of("nr5g/bg1/32")
    msg, noise = draws(table, 24, seed=3)
    llr = encode.llr(table, encode.encode(table, msg), noise, 0.6)
    spec = layered.parse("layered/norm:0.8125/25/noet")
    bits, _, _ = layered.decode(table, llr, spec)
    low, _, _ = layered.decode(table, llr, spec, precision="bf16")
    assert (bits != low).any()
    low_llr = encode.llr(table, encode.encode(table, msg), noise, 0.6, "bf16")
    assert (low_llr != llr).any()


@pytest.mark.parametrize("name", ["dvbs2_64800_r12", "nr5g_bg1_z384"])
def test_frozen_tables_are_the_registered_codes(name):
    from ecc_ldpc_tpu_torch.codes.registry import get_code

    config = json.loads((CONFIGS / f"{name}.json").read_text())
    table = qc.load(CONFIGS / config["H"])
    spec = get_code(config["code"])
    qc.check_registered(table, spec)
    assert (table.n, table.k, table.num_edges) == (
        config["n"], config["k"], config["edges"])
    r, c, s = table.edges[0]
    moved = dataclasses.replace(table, edges=((r, c, (s + 1) % table.Z),)
                                + table.edges[1:])
    with pytest.raises(ValueError, match="edges"):
        qc.check_registered(moved, spec)


def test_roofline_reproduces_the_recorded_bounds():
    # PERF.md: K1a's headline bound 4.166 ms (dvbs2/64800/12, B = 4096,
    # 25 iterations) and NR's 2.23 ms (nr5g/bg1/384, 121,344 edges)
    t, form = roofline.decode_bound(64800, 227160, 4096, 4096 * 25,
                                    "minsum", 32400)
    assert form == "operations" and round(t * 1e3, 3) == 4.166
    t, form = roofline.decode_bound(26112, 121344, 4096, 4096 * 25,
                                    "minsum", 17664)
    assert form == "operations" and round(t * 1e3, 2) == 2.23


def _profile(name):
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    table = qc.load(CONFIGS / config["H"])
    cols = collections.Counter(c for _, c, _ in table.edges)
    rows = collections.Counter(r for r, _, _ in table.edges)
    return config, table, cols, rows


def test_dvbs2_table_keeps_what_the_standard_fixes():
    # EN 302 307-1 5.3.2, rate 1/2 normal frame: q = 90, 12,960 message
    # bits of degree 8 then 19,440 of degree 3, in groups of 360; the
    # parity section is the configuration's stated departure
    config, t, cols, rows = _profile("dvbs2_64800_r12")
    assert (t.Z, t.mb, t.nb, t.k, t.punctured) == (360, 90, 180, 32400, ())
    kb = t.nb - t.mb
    assert [cols[c] for c in range(kb)] == [8] * 36 + [3] * 54
    assert all(0 <= s < t.Z for _, _, s in t.edges)
    message = collections.Counter(r for r, c, _ in t.edges if c < kb)
    assert sum(message.values()) * t.Z == 12960 * 8 + 19440 * 3
    assert sorted(message.values()) == [4] + [5] * 88 + [6]
    parity = sorted(cols[c] for c in range(kb, t.nb))
    assert parity == [2] * 89 + [3]
    assert t.num_edges - config["standard"]["edges"] == 361
    assert set(config["reduced"]) == {"H", "edges", "row_degrees"}


def test_nr_table_keeps_base_graph_1():
    # TS 38.212 5.3.2, base graph 1: 46 x 68, 316 nonzero cells, kb = 22,
    # the first 2 Zc columns punctured, rows 0-3 of degree 19 over the
    # dual-diagonal core (columns 22-25), and each extension parity column
    # 26 + j a shift-0 identity in row 4 + j alone
    _, t, cols, rows = _profile("nr5g_bg1_z384")
    assert (t.Z, t.mb, t.nb, t.k) == (384, 46, 68, 22 * 384)
    assert len(t.edges) == 316 and t.num_edges == 121344
    assert t.punctured == ((0, 768),)
    assert [rows[r] for r in range(4)] == [19] * 4 and max(rows.values()) == 19
    for j in range(t.nb - 26):
        assert [(r, s) for r, c, s in t.edges if c == 26 + j] == [(4 + j, 0)]
    core = {(r, c) for r, c, _ in t.edges if 22 <= c < 26 and r < 4}
    assert core == {(0, 22), (1, 22), (3, 22), (0, 23), (1, 23), (1, 24),
                    (2, 24), (2, 25), (3, 25)}
    assert all(0 <= s < t.Z for _, _, s in t.edges)
