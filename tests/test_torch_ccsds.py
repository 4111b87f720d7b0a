"""The port's CCSDS AR4JA family (codes/ccsds.py, codes/qc.QCMultiCode,
codes/girth's edge-list optimizer) against the JAX package: the same
protograph, the same shifts from the same seed, the same lifted H, k,
punctured columns and rate; the dense generator and the channel on it."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.chan import awgn as jax_awgn
from ecc_ldpc_tpu.codes import ccsds as jax_ccsds
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes import girth as jax_girth
from ecc_ldpc_tpu.encode.dense import systematic_generator as jax_sg
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.chan.awgn import make_channel
from ecc_ldpc_tpu_torch.codes import ccsds, girth
from ecc_ldpc_tpu_torch.codes.qc import QCMultiCode, expand_qc_multi
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.encode.dense import DenseEncoder
from ecc_ldpc_tpu_torch.encode.structured import build_encoder
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)


def _same_code(got, want):
    assert got.name == want.name
    assert (got.n, got.m, got.k) == (want.n, want.m, want.k)
    assert got.rate == want.rate
    assert tuple(got.punctured_cols) == tuple(want.punctured_cols)
    assert got.punctured_cols[-1] == got.n - 1  # the last block: vP
    assert len(got.punctured_cols) == got.qc.Z
    for name in ("br", "bc", "sh"):
        a, b = getattr(got.qc, name), getattr(want.qc, name)
        assert a.dtype == np.int32 and np.array_equal(a, b), name
    assert (got.qc.Z, got.qc.mb, got.qc.nb) == (want.qc.Z, want.qc.mb,
                                                want.qc.nb)
    assert len(got.row_cols) == len(want.row_cols)
    for a, b in zip(got.row_cols, want.row_cols):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rate", ["12", "23", "45"])
def test_ar4ja_m32_matches_jax(rate):
    _same_code(ccsds.ar4ja(rate=rate, M=32), jax_ccsds.ar4ja(rate=rate, M=32))


@pytest.mark.parametrize("code", ["ccsds/1024/12", "ccsds/1024/23",
                                  "ccsds/1024/45", "ccsds/4096/12",
                                  "ccsds/1024/12/s3"])
def test_registry_codes_match_jax(code):
    got, want = get_code(code), jax_get_code(code)
    _same_code(got, want)
    # the graph the decoders take: a block-column repeated in every layer
    g, jg = compile_qc_graph(got), jax_compile_qc_graph(want)
    assert not g.intra_layer_dup_free and not jg.intra_layer_dup_free
    assert g.layer_order == tuple(jg.layer_order)
    for i in range(g.mb):
        assert [tuple(map(int, e)) for e in g.layer_edges(i)] == \
            [tuple(map(int, e)) for e in jg.layer_edges(i)]
        cols = [c for _, c, _ in g.layer_edges(i)]
        assert len(cols) > len(set(cols))


@pytest.mark.parametrize("j", [0, 1, 3])
def test_edge_optimizer_matches_jax(j):
    br, bc = ccsds.ar4ja_edges(j)
    jbr, jbc = jax_ccsds.ar4ja_edges(j)
    assert np.array_equal(br, jbr) and np.array_equal(bc, jbc)
    for a, b in zip(girth._edge_quadruples(br, bc),
                    jax_girth._edge_quadruples(jbr, jbc)):
        assert np.array_equal(a, b)
    # same shifts and count from two seeds, at a small lifting (rate 4/5
    # at Z=16 keeps a residual, and its random kicks take seconds)
    Z = 32 if j == 3 else 16
    for seed in (0, 5):
        sh = girth.optimize_edge_shifts(br, bc, Z, seed=seed)
        want = jax_girth.optimize_edge_shifts(jbr, jbc, Z, seed=seed)
        assert sh.dtype == np.int32 and np.array_equal(sh, want)
        assert girth.edge_4cycle_count(br, bc, sh, Z) == \
            jax_girth.edge_4cycle_count(jbr, jbc, want, Z)


def test_qc_multi_code_refusals():
    # two parallel edges with one shift would cancel over GF(2)
    with pytest.raises(ValueError, match="cancel"):
        QCMultiCode(Z=8, mb=1, nb=2, br=[0, 0, 0], bc=[0, 0, 1],
                    sh=[3, 3, 0])
    for kw in (dict(br=[1], bc=[0], sh=[0]), dict(br=[0], bc=[2], sh=[0]),
               dict(br=[0], bc=[0], sh=[8]), dict(br=[0, 0], bc=[0], sh=[0])):
        with pytest.raises(ValueError):
            QCMultiCode(Z=8, mb=1, nb=2, **kw)
    # distinct shifts in one cell that still land on one lifted entry:
    # cells (0, 0) and (0, 1) never clash, so build the clash by hand
    qcm = QCMultiCode(Z=4, mb=1, nb=1, br=[0, 0], bc=[0, 0], sh=[1, 3])
    spec = expand_qc_multi(qcm, name="pair", k=0)
    assert [list(r) for r in spec.row_cols] == [[1, 3], [0, 2], [1, 3],
                                                [0, 2]]
    object.__setattr__(qcm, "sh", np.asarray([1, 1], np.int32))
    with pytest.raises(ValueError, match="clash"):
        expand_qc_multi(qcm)


def test_ar4ja_refusals_and_warning(monkeypatch):
    with pytest.raises(ValueError, match="multiple of 8"):
        ccsds.ar4ja(rate="12", M=12)
    with pytest.raises(ValueError, match="rate"):
        ccsds.ar4ja(1024, "34")
    with pytest.raises(ValueError, match="divisible"):
        ccsds.ar4ja(1026, "23")
    with pytest.warns(UserWarning, match="not a CCSDS"):
        get_code("ccsds/2048/12")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ccsds.ar4ja(rate="12", M=64)  # an explicit lifting stays silent
    with pytest.raises(ValueError, match="CCSDS spec"):
        get_code("ccsds/1024")
    # a seed that leaves lifted 4-cycles at M >= 32 is refused
    monkeypatch.setattr(ccsds, "optimize_edge_shifts",
                        lambda br, bc, M, seed: np.arange(len(br)) % 2)
    with pytest.raises(ValueError, match="4-cycles"):
        ccsds.ar4ja(rate="12", M=32)


def test_dense_encoder_matches_jax():
    spec = get_code("ccsds/1024/12")
    enc = build_encoder(spec)
    assert isinstance(enc, DenseEncoder)
    G, info = jax_sg(jax_get_code("ccsds/1024/12"))
    assert np.array_equal(enc.G, G) and np.array_equal(enc.info_cols, info)
    msg = np.random.default_rng(2).integers(0, 2, (4, spec.k), np.uint8)
    cw = enc(torch.from_numpy(msg))
    assert spec.check_syndrome(cw.numpy())
    assert torch.equal(enc.extract_message(cw), torch.from_numpy(msg))


def test_channel_zeroes_punctured_llrs():
    spec = get_code("ccsds/1024/12")
    jspec = jax_get_code("ccsds/1024/12")
    assert spec.rate == jspec.rate == 0.5  # k over the 2048 sent bits
    cw = np.zeros((8, spec.n), np.uint8)
    gen = torch.Generator().manual_seed(0)
    llr = make_channel(spec)(gen, torch.from_numpy(cw), 1.0).numpy()
    jllr = np.asarray(jax_awgn.make_channel(jspec)(
        jax.random.key(0), jnp.asarray(cw), 1.0))
    punct = np.asarray(spec.punctured_cols)
    sent = np.setdiff1d(np.arange(spec.n), punct)
    for a in (llr, jllr):
        assert np.all(a[:, punct] == 0.0) and np.all(a[:, sent] != 0.0)
    # LLR = 2y/sigma^2 with sigma^2 = 1/(2 R Eb/N0) at R = k/n_tx: the
    # mean LLR of a sent zero bit is 2/sigma^2 = 4 R Eb/N0
    want = 4 * 0.5 * 10 ** 0.1
    assert abs(llr[:, sent].mean() - want) < 0.05 * want


def test_reference_curve_file():
    """The JAX CPU reference of ccsds/4096/12 that chip_smoke.py phases 18
    and 19 hold the card's sweeps against: both packages read it."""
    import json
    import pathlib

    from ecc_ldpc_tpu.sim.runner import PointResult as JaxPointResult
    from ecc_ldpc_tpu_torch.sim import PointResult

    path = (pathlib.Path(ccsds.__file__).parent.parent / "data"
            / "ccsds_4096_12_jax_cpu.json")
    raw = json.loads(path.read_text())
    pts = [PointResult.from_json(d) for d in raw]
    assert [JaxPointResult.from_json(d).fer for d in raw] == \
        [p.fer for p in pts]
    retry = "layered/norm:0.8125/50;retry=layered/spa/50"
    assert [(p.decoder, p.ebn0_db) for p in pts] == [
        ("layered/norm:0.8125/50", 2.0), ("layered/norm:0.8125/50", 2.5),
        (retry, 1.5), (retry, 2.5)]
    for p in pts:
        assert p.code == "ccsds/4096/12" and p.frames == 8192
        assert p.fer_ci[0] < p.fer < p.fer_ci[1]
