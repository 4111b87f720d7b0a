"""The port's codes, graphs and encoders against the JAX package's.

Same code string through both packages: for DVB-S2 identical base
matrices, block-edge tables and layer order, and codewords that are
bit-identical to ecc_ldpc_tpu's encode_numpy and satisfy H; for
mackay1008 the same data file, k, generator, info_cols and flooding
tables; alist files in both of their forms.
"""
import pathlib

import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder as JaxDDE
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes.qc import circulant, expand_qc, QCCode
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.encode.structured import (
    DualDiagonalEncoder,
    StaircaseEncoder,
    build_encoder,
)
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

CODES = ["dvbs2/16200/12", "dvbs2/64800/12", "dvbs2/64800/34"]


@pytest.fixture(scope="module", params=CODES)
def both(request):
    name = request.param
    return name, get_code(name), jax_get_code(name)


def test_same_code(both):
    _, spec, jspec = both
    assert (spec.n, spec.m, spec.k, spec.name) == (jspec.n, jspec.m, jspec.k,
                                                   jspec.name)
    assert spec.qc.Z == jspec.qc.Z
    assert np.array_equal(spec.qc.base, jspec.qc.base)
    assert spec.num_edges == jspec.num_edges


def test_graph_tables_match(both):
    name, spec, jspec = both
    g, jg = compile_qc_graph(spec), jax_compile_qc_graph(jspec)
    assert (g.Z, g.mb, g.nb, g.num_block_edges, g.dcb_max, g.dvb_max, g.k) \
        == (jg.Z, jg.mb, jg.nb, jg.num_block_edges, jg.dcb_max, jg.dvb_max,
            jg.k)
    assert np.array_equal(g.be_row, np.asarray(jg.be_row_np))
    assert np.array_equal(g.be_col, np.asarray(jg.be_col_np))
    assert np.array_equal(g.be_shift, np.asarray(jg.be_shift_np))
    for f in ("row_be", "row_mask", "col_be", "col_mask"):
        assert np.array_equal(getattr(g, f), np.asarray(getattr(jg, f))), f
    assert g.layer_order == jg.layer_order
    assert g.layer_groups == jg.layer_groups
    assert g.intra_layer_dup_free and jg.intra_layer_dup_free
    for i in (0, g.mb // 2, g.mb - 1):
        assert g.layer_edges(i) == [tuple(int(x) for x in t)
                                    for t in jg.layer_edges(i)]
    t = g.to("cpu")
    assert t.be_shift.dtype == torch.int32
    assert torch.equal(t.row_be, torch.as_tensor(g.row_be))
    if name == "dvbs2/64800/12":
        assert g.num_block_edges == 631
        assert spec.num_edges == 227160
        assert [d for d, _ in g.layer_groups] == [7, 8]


def test_encoder_matches_jax_and_h(both):
    _, spec, jspec = both
    enc = build_encoder(spec)
    assert isinstance(enc, DualDiagonalEncoder)
    rng = np.random.default_rng(7)
    msg = rng.integers(0, 2, (3, spec.k), dtype=np.uint8)
    ref = JaxDDE(jspec, validate=False).encode_numpy(msg)
    cw = enc(torch.from_numpy(msg)).numpy()
    assert cw.dtype == np.uint8 and cw.shape == (3, spec.n)
    assert np.array_equal(cw, ref)
    assert np.array_equal(enc.encode_numpy(msg), ref)
    assert np.array_equal(enc.extract_message(cw), msg)
    assert spec.check_syndrome(cw)


def test_staircase_encoder_on_pure_staircase():
    """A pure QC staircase parity section has no dual-diagonal special
    column, so build_encoder falls through to the staircase encoder."""
    Z, mb, kb = 8, 3, 3
    base = -np.ones((mb, kb + mb), np.int32)
    base[:, :kb] = [[1, 5, -1], [-1, 2, 7], [3, -1, 4]]
    for d in range(mb):
        base[d, kb + d] = 0
        if d + 1 < mb:
            base[d + 1, kb + d] = 0
    spec = expand_qc(QCCode(Z=Z, base=base), name="stair", k=kb * Z)
    enc = build_encoder(spec)
    assert isinstance(enc, StaircaseEncoder)
    msg = np.random.default_rng(1).integers(0, 2, (5, spec.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg)).numpy()
    assert np.array_equal(cw, enc.encode_numpy(msg))
    assert spec.check_syndrome(cw)


def test_circulant_and_registry_limits():
    P = circulant(5, 2)
    assert P.sum() == 5 and P[0, 2] == 1 and P[4, 1] == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_code("wimax/576/12")
    with pytest.raises(ValueError):
        get_code("dvbs2/64800")


def test_mackay1008_matches_jax():
    """The port's copy of the data file, its code, generator and graph
    tables are the JAX package's; the dense encoder's codewords match and
    pass H, with the message at info_cols (not a prefix)."""
    import ecc_ldpc_tpu
    from ecc_ldpc_tpu.encode.dense import systematic_generator as jax_sg
    from ecc_ldpc_tpu.graph import compile_graph as jax_compile_graph
    from ecc_ldpc_tpu_torch.codes import mackay
    from ecc_ldpc_tpu_torch.convert import dense_encoder_from_numpy
    from ecc_ldpc_tpu_torch.encode.dense import DenseEncoder
    from ecc_ldpc_tpu_torch.graph.compile import compile_graph

    jax_data = pathlib.Path(ecc_ldpc_tpu.__file__).parent / "data"
    assert mackay.PATH.read_bytes() == (jax_data / "mackay1008.alist").read_bytes()
    spec, jspec = get_code("mackay1008"), jax_get_code("mackay1008")
    assert (spec.n, spec.m, spec.k, spec.name) == (jspec.n, jspec.m, jspec.k,
                                                   jspec.name) == (
        1008, 504, 506, "mackay1008")
    assert all(np.array_equal(a, b) for a, b in zip(spec.row_cols,
                                                    jspec.row_cols))
    enc = build_encoder(spec)
    assert isinstance(enc, DenseEncoder)
    G, info = jax_sg(jspec)
    assert np.array_equal(enc.G, G) and np.array_equal(enc.info_cols, info)
    assert not np.array_equal(info, np.arange(spec.k))
    g, jg = compile_graph(spec), jax_compile_graph(jspec)
    assert (g.n, g.m, g.k, g.num_edges, g.dc_max, g.dv_max) == (
        jg.n, jg.m, jg.k, jg.num_edges, jg.dc_max, jg.dv_max)
    for f in ("cn_vn", "cn_mask", "vn_edge", "vn_mask"):
        assert np.array_equal(getattr(g, f), np.asarray(getattr(jg, f))), f
    msg = np.random.default_rng(9).integers(0, 2, (5, spec.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg)).numpy()
    assert np.array_equal(cw, (msg.astype(np.int64) @ G % 2).astype(np.uint8))
    carried = dense_encoder_from_numpy(G, info)  # the JAX generator, carried
    assert np.array_equal(carried(torch.from_numpy(msg)).numpy(), cw)
    assert spec.check_syndrome(cw)
    assert np.array_equal(enc.extract_message(torch.from_numpy(cw)).numpy(),
                          msg)


def test_alist_forms_and_registry(tmp_path, monkeypatch):
    """Padded and unpadded alist bodies read alike; 'alist:PATH' resolves;
    a missing mackay1008 data file raises FileNotFoundError."""
    from ecc_ldpc_tpu.codes.alist import dumps_alist
    from ecc_ldpc_tpu_torch.codes import alist, mackay

    jspec = jax_get_code("wimax/576/12")
    text = dumps_alist(jspec)
    padded = tmp_path / "w.alist"
    padded.write_text(text)
    spec = get_code(f"alist:{padded}")
    assert (spec.n, spec.m) == (jspec.n, jspec.m)
    assert all(np.array_equal(a, b) for a, b in zip(spec.row_cols,
                                                    jspec.row_cols))
    lines = text.splitlines()
    body = [" ".join(t for t in ln.split() if t != "0") for ln in lines[4:]]
    unpadded = alist.loads_alist("\n".join(lines[:4] + body))
    assert all(np.array_equal(a, b) for a, b in zip(unpadded.row_cols,
                                                    spec.row_cols))
    with pytest.raises(ValueError, match="alist body"):
        alist.loads_alist("\n".join(lines[:-1]))
    monkeypatch.setattr(mackay, "PATH", tmp_path / "missing.alist")
    with pytest.raises(FileNotFoundError):
        get_code("mackay1008")
