"""The port's IEEE 802.3an code and XOR-permutation QC structure against the
JAX package: codes/ieee8023an.py (GF(64) RS-LDPC, the xor base matrix),
codes/qc.py (QCXorCode, expand_qc_xor) and graph/qc.py (the compiled
tables and their `perm`); the structured encoders refuse xor codes and the
dense generator encodes 8023an."""
import importlib

import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes.qc import QCXorCode as JaxQCXorCode
from ecc_ldpc_tpu.codes.qc import expand_qc_xor as jax_expand_qc_xor
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes import ieee8023an
from ecc_ldpc_tpu_torch.codes.ccsds import ar4ja
from ecc_ldpc_tpu_torch.codes.qc import (
    QCCode,
    QCXorCode,
    expand_qc_xor,
)
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.encode.dense import DenseEncoder
from ecc_ldpc_tpu_torch.encode.structured import (
    DualDiagonalEncoder,
    StaircaseEncoder,
    build_encoder,
)
from ecc_ldpc_tpu_torch.graph.qc import (
    compile_qc_graph,
    qc_graph_from_block_edges,
)

torch.set_num_threads(1)
# the module itself: the JAX package's codes/__init__ re-exports a function
# of the same name
jax_8023an = importlib.import_module("ecc_ldpc_tpu.codes.ieee8023an")


@pytest.fixture(scope="module")
def an():
    """(port spec, JAX spec) of 8023an."""
    return get_code("8023an"), jax_get_code("8023an")


def test_rs_ldpc_arrays_match_jax():
    assert np.array_equal(ieee8023an.rs_ldpc_H(), jax_8023an.rs_ldpc_H())
    assert np.array_equal(ieee8023an.xor_base(), jax_8023an.xor_base())
    exp, log = ieee8023an._gf64_tables()
    jexp, jlog = jax_8023an._gf64_tables()
    assert np.array_equal(exp, jexp) and np.array_equal(log, jlog)
    # another slope set and point count: the same arrays
    assert np.array_equal(ieee8023an.rs_ldpc_H(16, [1, 2, 3]),
                          jax_8023an.rs_ldpc_H(16, [1, 2, 3]))
    with pytest.raises(ValueError):
        ieee8023an.rs_ldpc_H(65)


def test_8023an_code(an):
    spec, jspec = an
    assert (spec.n, spec.k, spec.m) == (2048, 1723, 384)
    assert spec.name == "8023an" and spec.qc.perm == "xor"
    assert set(spec.row_deg) == {32} and set(spec.col_deg) == {6}
    assert spec.num_edges == 12288 and spec.qc.Z == 64
    assert len(spec.row_cols) == len(jspec.row_cols)
    for a, b in zip(spec.row_cols, jspec.row_cols):
        assert np.array_equal(a, b)
    # H is rs_ldpc_H, row for row
    assert np.array_equal(spec.dense(), ieee8023an.rs_ldpc_H())


def test_qc_xor_code_limits():
    with pytest.raises(ValueError, match="power-of-two"):
        QCXorCode(Z=12, base=np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="shift >= Z"):
        QCXorCode(Z=16, base=np.full((2, 4), 16, np.int32))
    # the circulant families keep perm "roll"
    assert QCCode(Z=4, base=np.zeros((1, 2), np.int32)).perm == "roll"
    assert ar4ja(rate="12", M=32).qc.perm == "roll"


@pytest.mark.parametrize("Z,seed", [(16, 3), (8, 5)])
def test_expand_qc_xor_matches_jax(Z, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(-1, Z, size=(4, 8)).astype(np.int32)
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toy")
    jspec = jax_expand_qc_xor(JaxQCXorCode(Z=Z, base=base), name="toy")
    assert (spec.n, spec.m, spec.k) == (jspec.n, jspec.m, jspec.k)
    for a, b in zip(spec.row_cols, jspec.row_cols):
        assert np.array_equal(a, b)
    for be, jbe in zip(spec.qc.block_edges(), jspec.qc.block_edges()):
        assert np.array_equal(be, jbe)


def test_compiled_graph_matches_jax(an):
    spec, jspec = an
    g, jg = compile_qc_graph(spec), jax_compile_qc_graph(jspec)
    assert g.perm == jg.perm == "xor"
    assert (g.Z, g.mb, g.nb, g.num_block_edges, g.dcb_max, g.dvb_max,
            g.k) == (jg.Z, jg.mb, jg.nb, jg.num_block_edges, jg.dcb_max,
                     jg.dvb_max, jg.k) == (64, 6, 32, 192, 32, 6, 1723)
    for f in ("be_row", "be_col", "be_shift", "row_be", "row_mask",
              "col_be", "col_mask"):
        assert np.array_equal(getattr(g, f), np.asarray(getattr(jg, f))), f
    assert g.layer_order == jg.layer_order
    assert g.intra_layer_dup_free and jg.intra_layer_dup_free
    for i in range(g.mb):
        assert g.layer_edges(i) == [tuple(int(v) for v in t)
                                    for t in jg.layer_edges(i)]
    # carried across from the JAX tables, perm included
    c = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name, perm=jg.perm)
    assert c.perm == "xor" and np.array_equal(c.be_shift, g.be_shift)


def test_graph_perm_validation():
    br, bc, sh = [0, 0], [0, 1], [1, 3]
    with pytest.raises(ValueError, match="perm"):
        qc_graph_from_block_edges(4, 1, 2, br, bc, sh, k=4, perm="swap")
    with pytest.raises(ValueError, match="power-of-two"):
        qc_graph_from_block_edges(6, 1, 2, br, bc, sh, k=6, perm="xor")
    g = qc_graph_from_block_edges(6, 1, 2, br, bc, sh, k=6)
    assert g.perm == "roll"


def test_encoders(an):
    """The rolling encoders refuse a xor code (ValueError, before any
    validation, even where the base has their parity shape); build_encoder
    takes the dense generator, whose codewords satisfy H."""
    spec, _ = an
    for cls in (DualDiagonalEncoder, StaircaseEncoder):
        with pytest.raises(ValueError, match="xor"):
            cls(spec)
    # a staircase-shaped xor base: the roll encoder would violate H
    base = np.array([[3, 0, -1], [5, 0, 0]], np.int32)
    stair = expand_qc_xor(QCXorCode(Z=8, base=base), name="stair")
    with pytest.raises(ValueError, match="xor"):
        StaircaseEncoder(stair)
    assert isinstance(build_encoder(stair), DenseEncoder)
    enc = build_encoder(spec)
    assert isinstance(enc, DenseEncoder) and enc.k == 1723
    msg = np.random.default_rng(8).integers(0, 2, (4, spec.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg)).numpy()
    assert spec.check_syndrome(cw) and cw.any()
    assert np.array_equal(enc.extract_message(torch.from_numpy(cw)).numpy(),
                          msg)
