"""Package rules of the port: no JAX, no silent CPU fallback, no kernel
fallback; plus the CPU-reachable parts of the build and the benchmark."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ecc_ldpc_tpu_torch
from ecc_ldpc_tpu_torch import _build
from ecc_ldpc_tpu_torch.bench.throughput import (
    FLOODING_LEGS,
    H100_SFU_PER_S,
    LEGS,
    BenchResult,
    decode_bound,
    decode_ops,
    make_inputs,
    rule_of,
    run_benchmark,
)
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import get_decoder, parse_decoder_spec
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    layered_decode_cuda,
    layered_decode_plain,
    layered_exact_cuda,
    make_layered_decoder,
)
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(ecc_ldpc_tpu_torch.__file__).parent


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, leaves jax
    and ecc_ldpc_tpu out of sys.modules."""
    mods = sorted(
        "ecc_ldpc_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ecc_ldpc_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    for m in ("codes.alist", "codes.mackay", "encode.gf2", "encode.dense",
              "graph.compile", "decode.cn_ops", "decode.flooding",
              "decode.flooding_qc", "codes.ccsds", "codes.girth",
              "codes.qc", "dist", "dist.mesh", "dist.montecarlo",
              "dist.ring", "bench.ring", "bench.sharded", "decode.quant",
              "decode.cleanup", "decode.bitflip", "codes.crc"):
        assert f"ecc_ldpc_tpu_torch.{m}" in mods, m
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15


@pytest.fixture(scope="module")
def small():
    spec = get_code("dvbs2/16200/12")
    return spec, compile_qc_graph(spec)


def test_entry_points_need_cuda_unless_cpu(small):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    spec, graph = small
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_layered_decoder(graph)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_decoder(graph, "layered/norm:0.8125/25/noet")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_benchmark("dvbs2/16200/12", batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_inputs("dvbs2/16200/12", "layered/norm:0.8125/2/noet", 2, 1.0)
    with pytest.raises(ValueError, match="no CPU mode"):
        run_benchmark("dvbs2/16200/12", batch=2, device="cpu")


def test_cuda_wrapper_raises_on_cpu_tensor(small):
    spec, graph = small
    llr = torch.zeros((2, spec.n), dtype=torch.float32)
    before = (layered_decode_cuda.launches, layered_exact_cuda.launches,
              layered_exact_cuda.frames)
    with pytest.raises(ValueError, match="CUDA tensor"):
        layered_decode_cuda(graph, llr, alpha=0.8125, max_iters=2)
    for cn in ("spa", "minstar"):
        with pytest.raises(ValueError, match="layered_exact_cuda's"):
            layered_decode_cuda(graph, llr, max_iters=2, cn=cn)
        with pytest.raises(ValueError, match="CUDA tensor"):
            layered_exact_cuda(graph, llr, max_iters=2, cn=cn)
    with pytest.raises(ValueError, match="spa or minstar"):
        layered_exact_cuda(graph, llr, max_iters=2, cn="minsum")
    assert (layered_decode_cuda.launches, layered_exact_cuda.launches,
            layered_exact_cuda.frames) == before


def test_build_paths():
    lib = _build.library_path("layered_qc")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("liblayered_qc-") and lib.suffix == ".so"
    assert lib == _build.library_path("layered_qc")
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNEL_SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    assert "ring" in _build.KERNEL_SOURCES


def test_precision_libraries():
    """Each layered source builds a precision library of its own
    (-DLAYERED_PREC=1; layered_exact's in a circulant and a xor half),
    beside its f32 library, whose flags are the parent's; the wrappers
    pick the library by precision and block permutation."""
    from ecc_ldpc_tpu_torch.decode.layered_qc import _library, _source

    for src in ("layered_qc", "layered_exact", "layered_classic"):
        assert _build.LIBRARIES[src] == (src, ())
        assert "-DLAYERED_PREC=1" in _build.LIBRARIES[f"{src}_prec"][1]
        assert (_build.library_path(f"{src}_prec")
                != _build.library_path(src))
        assert _library(src, None, "xor") == src
        assert _source(f"{src}_prec") == src
    assert _library("layered_qc", ("bf16",), "xor") == "layered_qc_prec"
    assert _library("layered_exact", ("q", 5, 0.5),
                    "xor") == "layered_exact_prec_xor"
    assert _library("layered_exact", ("bf16",)) == "layered_exact_prec"
    assert "-DLAYERED_PERM=2" in _build.LIBRARIES["layered_exact_prec_xor"][1]
    assert set(_build.LIBRARIES) >= set(_build.KERNEL_SOURCES)


def test_spec_parsing_limits():
    kw = parse_decoder_spec("layered/sched:dvbs2_64800_12_T25_op2")
    assert kw["max_iters"] == 25 and kw["alpha"].dtype == np.float32
    assert parse_decoder_spec("layered/norm:0.8125/25/noet") == dict(
        kind="layered", alpha=0.8125, max_iters=25, early_term=False)
    # quantization, cleanup and the bit-flipping kinds (also behind
    # ;retry=) decode: a noiseless frame passes at once; the
    # incidence-matmul backend decodes the expanded graph, not the QC view
    graph = compile_qc_graph(get_code("dvbs2/16200/12"))
    llr = torch.full((2, graph.n), 3.0)
    for spec in ("layered/q:5:0.5/25", "layered/norm:0.8/25/cleanup",
                 "bitflip/50", "layered/norm:0.8/25;retry=gdbf/theta:-0.5/50"):
        res = get_decoder(graph, spec, device="cpu")(llr)
        assert bool(res.ok.all()) and not bool(res.bits.any()), spec
    with pytest.raises(TypeError, match="expanded graph"):
        get_decoder(graph, "minsum/25/xla-mm", device="cpu")
    with pytest.raises(ValueError):
        parse_decoder_spec("layered/norm:0.8/sched:dvbs2_64800_12_T25")


def test_bench_inputs_on_cpu_and_bound(small):
    spec, _ = small
    x = make_inputs("dvbs2/16200/12", "layered/norm:0.8125/2/noet", 3, 2.0,
                    device="cpu", seed=1)
    assert x.cw.shape == (3, spec.n) and x.llr.dtype == torch.float32
    assert spec.check_syndrome(x.cw.numpy())
    res = x.decode(x.llr)
    ref = layered_decode_plain(x.graph, x.llr, alpha=0.8125, max_iters=2,
                               early_term=False)
    assert torch.equal(res.bits, ref.bits)
    # headline: 4096 frames x 25 iterations of 227,160 edges is ops-bound
    s, form = decode_bound(64800, 227160, 4096, 4096 * 25)
    assert form == "operations" and 4.0e-3 < s < 4.3e-3
    s, form = decode_bound(64800, 227160, 4096, 0)
    assert form == "bytes" and abs(s - 4096 * 64800 * 5 / 3.35e12) < 1e-12
    # the exact rules: the longer of transcendentals at the SFU rate and
    # arithmetic at the fp32 rate (here the SFU side: 27.81 and 47.71 ms)
    s, form = decode_bound(64800, 227160, 4096, 4096 * 25, "spa", 32400)
    assert form == "operations" and 27.8e-3 < s < 27.9e-3
    s, form = decode_bound(64800, 227160, 4096, 4096 * 25, "minstar", 32400)
    assert form == "operations" and 47.6e-3 < s < 47.8e-3
    assert x.frame_errors(x.cw) == (0, 0)
    bad = x.cw.clone()
    bad[0, -1] ^= 1
    bad[1, 0] ^= 1
    assert x.frame_errors(bad) == (1, 2)
    line = BenchResult(1.0, "c", "d", 2, 25, 10, 20, 30, 0.5, 3.0, 9.0,
                       "card", "operations", 1, 2, 0.1, [0.5]).json_line()
    assert '"fer": 0.5' in line and '"device": "card"' in line
    assert '"tries_s"' not in line  # the JAX package's schema, unchanged
    assert LEGS["headline"] == dict(code="dvbs2/64800/12",
                                    decoder="layered/norm:0.8125/25/noet",
                                    batch=4096, ebn0_db=1.5)
    assert sorted(LEGS) == ["headline", "prod", "r34"]


def test_frame_errors_count_the_message_at_info_cols():
    """mackay1008's dense encoder puts the message at info_cols, which is
    not a prefix: a wrong message bit past position k is a frame error, and
    a wrong parity bit before k is not (the benchmark once counted
    bits[:, :k] as the message)."""
    x = make_inputs("mackay1008", "minsum/norm:0.8125/2/noet", 2, 3.0,
                    device="cpu", seed=1)
    info = x.enc.info_cols
    parity = np.setdiff1d(np.arange(x.spec.n), info)
    assert info[-1] >= x.spec.k and parity[0] < x.spec.k
    bad = x.cw.clone()
    bad[0, int(info[-1])] ^= 1   # a message bit past k
    assert x.frame_errors(bad) == (1, 1)
    bad = x.cw.clone()
    bad[1, int(parity[0])] ^= 1  # a parity bit before k
    assert x.frame_errors(bad) == (0, 1)
    assert x.frame_errors(x.cw) == (0, 0)


def test_flooding_bound_counts():
    """decode_ops(schedule="flooding"): layered's check work plus the VN
    accumulate and the recompute of total - C (2 per edge visit); spa's
    2*atanh makes 4 transcendentals per edge visit, not 5."""
    E, m = 227160, 32400
    assert decode_ops(E, m, "minsum", "flooding") == (0, 14 * E)
    assert decode_ops(E, m, "spa", "flooding") == (4 * E, 16 * E)
    assert decode_ops(E, m, "minstar", "flooding") == (
        12 * (E - 2 * m), 48 * (E - 2 * m) + 6 * E)
    assert decode_ops(E, m, "spa") == (5 * E, 14 * E)
    with pytest.raises(KeyError):
        decode_ops(E, m, "spa", "bp")
    s, form = decode_bound(64800, E, 4096, 4096 * 25, "spa", m, "flooding")
    assert form == "operations" and abs(s - 4096 * 25 * 4 * E / H100_SFU_PER_S) < 1e-12
    assert rule_of(parse_decoder_spec("spa/50")) == ("spa", "flooding")
    assert rule_of(parse_decoder_spec("layered/minstar/25")) == ("minstar",
                                                                  "layered")
    assert sorted(FLOODING_LEGS) == ["dvbs2_minstar", "dvbs2_minsum",
                                     "dvbs2_spa", "mackay"]
    assert FLOODING_LEGS["mackay"] == dict(
        code="mackay1008", decoder="minsum/norm:0.8125/25/noet", batch=2048,
        ebn0_db=2.5)
