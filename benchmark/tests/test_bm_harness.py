"""The harness on the CPU: cells, configurations, traffic and metrics found
by name, a new cell taken from files alone, the statistics, the result
line, and the refusal without a card or without the port."""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

from benchmark import harness, stats

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_cell_resolves():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.table.n == cell.config["n"] and cell.table.k == cell.config["k"]
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for name in names:
            assert callable(harness.reader(name))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_rate_is_all_work_over_the_window_and_p95_is_over_all_requests():
    rec = {"kind": "decode", "frames": 30 * 4096, "k": 32400,
           "window_s": 20.5, "request_ms": [50.0] * 19 + [500.0]}
    assert harness.reader("decode_mbps")(rec) == 30 * 4096 * 32400 / 20.5 / 1e6
    assert harness.reader("decode_ms_p95")(rec) == 50.0
    rec["request_ms"] = [50.0] * 18 + [400.0, 500.0]
    assert harness.reader("decode_ms_p95")(rec) == 400.0
    assert stats.percentile(range(1, 101), 95) == 95
    sweep = {"kind": "sweep", "frames": 7 * 4096, "window_s": 2.0,
             "request_ms": list(range(1, 21))}
    assert harness.reader("sweep_frames_per_s")(sweep) == 7 * 4096 / 2.0
    assert harness.reader("sweep_step_ms_p95")(sweep) == 19
    assert harness.reader("decode_mbps")(sweep) is None


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["ecc_ldpc_tpu_torch", "ecc_ldpc_tpu_torch.decode.api", "numpy",
         "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "ecc_ldpc_tpu.codes"]) == ["ecc_ldpc_tpu", "flax", "jax", "jaxlib"]


def _copy_without_port(tmp_path) -> pathlib.Path:
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    return dst


def _run(cwd, *args, env_path=None):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    if env_path:
        env["PYTHONPATH"] = env_path
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_run_refuses_without_a_card():
    p = _run(ROOT, "benchmark/run.py", "--workload",
             "nr5g_bg1_z384.decode25", "--seed", "3", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""


def test_run_fails_with_only_the_benchmark(tmp_path):
    dst = _copy_without_port(tmp_path)
    p = _run(dst, "benchmark/run.py", "--workload",
             "nr5g_bg1_z384.decode25", "--seed", "3", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""


DRIVER = """
import json, sys, time
t = time.perf_counter()
from benchmark import harness
cell = harness.find_cell(sys.argv[1], batch=2, pool=2, compare=1)
line = harness.run_cell(cell, 2**31 + 7, 0.05, sys.argv[2] == "1", "cpu", t)
print(json.dumps({"line": line, "forbidden": harness.forbidden_modules()}))
"""


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new traffic mix, a new cell and a new per-layer metric, added as
    files and entries in a copy: the harness runs the new cell and reports
    the new metric, its result line has the contract's keys in order, and
    no module of JAX or the JAX package was loaded."""
    dst = _copy_without_port(tmp_path)
    (dst / "benchmark" / "traffic" / "decode5.json").write_text(json.dumps(
        {"kind": "decode", "decoder": "layered/norm:0.8125/5/noet",
         "reference": "layered", "batch": 4096, "pool": 8, "compare": 2, "ebn0_db": 1.2}))
    (dst / "benchmark" / "metrics" / "calls_traced.py").write_text(
        "def read(record):\n"
        "    t = record.get('trace')\n"
        "    return None if t is None else t['requests_traced']\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "nr5g_bg1_z384.decode5", "config": "nr5g_bg1_z384",
         "traffic": "decode5", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "dvbs2_64800_r12.decode25" in m.get("workloads", []):
            m["workloads"].append("nr5g_bg1_z384.decode5")
    bench["per_layer"].append(
        {"name": "calls_traced", "unit": "calls", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "decode_mbps",
         "workloads": ["nr5g_bg1_z384.decode5"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in ("0", "1"):
        p = _run(dst, "-c", DRIVER, "nr5g_bg1_z384.decode5", trace,
                 env_path=f"{dst}:{ROOT}")
        assert p.returncode == 0, p.stderr[-3000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        line = out["line"]
        assert out["forbidden"] == []
        assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["device"]["platform"] == "cpu"
        if trace == "1":
            assert "calls_traced" in line["metrics"]
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(line["metrics"]) == {"decode_mbps", "decode_ms_p95",
                                            "setup_s"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}


DRIVER_REFS = """
import json, sys, time
t = time.perf_counter()
from benchmark import harness
cell = harness.find_cell(sys.argv[1], batch=2, pool=2, compare=1)
line = harness.run_cell(cell, 2**31 + 11, 0.05, False, "cpu", t)
print(json.dumps({"line": line, "kind": cell.mix.kind,
                  "code": sys.modules["benchmark.reference.qc_copy"].SEEN,
                  "decoder": sys.modules["benchmark.reference.layered_copy"].SEEN}))
"""


def test_a_kind_and_references_added_as_files_alone_run(tmp_path):
    """A new traffic kind, a new code reference and a new decoder
    reference, each a file of its own, with a new configuration, mix and
    cell that name them: the harness finds each by its file and runs the
    cell with them; a name whose file is missing is refused."""
    dst = _copy_without_port(tmp_path)
    bm = dst / "benchmark"
    (bm / "kind_decode_copy.py").write_text(
        "from .kind_decode import REQUEST_SPAN, run  # noqa: F401\n")
    (bm / "reference" / "qc_copy.py").write_text(
        "from . import qc_dual_diagonal as base\n"
        "from .qc import check_registered, load  # noqa: F401\n"
        "SEEN = []\n"
        "def encode(table, msg):\n"
        "    SEEN.append('encode')\n"
        "    return base.encode(table, msg)\n"
        "def llr(table, cw, noise, ebn0_db, precision='f32'):\n"
        "    SEEN.append('llr')\n"
        "    return base.llr(table, cw, noise, ebn0_db, precision)\n")
    (bm / "reference" / "layered_copy.py").write_text(
        "from . import layered\n"
        "from .layered import parse  # noqa: F401\n"
        "SEEN = []\n"
        "def decode(table, llr, parsed, precision='f32'):\n"
        "    SEEN.append(llr.shape[0])\n"
        "    return layered.decode(table, llr, parsed, precision)\n")
    config = json.loads((bm / "configs" / "nr5g_bg1_z384.json").read_text())
    config.update(name="nr5g_bg1_z384_copy", reference="qc_copy")
    (bm / "configs" / "nr5g_bg1_z384_copy.json").write_text(json.dumps(config))
    mix = {"kind": "decode_copy", "decoder": "layered/norm:0.8125/5/noet",
           "reference": "layered_copy", "batch": 4096, "pool": 8,
           "compare": 2, "ebn0_db": 1.2}
    (bm / "traffic" / "decode_copy.json").write_text(json.dumps(mix))
    mix.update(kind="no_such_kind")
    (bm / "traffic" / "decode_nokind.json").write_text(json.dumps(mix))
    mix.update(kind="decode", reference="no_such_reference")
    (bm / "traffic" / "decode_noref.json").write_text(json.dumps(mix))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "nr5g_bg1_z384_copy", "source": "a test configuration",
         "file": "benchmark/configs/nr5g_bg1_z384_copy.json", "reduced": [],
         "why": "a test configuration"})
    for traffic in ("decode_copy", "decode_nokind", "decode_noref"):
        bench["workloads"].append(
            {"name": f"nr5g_bg1_z384_copy.{traffic}",
             "config": "nr5g_bg1_z384_copy", "traffic": traffic, "chips": 1,
             "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("decode_mbps", "decode_ms_p95"):
            m["workloads"].append("nr5g_bg1_z384_copy.decode_copy")
    bench["per_layer"][0]["workloads"].append("nr5g_bg1_z384_copy.decode_copy")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    p = _run(dst, "-c", DRIVER_REFS, "nr5g_bg1_z384_copy.decode_copy",
             env_path=f"{dst}:{ROOT}")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["kind"] == "decode_copy"
    assert out["code"] == ["encode", "llr"] * 2
    assert out["decoder"] == [2]
    assert out["line"]["correct"] is True
    assert set(out["line"]["metrics"]) == {"decode_mbps", "decode_ms_p95",
                                           "setup_s"}
    for traffic, missing in (("decode_nokind", "kind_no_such_kind.py"),
                             ("decode_noref", "no_such_reference.py")):
        p = _run(dst, "-c", DRIVER_REFS, f"nr5g_bg1_z384_copy.{traffic}",
                 env_path=f"{dst}:{ROOT}")
        assert p.returncode != 0 and missing in p.stderr
