"""Find a cell by name and run it: everything here is driven by
BENCHMARK.json and the files it names.

  cell           BENCHMARK.json `workloads` entry: its config and traffic
  configuration  the config's `file` (benchmark/configs/<config>.json),
                 with its frozen H table beside it (its key "H")
  traffic        benchmark/traffic/<traffic>.json (benchmark/traffic.py)
  kind           benchmark/kind_<kind>.py, by the traffic's "kind": builds
                 the system under test, runs the window, compares
  references     benchmark/reference/<name>.py, by the configuration's
                 "reference" (the code: H, encoder, channel) and the
                 traffic's "reference" (the decoder); reference/__init__.py
  metric         benchmark/metrics/<metric>.py: read(record) -> number or
                 None; the cell's end-to-end metrics without --trace, its
                 per-layer metrics with it (a metric with a `workloads`
                 list applies to those cells only)

A run's record (the readers' input) holds what the kind measured: the
window, the requests, the frames and their message bits, each request's
time, the set-up time, the benchmark's spans, the port's counters and the
profiler's summary in a traced run.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import inspect
import json
import pathlib
import sys

import torch

from . import traffic
from .tracing import Tracer

ROOT = pathlib.Path(__file__).resolve().parent.parent
# top-level module names no run may hold (compared whole: the port's
# package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ecc_ldpc_tpu")
PORT = "ecc_ldpc_tpu_torch"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    code_ref: object     # the configuration's code reference (a module)
    decoder_ref: object  # the traffic's decoder reference (a module)
    table: object        # the code as code_ref.load() reads its H table
    mix: traffic.Mix
    end_to_end: list
    per_layer: list
    root: pathlib.Path


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules `names`
    (default: sys.modules)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_benchmark(root=ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(name: str, root=ROOT, **overrides) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration, H
    table, traffic mix (parameters replaced by `overrides`) and metrics."""
    root = pathlib.Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    decl = {c["name"]: c for c in bench["configs"]}[w["config"]]
    path = root / decl["file"]
    with open(path) as f:
        config = json.load(f)
    mix = traffic.load(root / "benchmark" / "traffic" / f"{w['traffic']}.json",
                       w["traffic"], config, **overrides)

    def applies(m):
        return name in m.get("workloads", [name])

    code_ref = reference(config["reference"], root)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                code_ref=code_ref, decoder_ref=reference(mix.reference, root),
                table=code_ref.load(path.parent / config["H"]), mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)],
                root=root)


def reference(name: str, root=ROOT):
    """The module benchmark/reference/<name>.py (reference/__init__.py)."""
    path = pathlib.Path(root) / "benchmark" / "reference" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reference {name!r}: {path} is missing")
    return importlib.import_module(f"{__package__}.reference.{name}")


def kind(name: str, root=ROOT):
    """The module benchmark/kind_<name>.py that runs a traffic kind."""
    path = pathlib.Path(root) / "benchmark" / f"kind_{name}.py"
    if not path.is_file():
        raise KeyError(f"no traffic kind {name!r}: {path} is missing")
    return importlib.import_module(f"{__package__}.kind_{name}")


def reader(name: str, root=ROOT):
    """The read(record) function of benchmark/metrics/<name>.py."""
    path = pathlib.Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counters() -> dict:
    """{function.attribute: int} of every counter the port's modules keep
    on their functions (launches, frames, ...)."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith(PORT + ".") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            if inspect.isfunction(fn) and fn.__module__ == mod_name:
                for key, v in getattr(fn, "__dict__", {}).items():
                    if isinstance(v, int) and not isinstance(v, bool):
                        out[f"{attr}.{key}"] = v
    return out


def off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of `got` that differ from `want` (all of them where the
    shapes differ)."""
    if got.shape != want.shape:
        return want.numel()
    return int((got != want).sum())


def counter_deltas(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in counters().items()
            if v != before.get(k, 0)}


def device_info(device: torch.device, record: dict, trace: dict | None):
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": record["memory_peak_bytes"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return info


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, wrap=None, log=sys.stderr) -> dict:
    """Run one cell and return its result line (a dict; "checks" last).
    `t_start` is the host clock at the process's start, so set-up counts
    from there; `wrap` (tests only) is applied to the system under test."""
    device = torch.device(device)
    runner = kind(cell.mix.kind, cell.root)
    tracer = Tracer(trace, device)
    record, checks, failed = runner.run(cell, seed, seconds, tracer, device,
                                        t_start, wrap)
    summary = tracer.summary(runner.REQUEST_SPAN) if trace else None
    record["trace"] = summary
    if summary is not None and summary["requests_traced"] < record["requests"]:
        record["note"] = (f"the profiler recorded device work in "
                          f"{summary['requests_traced']} of "
                          f"{record['requests']} requests")
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"], cell.root)(record)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run; "
                  f"{record.get('note') or 'no data for it in this cell'}",
                  file=log)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": record["requests"],
            "failed": failed, "metrics": metrics,
            "device": device_info(device, record, summary)}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line

