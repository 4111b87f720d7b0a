"""Profiler windows of the port: the CLI's --profile-dir exporter, and
where the card's time goes in steps of the sharded sweep on each rank.

`trace(profile_dir)` is the CLI's --profile-dir: a torch.profiler window
around a block, exported as a Chrome trace into the directory. The trace
holds the port's own `ldpc.*` spans (trace.py) beside the device's
kernels, on one clock.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m ecc_ldpc_tpu_torch.bench.profile sharded_sweep_step_2x2

A row sharded_sweep_step_BxS (one process per rank of a BxS mesh; needs a
CUDA card) profiles steps of the sharded sweep (bench.SHARDED_SWEEP) on
each rank and prints one JSON line a rank: its own kernels (K1a, the
generator's elementwise kernels, K5) and its idle share; on a card that
several ranks share, a kernel's span includes the slices the card gave the
other ranks. The window is the host time of `steps` back-to-back calls
ending in a synchronize, after a warm-up call; busy time is the sum of the
device activities (kernels, copies, fills) the profiler recorded in it, so
idle = 1 - busy / window. The single-card decode and sweep-step rows are
the benchmark's traced runs (benchmark/run.py --trace 1).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import pathlib
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(profile_dir):
    """Profile the enclosed block iff profile_dir is set: torch.profiler
    records the host and, where a card is present, its kernels, and the
    window is written to profile_dir/trace_<pid>_<n>.json (Chrome trace
    format, for chrome://tracing or Perfetto; n counts the files already
    there). Yields the path, or None when profile_dir is unset."""
    if not profile_dir:
        yield None
        return
    out = pathlib.Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{len(list(out.glob('trace_*.json')))}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


def _profiled(fn, steps: int, dev: torch.device, top: int = 8) -> dict:
    """Breakdown of `steps` calls of fn() after one warm-up call."""
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(dev)
        window_ms = (time.perf_counter() - t0) * 1e3
    # summed by the name's first 80 characters, the key printed
    by_name = collections.defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name[:80]] += evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_ms": window_ms, "steps": steps,
        "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / window_ms if by_name else None,
        "device_ms_by_name": dict(ranked),
    }


def profile_sharded_step(mesh_str: str, steps: int = 2) -> dict:
    """`steps` steps of the sharded sweep (bench.SHARDED_SWEEP) on this
    rank of a BxS mesh, run_sweep_sharded's own step, after a warm-up
    step."""
    from ..dist.mesh import MeshSpec, make_mesh, maybe_init_distributed
    from ..sim.runner import sharded_step
    from .sharded import sharded_spec

    maybe_init_distributed()
    b, s = (int(x) for x in mesh_str.split("x"))
    mesh = make_mesh(MeshSpec(batch=b, snr=s), device="cuda")
    spec = sharded_spec(steps + 1)
    with sharded_step(spec, mesh) as (_, step):
        index = iter(range(steps + 1))
        out = _profiled(
            lambda: step(spec.seed, spec.ebn0_db, next(index)).tolist(),
            steps, mesh.device, top=40)
    return {"mesh": mesh_str, "rank": mesh.rank, **out}


def main(argv=None) -> int:
    import sys

    if not torch.cuda.is_available():
        raise SystemExit("bench.profile needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    want = sys.argv[1:] if argv is None else argv
    unknown = [w for w in want if not w.startswith("sharded_sweep_step_")]
    if not want or unknown:
        raise SystemExit(f"unknown rows {unknown}; name sharded_sweep_step_BxS "
                         f"rows (the single-card rows are the benchmark's: "
                         f"benchmark/run.py --trace 1)")
    for leg in want:
        out = profile_sharded_step(leg.removeprefix("sharded_sweep_step_"))
        print(json.dumps({"leg": leg, **out, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
