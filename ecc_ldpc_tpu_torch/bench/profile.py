"""Where the card's time goes in each benchmark leg and in one step of
the production sweep: torch.profiler over a few calls, device time summed
by kernel name, and the device's idle share of the window. Needs one CUDA
card:

    python -m ecc_ldpc_tpu_torch.bench.profile [LEG ...]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m ecc_ldpc_tpu_torch.bench.profile sharded_sweep_step_2x2

Prints one JSON line per leg (the three min-sum legs, the two exact-BP
legs, the four flooding legs and mackay1008's spa and minstar legs, the
three CCSDS legs, the two 8023an legs of K4's modes) and one for each production sweep step (random message,
encode, channel, the retry decoder with its layered and with its flooding
fallback on DVB-S2, on CCSDS and on 8023an, tally); with LEG names, only
those rows. A row sharded_sweep_step_BxS (named only, one process per rank
of a BxS mesh) profiles steps of the sharded sweep (bench.SHARDED_SWEEP)
on each rank: its own kernels (K1a, the generator's elementwise kernels,
K5) and its idle share; on a card that several ranks share, a kernel's
span includes the slices the card gave the other ranks. The window is
the host time of `steps` back-to-back calls ending in a synchronize,
after a warm-up call; busy time is the sum of the device activities
(kernels, copies, fills) the profiler recorded in it, so idle = 1 - busy
/ window. Run with tracing
off, the same decodes are timed by bench/throughput.py; the difference is
the profiler's cost.

`trace(profile_dir)` is the CLI's --profile-dir: a torch.profiler window
around a block, exported as a Chrome trace into the directory.
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

from .throughput import (
    CCSDS_LEGS,
    CCSDS_PRODUCTION_SWEEP,
    EXACT_LEGS,
    FLOODING_LEGS,
    FLOODING_PRODUCTION_SWEEP,
    LEGS,
    PRODUCTION_SWEEP,
    XOR_LEGS,
    XOR_PRODUCTION_SWEEP,
    make_inputs,
)


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


def profile_leg(code: str, decoder: str, batch: int, ebn0_db: float,
                steps: int = 3) -> dict:
    dev = torch.device("cuda", 0)
    x = make_inputs(code, decoder, batch, ebn0_db, dev, seed=0)
    return _profiled(lambda: x.decode(x.llr), steps, dev)


def profile_sweep_step(code: str, decoder: str, batch: int, ebn0_db: float,
                       steps: int = 4) -> dict:
    """`steps` steps of run_sweep's pipeline, each with the noise stream of
    the next step of grid point 0 (seed 0), as the sweep draws them."""
    from ..decode.flooding_qc import flooding_qc_decode_cuda
    from ..decode.layered_qc import layered_classic_cuda, layered_exact_cuda
    from ..sim.runner import Pipeline, SweepSpec, step_seed

    dev = torch.device("cuda", 0)
    pipe = Pipeline.build(SweepSpec(code=code, decoder=decoder,
                                    ebn0_db=(ebn0_db,), batch=batch), dev)
    counters, step = [], iter(range(steps + 1))

    def one():
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(0, 0, 0, next(step)))
        counters.append(pipe.step(gen, ebn0_db))

    def fallback_frames():
        # frames a fallback kernel decoded: the retry's load, if any
        return (layered_exact_cuda.frames + flooding_qc_decode_cuda.frames
                + layered_classic_cuda.frames_by_rule["spa"])

    before = fallback_frames()
    out = _profiled(one, steps, dev, top=12)
    out["frame_errors"] = sum(c[1] for c in counters)
    out["frames"] = batch * len(counters)
    out["fallback_frames"] = fallback_frames() - before
    return out


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
    ccsds = {f"ccsds_{cn}": cfg for cn, cfg in CCSDS_LEGS.items()}
    xor = {f"8023an_{leg}": cfg for leg, cfg in XOR_LEGS.items()}
    mackay = {f"mackay_{k}": dict(FLOODING_LEGS["mackay"],
                                  decoder=f"{k}/25/noet")
              for k in ("spa", "minstar")}
    legs = {**LEGS, **EXACT_LEGS, **FLOODING_LEGS, **mackay, **ccsds, **xor}
    steps = {"production_sweep_step": PRODUCTION_SWEEP,
             "flooding_production_sweep_step": FLOODING_PRODUCTION_SWEEP,
             "ccsds_production_sweep_step": CCSDS_PRODUCTION_SWEEP,
             "8023an_production_sweep_step": XOR_PRODUCTION_SWEEP}
    want = sys.argv[1:] if argv is None else argv
    sharded = [w for w in want if w.startswith("sharded_sweep_step_")]
    for leg in sharded:
        out = profile_sharded_step(leg.removeprefix("sharded_sweep_step_"))
        print(json.dumps({"leg": leg, **out, "device": name}), flush=True)
    if sharded:
        return 0
    unknown = set(want) - set(legs) - set(steps)
    if unknown:
        raise SystemExit(f"unknown legs {sorted(unknown)}; known: "
                         f"{sorted(legs) + sorted(steps)}")
    for leg, cfg in legs.items():
        if not want or leg in want:
            out = profile_leg(**cfg)
            print(json.dumps({"leg": leg, **out, "device": name}), flush=True)
    for leg, cfg in steps.items():
        if not want or leg in want:
            out = profile_sweep_step(**cfg)
            print(json.dumps({"leg": leg, **out, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
