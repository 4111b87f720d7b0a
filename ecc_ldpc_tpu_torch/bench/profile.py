"""Where the card's time goes in each benchmark leg and in one step of
the production sweep: torch.profiler over a few calls, device time summed
by kernel name, and the device's idle share of the window. Needs one CUDA
card:

    python -m ecc_ldpc_tpu_torch.bench.profile

Prints one JSON line per leg (the three min-sum legs, the two exact-BP
legs, the four flooding legs, the three CCSDS legs) and one for each
production sweep step (random message, encode, channel, the retry decoder
with its layered and with its flooding fallback on DVB-S2, and on CCSDS,
tally). The window is the host time of `steps`
back-to-back calls ending in a synchronize, after a warm-up call; busy
time is the sum of the device activities (kernels, copies, fills) the
profiler recorded in it, so idle = 1 - busy / window. Run with tracing
off, the same decodes are timed by bench/throughput.py; the difference is
the profiler's cost.
"""
from __future__ import annotations

import collections
import json
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
    make_inputs,
)


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
    by_name = collections.defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_ms": window_ms, "steps": steps,
        "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / window_ms if by_name else None,
        "device_ms_by_name": {k[:80]: v for k, v in ranked},
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench.profile needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    ccsds = {f"ccsds_{cn}": cfg for cn, cfg in CCSDS_LEGS.items()}
    for leg, cfg in {**LEGS, **EXACT_LEGS, **FLOODING_LEGS, **ccsds}.items():
        out = profile_leg(**cfg)
        print(json.dumps({"leg": leg, **out, "device": name}), flush=True)
    for leg, cfg in (("production_sweep_step", PRODUCTION_SWEEP),
                     ("flooding_production_sweep_step",
                      FLOODING_PRODUCTION_SWEEP),
                     ("ccsds_production_sweep_step",
                      CCSDS_PRODUCTION_SWEEP)):
        out = profile_sweep_step(**cfg)
        print(json.dumps({"leg": leg, **out, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
