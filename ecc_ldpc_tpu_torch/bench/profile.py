"""Where the card's time goes in each benchmark leg: torch.profiler over a
few decodes, device time summed by kernel name, and the device's idle
share of the window. Needs one CUDA card:

    python -m ecc_ldpc_tpu_torch.bench.profile

Prints one JSON line per leg. The window is the host time of `steps`
back-to-back decode calls ending in a synchronize, after a warm-up
decode; busy time is the sum of the device activities (kernels, copies,
fills) the profiler recorded in it, so idle = 1 - busy / window. Run with
tracing off, the same decodes are timed by bench/throughput.py; the
difference is the profiler's cost.
"""
from __future__ import annotations

import collections
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .throughput import LEGS, make_inputs


def profile_leg(code: str, decoder: str, batch: int, ebn0_db: float,
                steps: int = 3) -> dict:
    dev = torch.device("cuda", 0)
    x = make_inputs(code, decoder, batch, ebn0_db, dev, seed=0)
    x.decode(x.llr)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            x.decode(x.llr)
        torch.cuda.synchronize(dev)
        window_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "window_ms": window_ms, "steps": steps,
        "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / window_ms if by_name else None,
        "device_ms_by_name": {k[:80]: v for k, v in top},
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench.profile needs a CUDA card")
    for leg, cfg in LEGS.items():
        out = profile_leg(**cfg)
        print(json.dumps({"leg": leg, **out,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
