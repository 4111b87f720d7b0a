"""What the experiment scripts share: the device option, the timer and the
card's name and power limit beside every number they print."""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..bench.throughput import event_seconds
from ..device import device_name, resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; the default) or cpu (the plain "
                        "versions on the host)")
    p.add_argument("--tries", type=int, default=3,
                   help="timed calls a variant (the median is printed)")
    return p


def seconds(fn, dev: torch.device, tries: int = 3) -> float:
    """Median seconds of fn() over `tries` calls after one warm-up: CUDA
    events on the card (bench/throughput.event_seconds), the host clock
    on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        return float(np.median([event_seconds(fn) for _ in range(tries)]))
    ts = []
    for _ in range(tries):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def card(dev: torch.device) -> dict:
    """{"device": the card's name or "cpu", "nvidia_smi": its name and power
    limit as nvidia-smi gives them (None on the CPU)}."""
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    return {"device": device_name(dev), "nvidia_smi": smi}


def start(args) -> tuple:
    """(device, card dict) for parsed args; prints the card line first."""
    dev = resolve_device(args.device)
    c = card(dev)
    print(json.dumps(c), flush=True)
    return dev, c


def saves(t_full, t) -> str:
    """The TPU scripts' "saves X% of full" suffix."""
    if t_full is None or t is t_full:
        return ""
    return f"  saves {100 * (t_full - t) / t_full:5.1f}% of full"


def record(**kw) -> None:
    """One JSON line for a variant."""
    print(json.dumps(kw), flush=True)
