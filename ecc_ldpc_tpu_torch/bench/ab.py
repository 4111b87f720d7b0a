"""Interleaved A/B throughput comparison on the card (port of
ecc_ldpc_tpu/bench/ab.py).

A card's timings drift between processes and calls (clocks, power limit,
neighbours on the host), so two configurations compare only inside one
process, in alternating timing rounds, so that drift hits every arm
equally; the result is each arm's median and its ratio to arm 0.
Each round times `chain` back-to-back decodes of an arm's batch with CUDA
events; stream order keeps them sequential. Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..device import resolve_device
from .throughput import event_seconds, make_inputs


@dataclasses.dataclass
class ABResult:
    labels: list
    mbps: list  # per-arm median throughput
    ratios: list  # per-arm throughput relative to arm 0
    reps: int

    def json_line(self) -> str:
        return json.dumps({
            "metric": "ab_compare",
            "arms": [
                {"label": l, "mbps": round(m, 3), "vs_arm0": round(r, 4)}
                for l, m, r in zip(self.labels, self.mbps, self.ratios)
            ],
            "reps": self.reps,
        })


def ab_compare(arms, *, batch: int = 1024, ebn0_db: float = 2.5,
               chain: int = 10, reps: int = 5, device="cuda") -> ABResult:
    """arms: [(code, decoder), ...]. Builds and warms every arm first,
    then runs `reps` interleaved timing rounds (arm order fixed within a
    round so each rep samples the same drift window for all arms)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("ab_compare times the card; it has no CPU mode")
    built = []
    for code, decoder in arms:
        x = make_inputs(code, decoder, batch, ebn0_db, dev, seed=0)

        def run(x=x):
            for _ in range(chain):
                x.decode(x.llr)

        x.decode(x.llr)  # warm-up (and the build, on first use)
        built.append((run, batch * x.spec.k * chain))
    torch.cuda.synchronize(dev)
    times = [[] for _ in arms]
    for _ in range(reps):
        for i, (run, _) in enumerate(built):
            times[i].append(event_seconds(run))
    mbps = [bits / float(np.median(t)) / 1e6
            for (_, bits), t in zip(built, times)]
    return ABResult(
        labels=[f"{c}|{d}" for c, d in arms],
        mbps=mbps,
        ratios=[m / mbps[0] for m in mbps],
        reps=reps,
    )
