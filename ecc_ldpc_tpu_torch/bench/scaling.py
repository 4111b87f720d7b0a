"""Decoded-bits/s scaling over the host's cards (port of
ecc_ldpc_tpu/bench/scaling.py).

Batch-parallel scaling: a batch of batch_per_device * d frames split into
one shard per card, each card decoding its shard with its own decoder (no
traffic between cards in the decode). Efficiency(d) = throughput(d) /
(d * throughput of the first row, d = 1 by default); ideal is 1.0, because decoding is batch-parallel, so
the numbers expose launch and host overheads only. On a one-card machine
the study is one row.

Timing: a round launches `chain` decodes on every card in turn (each
card's stream runs its own in order, the cards side by side) and ends when
every card has synchronised; host clock, median of `tries` rounds after a
warm-up round.

Usage: python -m ecc_ldpc_tpu_torch.bench.scaling [--code ...]
[--decoder ...] [--batch-per-device N]
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..device import resolve_device


def run_scaling(
    code: str = "mackay1008",
    decoder: str = "minsum/norm:0.8125/25/noet",
    batch_per_device: int = 256,
    device_counts=None,
    chain: int = 10,
    tries: int = 3,
    device="cuda",
):
    """One row per device count d (default every d of 1, 2, 4, 8, ... up
    to torch.cuda.device_count()): devices, batch, wall_s (a round's
    seconds over chain), mbps, efficiency."""
    from ..codes.registry import get_code
    from ..decode.api import choose_graph, get_decoder

    if resolve_device(device).type != "cuda":
        raise ValueError("run_scaling times the cards; it has no CPU mode")
    spec = get_code(code)
    graph = choose_graph(spec, decoder)
    cards = torch.cuda.device_count()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= cards]
    results = []
    base = None
    for d in device_counts:
        if d > cards:
            raise ValueError(f"{d} devices asked, {cards} present")
        devs = [torch.device("cuda", i) for i in range(d)]
        decs = [get_decoder(graph, decoder, device=dv) for dv in devs]
        B = batch_per_device * d
        gen = torch.Generator(device=devs[0])
        gen.manual_seed(0)
        llr = torch.randn((B, spec.n), generator=gen, device=devs[0]) * 3
        shards = [s.to(dv) for s, dv in zip(llr.split(batch_per_device), devs)]

        def round_():
            for _ in range(chain):
                for dec, s in zip(decs, shards):
                    dec(s)
            for dv in devs:
                torch.cuda.synchronize(dv)

        round_()  # warm-up (and the builds, on first use)
        walls = []
        for _ in range(tries):
            t0 = time.perf_counter()
            round_()
            walls.append((time.perf_counter() - t0) / chain)
        wall = float(np.median(walls))
        thr = B * spec.k / wall / 1e6
        if base is None:
            base = thr
        results.append(dict(
            devices=d, batch=B, wall_s=wall, mbps=round(thr, 2),
            efficiency=round(thr / (base * d), 4),
        ))
    return results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--code", default="mackay1008")
    p.add_argument("--decoder", default="minsum/norm:0.8125/25/noet")
    p.add_argument("--batch-per-device", type=int, default=256)
    args = p.parse_args(argv)
    for row in run_scaling(args.code, args.decoder, args.batch_per_device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
