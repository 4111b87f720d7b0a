"""K2 (csrc/flooding.cu) by plan on the card: the plan's own F against
other frames a tile, and the wrapper's host time against the device's.
Needs one CUDA card:

    python -m ecc_ldpc_tpu_torch.bench.flooding_probe [F,F,...]

For each case (the mackay1008 legs, fixed 25 iterations at B = 2048,
min-sum fixed at B = 4096 and 601, and the golden sweep's spa/50 and
min-sum track decodes at B = 4096 and 2048) and each F (0 = the plan's
own; default 0,1,2,4,5,6,8,11,12; an F above the batch is skipped), one
JSON line: the plan (decode/flooding.flooding_plan with F set), whether
bits, ok and iterations equal those of the plan's own F, device µs a
decode (CUDA events around 100 back-to-back decodes) and host µs a decode
(the host clock around the same 100 decodes, which are not synchronised,
so it reads the time to enqueue them while the card still works on
earlier ones). Then one line for the form "global" on
regular_graph(16384): its plan, its device µs, and whether it agrees with
the plain version. Last, the card's name and power limit as nvidia-smi
gives them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..chan.awgn import awgn_llr
from ..convert import compiled_graph_from_numpy
from ..decode import flooding as fl
from ..device import device_name
from .throughput import FLOODING_LEGS, make_inputs

# (name, decoder spec, batch, Eb/N0 dB) on mackay1008
CASES = [
    *[(f"{k}_leg", ("minsum/norm:0.8125" if k == "minsum" else k)
       + "/25/noet", FLOODING_LEGS["mackay"]["batch"],
       FLOODING_LEGS["mackay"]["ebn0_db"])
      for k in ("minsum", "spa", "minstar")],
    ("minsum_fixed_4096", "minsum/norm:0.8125/25/noet", 4096, 2.5),
    ("minsum_fixed_601", "minsum/norm:0.8125/25/noet", 601, 2.0),
    ("spa50_track_sweep", "spa/50", 4096, 1.5),
    ("minsum_track", "minsum/norm:0.8125/25", 2048, 2.0),
]
REPS = 100


def regular_graph(n: int, dv: int = 3, dc: int = 6, seed: int = 0):
    """A seeded (dv, dc)-regular CompiledGraph on n variables: each
    variable's dv sockets dealt to the n dv / dc checks by a numpy
    permutation, a check that got one variable twice swapping a socket with
    a random other check until none does."""
    m = n * dv // dc
    if m * dc != n * dv:
        raise ValueError(f"n = {n} does not give whole checks of {dc}")
    rng = np.random.default_rng(seed)
    rows = rng.permutation(np.repeat(np.arange(n), dv)).reshape(m, dc)
    while True:
        bad = [i for i in range(m) if len(set(rows[i])) < dc]
        if not bad:
            break
        for i in bad:
            j, a, b = rng.integers(m), rng.integers(dc), rng.integers(dc)
            rows[i, a], rows[j, b] = rows[j, b], rows[i, a]
    rows.sort(axis=1)
    vn_edge = np.zeros((n, dv), np.int32)
    fill = np.zeros(n, np.int64)
    for i in range(m):
        for j, c in enumerate(rows[i]):
            vn_edge[c, fill[c]] = i * dc + j
            fill[c] += 1
    return compiled_graph_from_numpy(
        n, m, n - m, rows, np.ones((m, dc), bool), vn_edge,
        np.ones((n, dv), bool), f"regular_{dv}_{dc}_{n}")


def zero_codeword_llr(graph, B: int, ebn0_db: float, dev, seed: int = 1):
    """LLRs of B all-zero codewords of `graph` over BPSK/AWGN at ebn0_db
    (rate k / n), from a seeded torch.Generator on dev."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bits = torch.zeros((B, graph.n), dtype=torch.uint8, device=dev)
    return awgn_llr(gen, bits, ebn0_db, graph.k / graph.n)


def time_decode(graph, llr, kw: dict, frames: int = 0) -> dict:
    """Device and host µs a K2 decode at F = frames (0: the plan's), and the
    last decode's result."""
    args = (graph, llr, kw["kind"], kw.get("alpha", 1.0), kw.get("beta", 0.0),
            kw.get("max_iters", 25), kw.get("early_term", True), False,
            frames)
    res, _ = fl._launch(*args)  # warm-up (and the build, on first use)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(REPS):
        res, _ = fl._launch(*args)
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    plan, blocks = fl.flooding_decode_cuda.last_plan
    return dict(plan=dict(plan.as_dict(), launched_blocks=blocks),
                device_us=start.elapsed_time(end) * 1e3 / REPS,
                host_us=host * 1e6 / REPS), res


def same(a, b) -> bool:
    return (torch.equal(a.bits, b.bits) and torch.equal(a.ok, b.ok)
            and torch.equal(a.iterations, b.iterations))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench.flooding_probe needs a CUDA card")
    dev = torch.device("cuda", 0)
    frames = [int(f) for f in
              (args[0] if args else "0,1,2,4,5,6,8,11,12").split(",")]
    for name, spec, B, ebn0 in CASES:
        x = make_inputs("mackay1008", spec, B, ebn0, dev, seed=0)
        base = None
        for F in frames:
            if F > B:
                continue
            line, res = time_decode(x.graph, x.llr, x.kw, F)
            base = res if base is None else base
            print(json.dumps(dict(case=name, decoder=spec, batch=B, frames=F,
                                  same_as_plan=same(res, base), **line)),
                  flush=True)
    g = regular_graph(16384)
    llr = zero_codeword_llr(g, 32, 2.0, dev)
    kw = dict(kind="minsum", alpha=0.8125, max_iters=25, early_term=True)
    line, res = time_decode(g, llr, kw)
    plain = fl.flooding_decode_plain(g, llr, **kw)
    print(json.dumps(dict(case="regular_16384_minsum_track", batch=32,
                          same_as_plain=same(res, plain),
                          ok_frames=int(res.ok.sum().item()), **line)),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": device_name(dev), "nvidia_smi": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
