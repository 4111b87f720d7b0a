"""Both graph-parallel tiers (dist/graph_parallel.py) on D ranks, each
held against the single-rank flooding decoder on the same LLRs. One
process per rank, under torch.distributed.run:

    python -m torch.distributed.run --standalone --nproc-per-node W \\
        -m ecc_ldpc_tpu_torch.bench.graph_parallel OUT_DIR \\
        [--ranks D,D,...] [--device cpu]

Each D of --ranks (default W) runs on a group of the first D of the W
ranks, one after another. On a one-card host every rank decodes on
cuda:0 (ranks time-slice the card; K5 is the exchange); with --device
cpu the plain path over gloo. Each rank writes
OUT_DIR/graph_parallel_rank{r}.json with a line per D and tier: the QC
tier on dvbs2/64800/12 (32 frames at 1.2 dB,
minsum/norm:0.8125/25, track mode), bits, ok and iterations against K3
on one rank (its plain version on the CPU); the check-sharded tier on
mackay1008 (256 frames at 2.5 dB, the same decoder), bits against the
single-rank flooding decoder (K2) on the frames both decode. `pass` is
bit-identity (QC) or agreement on those frames (check-sharded); ms a
decode is the median of 3 on the host clock between barriers (the card
synchronised), with the K5 calls and launches of one decode.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..decode.api import choose_graph, get_decoder
from ..dist.graph_parallel import (
    make_graph_parallel_decoder,
    make_qc_graph_parallel_decoder,
)
from ..dist.mesh import build_per_node, maybe_init_distributed, rank_device
from ..dist.ring import ring_allreduce_cuda
from .throughput import make_inputs

DECODER = "minsum/norm:0.8125/25"
# (tier, code, frames, Eb/N0)
CASES = [("qc", "dvbs2/64800/12", 32, 1.2),
         ("check-sharded", "mackay1008", 256, 2.5)]
REPS = 3


def _ms(fn, dev, group) -> float:
    """Host ms of fn() between the group's barriers, the card
    synchronised."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group=group)
    return (time.perf_counter() - t0) * 1e3


def run_tier(tier: str, code: str, B: int, ebn0: float, dev,
             group) -> dict:
    D = dist.get_world_size(group)
    x = make_inputs(code, DECODER, B, ebn0, dev, seed=5)
    kw = dict(kind="minsum", alpha=0.8125, max_iters=25)
    if tier == "qc":
        dec = make_qc_graph_parallel_decoder(x.spec, group, device=dev, **kw)
    else:
        dec = make_graph_parallel_decoder(x.spec, group, device=dev, **kw)
    got = dec(x.llr)  # warm-up: K5's buffers
    calls0, launches0 = dec.exchange.calls, ring_allreduce_cuda.launches
    got = dec(x.llr)
    calls = dec.exchange.calls - calls0
    launches = ring_allreduce_cuda.launches - launches0
    ms = float(np.median([_ms(lambda: dec(x.llr), dev, group)
                          for _ in range(REPS)]))
    ref = get_decoder(choose_graph(x.spec, DECODER), DECODER, device=dev)(
        x.llr)
    line = dict(tier=tier, code=code, D=D, frames=B, ebn0_db=ebn0,
                decoder=DECODER, ms=ms, k5_calls=calls,
                ring_launches=launches,
                ok_frames=int(got.ok.sum().item()),
                ref_ok_frames=int(ref.ok.sum().item()))
    if tier == "qc":
        line.update(
            bits_identical=torch.equal(got.bits, ref.bits),
            ok_identical=torch.equal(got.ok, ref.ok),
            iterations_identical=torch.equal(got.iterations, ref.iterations))
        line["pass"] = (line["bits_identical"] and line["ok_identical"]
                        and line["iterations_identical"])
    else:
        both = got.ok & ref.ok
        agree = bool(torch.equal(got.bits[both], ref.bits[both]))
        line.update(both_ok=int(both.sum().item()), agree_on_ok=agree,
                    ok_syndrome=bool(x.spec.check_syndrome(
                        got.bits[got.ok].cpu().numpy())))
        line["pass"] = (agree and line["ok_syndrome"]
                        and line["both_ok"] >= 0.8 * B)
    dec.close()
    return line


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    out_dir = pathlib.Path(args[0])
    device = args[args.index("--device") + 1] if "--device" in args \
        else "cuda"
    joined = maybe_init_distributed()
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build_per_node(names=("flooding", "flooding_qc"))  # the references
    rank, world = dist.get_rank(), dist.get_world_size()
    ranks = ([int(d) for d in args[args.index("--ranks") + 1].split(",")]
             if "--ranks" in args else [world])
    tiers = []
    for D in ranks:
        group = dist.new_group(list(range(D)))  # every rank takes part
        if rank < D:
            tiers += [run_tier(*case, dev, group) for case in CASES]
    line = {"rank": rank, "device": str(dev), "tiers": tiers}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"graph_parallel_rank{rank}.json").write_text(json.dumps(line))
    print(json.dumps(line), flush=True)
    if joined:  # else the launch's runner (bench/ranks.py) made the group
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
