"""K5 (csrc/ring.cu) on D ranks of one card against its plain version, with
gloo's all_reduce on the same CUDA tensors timed beside it as the library
yardstick (the port never calls it). One process per rank, under
torch.distributed.run, on one node or on several:

    python -m torch.distributed.run --standalone --nproc-per-node W \\
        -m ecc_ldpc_tpu_torch.bench.ring OUT_DIR [--ranks G,G,...] [--check]
    # two nodes of one host: one agent a node, i = 0 and 1
    python -m torch.distributed.run --nnodes 2 --node-rank i \\
        --nproc-per-node W --master-addr 127.0.0.1 --master-port P \\
        -m ecc_ldpc_tpu_torch.bench.ring OUT_DIR --ranks 2,0+2,4

Each group G of --ranks (default every rank) runs on its own, one after
another: a number D is the first D ranks, a list joined by "+" those
ranks (0+2: rank 0 and rank 2, one rank of each node above). The Ring of
each group takes its route from the ranks' nodes: CUDA IPC within a node,
host memory across nodes. Each rank writes OUT_DIR/ring_rank{r}.json: for
each group it is in and each case (f32 and int64 at the sweep counters'
shape [2, 4], at a ragged 1001 elements, and at 16 MiB per rank) its
Ring's plan, whether K5's sum is bit-identical to the plain version's and
to every other rank's, K5's launches, and ms per call of K5, of the plain
version and of gloo's all_reduce (host clock around back-to-back calls
ending in a synchronize, after a warm-up), beside the bound (ring_bound)
and K5's device time per call (its push and sum kernels under
torch.profiler): the rest of its ms is launches, the host's wait for the
peers' records, the exchange across nodes and the device's wait for the
peers' pushes. With --check only the plan, the identities and the
launches (no timing); with --exchange one more case, the 29 MB f32 block of
one graph-parallel QC exchange (EXCHANGE_CASE).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ..dist.mesh import maybe_init_distributed, rank_device
from ..dist.ring import Ring, ring_allreduce_cuda, ring_allreduce_plain
from .throughput import H100_FP32_OPS_PER_S, H100_HBM_BYTES_PER_S

# (name, dtype, shape per rank, timed calls)
CASES = [
    ("counters", torch.int64, (2, 4), 50),
    ("counters", torch.float32, (2, 4), 50),
    ("ragged", torch.float32, (1001,), 50),
    ("ragged", torch.int64, (1001,), 50),
    ("16MiB", torch.float32, (4 << 20,), 10),
    ("16MiB", torch.int64, (2 << 20,), 10),
]
# with --exchange: one exchange of the graph-parallel QC tier's messages on
# dvbs2/64800/12 at 32 frames (631 block-edges x Z 360 x 32, f32, 29 MB)
EXCHANGE_CASE = ("qc_exchange", torch.float32, (631 * 360 * 32,), 10)


def ring_bound(D: int, nbytes: int, numel: int) -> tuple:
    """(seconds, form): the least time one H100 could take for the sum of D
    blocks of nbytes (numel elements) held by D ranks of the card, each rank
    receiving the sum: every input read once and every output written once
    (2 D nbytes over HBM), against D (D - 1) numel additions at the fp32
    rate outside the tensor cores."""
    t_bytes = 2 * D * nbytes / H100_HBM_BYTES_PER_S
    t_ops = D * (D - 1) * numel / H100_FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _inputs(dtype, shape, D: int, rank: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(1000 * D + rank)
    if dtype == torch.float32:
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        x = rng.integers(-(1 << 40), 1 << 40, size=shape, dtype=np.int64)
    return torch.as_tensor(x, device=dev)


def _ms(fn, reps: int, dev, group=None) -> float:
    fn()
    torch.cuda.synchronize(dev)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _device_ms(fn, reps: int, dev) -> float:
    """Device ms per call of the ring library's kernels in `reps` calls."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("namespace)::push_kernel(" in e.name
                  or "namespace)::sum_kernel<" in e.name))
    return us / 1e3 / reps


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()


def run_cases(dev, group=None, timed: bool = True, cases=CASES) -> list:
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    out = []
    for name, dtype, shape, reps in cases:
        x = _inputs(dtype, shape, D, rank, dev)
        nbytes = x.numel() * x.element_size()
        with Ring(group, dev, nbytes) as ring:
            before = ring_allreduce_cuda.launches
            got = ring_allreduce_cuda(x, ring)
            launches = ring_allreduce_cuda.launches - before
            want = ring_allreduce_plain(x, group)
            same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            digests = [None] * D
            dist.all_gather_object(digests, _digest(got), group=group)
            err = (got.double() - want.double()).abs().max().item()
            case = dict(case=name, dtype=str(dtype).split(".")[-1],
                        shape=list(shape), bytes=nbytes, D=D,
                        plan=ring.plan.line(), nodes=ring.plan.nodes,
                        identical_to_plain=same,
                        ranks_identical=len(set(digests)) == 1,
                        max_abs_err=err, launches=launches)
            if timed:
                case["ms"] = _ms(lambda: ring_allreduce_cuda(x, ring), reps,
                                 dev, group)
                case["device_ms"] = _device_ms(
                    lambda: ring_allreduce_cuda(x, ring), 5, dev)
        if timed:
            case["plain_ms"] = _ms(lambda: ring_allreduce_plain(x, group),
                                   reps, dev, group)
            buf = x.clone()
            case["gloo_all_reduce_ms"] = _ms(
                lambda: dist.all_reduce(buf, group=group), reps, dev, group)
            bound_s, case["bound_by"] = ring_bound(D, nbytes, x.numel())
            case["bound_ms"] = bound_s * 1e3
        out.append(case)
    return out


def parse_groups(spec: str, world: int) -> list:
    """--ranks: each comma-separated entry a number D (the first D ranks)
    or ranks joined by "+"."""
    groups = [[int(r) for r in g.split("+")] if "+" in g
              else list(range(int(g))) for g in spec.split(",")]
    for g in groups:
        if not g or max(g) >= world or sorted(set(g)) != g:
            raise ValueError(f"--ranks {spec}: group {g} is not ascending "
                             f"ranks below {world}")
    return groups


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench.ring needs a CUDA card")
    out_dir = pathlib.Path(args[0])
    joined = maybe_init_distributed()
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = parse_groups(args[args.index("--ranks") + 1]
                          if "--ranks" in args else str(world), world)
    cases = []
    for ranks in groups:
        group = dist.new_group(ranks)  # every rank takes part
        if rank in ranks:
            cases += run_cases(dev, group, timed="--check" not in args,
                               cases=CASES + [EXCHANGE_CASE] * (
                                   "--exchange" in args))
    line = {"rank": rank, "device": str(dev),
            "card": torch.cuda.get_device_name(dev), "cases": cases}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"ring_rank{rank}.json").write_text(json.dumps(line))
    print(json.dumps(line), flush=True)
    if joined:  # else the launch's runner (bench/ranks.py) made the group
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
