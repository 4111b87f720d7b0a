"""The sharded sweep on the card, one process per rank: bench.SHARDED_SWEEP
(dvbs2/64800/12, layered/norm:0.8125/25, 1.0 and 1.1 dB, 4096 frames a
point per step) through sim.run_sweep_sharded on a BATCHxSNR mesh, under
torch.distributed.run:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m ecc_ldpc_tpu_torch.bench.sharded BxS[,BxS...] OUT_DIR [modem]

Each mesh of the list runs on a group of the first B*S of the N ranks,
one after another (so one launch covers 1x1, 2x1 and 2x2). With `modem`,
bench.SHARDED_MODEM_SWEEP instead (dvbs2/16200/12 over apsk16:r56:il, its
draws the channel's per-frame normals). Each rank of a mesh writes
OUT_DIR/sharded_BxS_rank{r}.json (sharded_BxS_modem_rank{r}.json with
`modem`): every point's counters
after SHARDED_SWEEP's steps (run after a one-step warm-up sweep), the
launches of K1a (the layered min-sum kernel) and of K5 (the ring) in that
run, the plan of that run's Ring (Ring.last_plan.line()), the sweep's frames per
second (all points' frames over the summed step times, PointResult.wall_s),
and the per-frame generator's ms for this rank's frames of one point (CUDA
events around frame_bits and frame_normals after a warm-up, one rank at a
time). Ranks beyond the host's cards share a card by time-slicing.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

from ..codes.registry import get_code
from ..decode.layered_qc import layered_decode_cuda
from ..dist.mesh import Mesh, maybe_init_distributed, rank_device
from ..dist.montecarlo import frame_bits, frame_normals
from ..dist.ring import Ring, ring_allreduce_cuda
from ..sim import StoppingRule, SweepSpec, run_sweep_sharded
from .throughput import SHARDED_MODEM_SWEEP, SHARDED_SWEEP


def sharded_spec(steps: int, cfg: dict = SHARDED_SWEEP) -> SweepSpec:
    """A sharded sweep config as a SweepSpec that stops after `steps`
    steps."""
    return SweepSpec(code=cfg["code"], decoder=cfg["decoder"],
                     ebn0_db=cfg["ebn0_db"], batch=cfg["batch"],
                     channel=cfg.get("channel", "bpsk"),
                     stopping=StoppingRule(min_frame_errors=10 ** 9,
                                           max_frames=steps * cfg["batch"]))


def generator_ms(mesh, spec: SweepSpec, n: int, k: int) -> float:
    """ms of this rank's message bits and noise for one grid point, the
    ranks timed one after another so that none shares the card then."""
    frames = torch.arange(spec.batch // mesh.batch, dtype=torch.int64,
                          device=mesh.device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for rank in range(mesh.size):
        if mesh.group is not None:
            torch.distributed.barrier(group=mesh.group)
        if rank != mesh.rank:
            continue
        for _ in range(2):  # a warm-up draw, then the timed one
            torch.cuda.synchronize(mesh.device)
            start.record()
            frame_bits(spec.seed, 0, 0, frames, k)
            frame_normals(spec.seed, 0, 0, frames, n)
            end.record()
        torch.cuda.synchronize(mesh.device)
    return start.elapsed_time(end)


def run_mesh(mesh_str: str, mesh: Mesh, cfg: dict, out_dir: pathlib.Path,
             modem: bool) -> None:
    """The sweep of `cfg` on `mesh` (this rank's place in it), its line
    written to out_dir and printed."""
    steps = cfg["steps"]
    spec = sharded_spec(steps, cfg)
    run_sweep_sharded(sharded_spec(1, cfg), mesh)  # warm-up: the kernels
    layered_decode_cuda.launches = 0
    ring_allreduce_cuda.launches = 0
    Ring.last_plan = None
    results = run_sweep_sharded(spec, mesh)
    launches = {"layered_qc": layered_decode_cuda.launches,
                "ring": ring_allreduce_cuda.launches}
    frames = sum(pr.frames for pr in results)
    code = get_code(spec.code)
    plan = Ring.last_plan.line() if mesh.size > 1 else None
    line = {
        "mesh": mesh_str, "channel": spec.channel, "rank": mesh.rank,
        "plan": plan, "device": str(mesh.device),
        "card": torch.cuda.get_device_name(mesh.device), "steps": steps,
        "counters": [dict(ebn0_db=pr.ebn0_db, frames=pr.frames,
                          bit_errors=pr.bit_errors,
                          frame_errors=pr.frame_errors,
                          iters_sum=pr.iters_sum,
                          bit_errors_sq=pr.bit_errors_sq) for pr in results],
        "launches": launches, "wall_s": results[0].wall_s,
        "frames_per_s": frames / results[0].wall_s,
        "generator_ms": generator_ms(mesh, spec, code.n, code.k),
        "generator_frames": spec.batch // mesh.batch,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"sharded_{mesh_str}{'_modem' if modem else ''}"
    (out_dir / f"{stem}_rank{mesh.rank}.json").write_text(
        json.dumps(line))
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bench.sharded needs a CUDA card")
    meshes, out_dir = args[0].split(","), pathlib.Path(args[1])
    modem = args[2:] == ["modem"]
    cfg = SHARDED_MODEM_SWEEP if modem else SHARDED_SWEEP
    joined = maybe_init_distributed()
    rank = torch.distributed.get_rank() if joined else 0
    world = torch.distributed.get_world_size() if joined else 1
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    for mesh_str in meshes:
        b, s = (int(x) for x in mesh_str.split("x"))
        if b * s > world:
            raise ValueError(f"mesh {mesh_str} needs {b * s} ranks, "
                             f"{world} launched")
        # the mesh's own group, a group of one for 1x1 too (None would be
        # every launched rank); every rank takes part in making it
        group = None
        if joined:
            group = torch.distributed.new_group(list(range(b * s)))
        if rank < b * s:
            run_mesh(mesh_str, Mesh(batch=b, snr=s, rank=rank, device=dev,
                                    group=group), cfg, out_dir, modem)
    if joined:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
