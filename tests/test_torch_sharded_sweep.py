"""The port's sharded sweep (sim/runner.run_sweep_sharded) on a real gloo
group of 4 ranks (a 2x2 mesh on two nodes of two ranks, on the CPU)
against the same sweeps on one rank: identical counters on mackay1008, on 8023an (the xor graph, which
the JAX package never ran sharded) and on ccsds/1024/12 (punctured
columns), resume, the reference's raises; its FER against the JAX
package's sharded sweep on a 2x2 virtual mesh; and the CLI's --mesh under
torch.distributed.run (twin of tests/dist/test_multiprocess.py)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from ecc_ldpc_tpu_torch.cli.main import main as cli_main
from ecc_ldpc_tpu_torch.dist.mesh import (
    Mesh,
    MeshSpec,
    make_mesh,
    maybe_init_distributed,
)
from ecc_ldpc_tpu_torch.dist.ring import Ring
from ecc_ldpc_tpu_torch.sim import (
    PointResult,
    StoppingRule,
    SweepSpec,
    curves_overlap,
    run_sweep_sharded,
)
from test_torch_ring import spawn_ranks

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
CPU = torch.device("cpu")


def _spec(code, decoder, ebn0, batch, frames, seed=0):
    return SweepSpec(code=code, decoder=decoder, ebn0_db=ebn0, batch=batch,
                     seed=seed, stopping=StoppingRule(min_frame_errors=10 ** 9,
                                                      max_frames=frames))


SWEEPS = {
    "mackay": _spec("mackay1008", "minsum/norm:0.8125/10", (1.5, 2.0), 16, 32),
    "8023an": _spec("8023an", "layered/norm:0.8125/10", (3.0, 3.6), 8, 16),
    "ccsds": _spec("ccsds/1024/12", "layered/norm:0.8125/10", (1.0, 2.0), 8,
                   16),
    # the slice against the JAX package: FER between 0.02 and 0.3
    "vs_jax": _spec("mackay1008", "minsum/norm:0.8125/25", (1.5, 2.0), 512,
                    1024, seed=3),
}
COUNTED = ("frames", "bit_errors", "frame_errors", "iters_sum",
           "bit_errors_sq", "steps")


def _counted(results) -> list:
    return [{f: getattr(pr, f) for f in COUNTED} for pr in results]


def _sweep_worker(rank, world, store, out_dir):
    torch.set_num_threads(1)
    # two nodes of two ranks, as two torch.distributed.run agents say
    os.environ["GROUP_RANK"] = str(rank // 2)
    maybe_init_distributed(f"file://{store}", world, rank)
    mesh = make_mesh(MeshSpec(batch=2, snr=2), device="cpu")
    assert (mesh.rank, mesh.group is not None) == (rank, True)
    out = {name: [pr.to_json() for pr in run_sweep_sharded(spec, mesh)]
           for name, spec in SWEEPS.items()}
    out["plan"] = Ring.last_plan.line()  # the last sweep's Ring's
    # resume: one step, then the whole sweep from the state rank 0 wrote
    state = str(pathlib.Path(out_dir) / "resume_state.json")
    first = dataclasses.replace(SWEEPS["mackay"],
                                stopping=StoppingRule(10 ** 9, 16))
    out["resume_first"] = [pr.to_json() for pr in run_sweep_sharded(
        first, mesh, resume_path=state)]
    out["resume"] = [pr.to_json() for pr in run_sweep_sharded(
        SWEEPS["mackay"], mesh, resume_path=state)]
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    spawn_ranks(_sweep_worker, WORLD, out)
    lines = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    plans = [line.pop("plan") for line in lines]
    return {name: [[PointResult.from_json(d) for d in line[name]]
                   for line in lines] for name in lines[0]}, out, plans


@pytest.mark.parametrize("name", ["mackay", "8023an", "ccsds"])
def test_2x2_counters_equal_one_rank(ranks, name):
    """Every rank of the 2x2 mesh returns the counters one rank computes
    alone (the same frames, the same noise), and the sweep saw errors."""
    got, *_ = ranks
    want = run_sweep_sharded(SWEEPS[name], Mesh(1, 1, device=CPU))
    spec = SWEEPS[name]
    for r in range(WORLD):
        assert _counted(got[name][r]) == _counted(want), (name, r)
    assert [pr.frames for pr in want] == [spec.stopping.max_frames] * 2
    assert want[0].bit_errors > 0
    assert want[0].iters_sum > 0


def test_2x2_mesh_on_two_nodes(ranks):
    """The 2x2 mesh above ran on two nodes of two ranks (GROUP_RANK = rank
    // 2), and the sweep's Ring on each rank planned for that: its node
    peer through CUDA IPC, the other node through host memory. On the CPU
    only the plan is checked; the sums take the plain version (the
    counters are one rank's, test above)."""
    *_, plans = ranks
    assert plans == ["ring: rank 0 D=4 node 0/2 ipc=[0,1] host=[2,3]",
                     "ring: rank 1 D=4 node 0/2 ipc=[0,1] host=[2,3]",
                     "ring: rank 2 D=4 node 1/2 ipc=[2,3] host=[0,1]",
                     "ring: rank 3 D=4 node 1/2 ipc=[2,3] host=[0,1]"]


def test_resume_continues_the_same_frames(ranks):
    got, out, _ = ranks
    fresh = _counted(got["mackay"][0])
    for r in range(WORLD):
        assert [pr.steps for pr in got["resume_first"][r]] == [1, 1]
        assert _counted(got["resume"][r]) == fresh
    state = json.loads((out / "resume_state.json").read_text())
    key = SWEEPS["mackay"].point_key(1.5)
    assert state[key]["steps"] == 2 and state[key]["frames"] == 32


def test_reference_raises():
    # rank 0 of four: the checks come before any collective
    mesh = Mesh(batch=2, snr=2, device=CPU)
    with pytest.raises(ValueError, match="do not divide over snr=2"):
        run_sweep_sharded(_spec("mackay1008", "minsum/10", (1.0, 2.0, 3.0),
                                8, 8), mesh)
    with pytest.raises(ValueError, match="batch 5 does not divide over 2"):
        run_sweep_sharded(_spec("mackay1008", "minsum/10", (1.0, 2.0), 5, 5),
                          mesh)
    with pytest.raises(ValueError, match="host-level"):
        run_sweep_sharded(_spec("dvbs2/16200/12",
                                "layered/norm:0.8125/8;retry=layered/spa/8",
                                (1.0, 2.0), 8, 8), mesh)
    # every channel runs sharded; a symbol channel on a punctured code is
    # refused as build_channel refuses it
    spec = dataclasses.replace(SWEEPS["mackay"], code="nr5g/bg2/52",
                               channel="qpsk")
    with pytest.raises(NotImplementedError, match="punctured"):
        run_sweep_sharded(spec, mesh)


def test_fer_overlaps_the_jax_sharded_sweep(ranks):
    """The JAX package's run_sweep_sharded on a 2x2 virtual mesh and the
    port's on a 2x2 gloo group, same code, decoder, points and frame count:
    their noise streams differ by design (threefry against Philox), so
    their FER curves must overlap, not match; both runs are deterministic."""
    import jax

    from ecc_ldpc_tpu.dist import MeshSpec as JaxMeshSpec
    from ecc_ldpc_tpu.dist import make_mesh as jax_make_mesh
    from ecc_ldpc_tpu.sim import StoppingRule as JaxStoppingRule
    from ecc_ldpc_tpu.sim import SweepSpec as JaxSweepSpec
    from ecc_ldpc_tpu.sim.runner import run_sweep_sharded as jax_sharded

    spec = SWEEPS["vs_jax"]
    mesh = jax_make_mesh(JaxMeshSpec(batch=2, snr=2), devices=jax.devices()[:4])
    theirs = jax_sharded(JaxSweepSpec(
        code=spec.code, decoder=spec.decoder, ebn0_db=spec.ebn0_db,
        batch=spec.batch, seed=spec.seed, backend="xla",
        stopping=JaxStoppingRule(min_frame_errors=10 ** 9,
                                 max_frames=spec.stopping.max_frames)), mesh)
    theirs = [PointResult.from_json(p.to_json()) for p in theirs]
    got, *_ = ranks
    ours = got["vs_jax"][0]
    assert [p.frames for p in ours] == [p.frames for p in theirs] == [1024] * 2
    for p in ours + theirs:
        assert 0.01 < p.fer < 0.4, p
    assert curves_overlap(ours, theirs, "fer")


def test_cli_mesh_under_torchrun_matches_one_rank(tmp_path):
    """torch.distributed.run with 2 processes, --mesh 2x1 --device cpu,
    writes the results --mesh 1x1 writes in one process (rank 0 writes)."""
    args = ["sweep", "--code", "mackay1008", "--decoder",
            "minsum/norm:0.8125/10", "--ebn0", "1.5,2.0", "--batch", "16",
            "--max-frames", "32", "--min-frame-errors", "1000000",
            "--device", "cpu"]
    two = tmp_path / "two.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "ecc_ldpc_tpu_torch.cli", *args,
         "--mesh", "2x1", "--out", str(two)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    one = tmp_path / "one.json"
    assert cli_main(args + ["--mesh", "1x1", "--out", str(one)]) == 0
    got, want = json.loads(two.read_text()), json.loads(one.read_text())
    for d in got + want:
        d.pop("wall_s")
    assert got == want and len(got) == 2
    assert got[0]["frame_errors"] > 0
