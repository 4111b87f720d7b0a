"""bench/ranks.py: several rank programs in one launch, on two gloo ranks
of the CPU (spawned, meeting through a file store): the jobs run in turn
in the one process group, each job's main finds the group made, a job
that fails stops the rest, and the runner destroys only a group it made.
"""
import pathlib

import pytest
import torch
import torch.distributed as dist

from ecc_ldpc_tpu_torch.bench import ranks
from ecc_ldpc_tpu_torch.dist.mesh import maybe_init_distributed
from test_torch_ring import spawn_ranks


def _job(argv):
    """Sums rank + argv[1] over a group of both ranks made inside the job
    and writes it to argv[0]; 3 when argv[1] is "fail"."""
    assert maybe_init_distributed() is False  # the runner's group stands
    if argv[1] == "fail":
        return 3
    group = dist.new_group([0, 1])
    t = torch.tensor([dist.get_rank() + int(argv[1])])
    dist.all_reduce(t, group=group)
    (pathlib.Path(argv[0]) / f"job{argv[1]}_rank{dist.get_rank()}").write_text(
        str(int(t)))
    return 0


def _worker(rank, world, store, out_dir):
    torch.set_num_threads(1)
    maybe_init_distributed(f"file://{store}", world, rank)
    out = str(out_dir)
    assert ranks.run([(_job, [out, "1"]), (_job, [out, "5"])]) == 0
    assert ranks.run([(_job, [out, "fail"]), (_job, [out, "9"])]) == 3
    # the group was made here, not by the runner: it stands
    assert dist.is_initialized()
    dist.barrier()
    dist.destroy_process_group()


def test_jobs_run_in_turn_in_one_group(tmp_path):
    spawn_ranks(_worker, 2, tmp_path, timeout=120)
    for r in (0, 1):
        assert (tmp_path / f"job1_rank{r}").read_text() == str(0 + 1 + 1 + 1)
        assert (tmp_path / f"job5_rank{r}").read_text() == str(0 + 1 + 5 + 5)
        assert not (tmp_path / f"job9_rank{r}").exists()


def test_parse_jobs():
    assert ranks.parse_jobs(["bench.ring", "out", "--ranks", "2,4", "--",
                             "bench.sharded", "1x1", "out"]) == [
        ["bench.ring", "out", "--ranks", "2,4"],
        ["bench.sharded", "1x1", "out"]]
    assert ranks.parse_jobs(["bench.ring", "out"]) == [["bench.ring", "out"]]
    with pytest.raises(ValueError, match="empty job"):
        ranks.parse_jobs(["bench.ring", "--", "--", "bench.sharded"])
    with pytest.raises(ValueError, match="empty job"):
        ranks.parse_jobs([])
