"""Several rank programs in one torch.distributed.run launch: each job a
module of this package with its arguments, run one after another in the
same processes and the same gloo process group, so that the ranks start,
import and reach the card once:

    python -m torch.distributed.run --standalone --nproc-per-node W \\
        -m ecc_ldpc_tpu_torch.bench.ranks \\
        bench.ring OUT --ranks 2,4 -- bench.sharded 1x1,2x1,2x2 OUT

A job's main(argv) finds the group made (dist/mesh.maybe_init_distributed
returns False) and leaves it standing; between jobs every rank frees its
cached card memory and meets the others at a barrier; the group is
destroyed after the last job. A job that returns non-zero stops the rest.
"""
from __future__ import annotations

import gc
import importlib
import sys

import torch
import torch.distributed as dist

from ..dist.mesh import maybe_init_distributed


def parse_jobs(argv: list) -> list:
    """[[module, arg, ...], ...] from the arguments, jobs split by "--"."""
    jobs, cur = [], []
    for a in argv + ["--"]:
        if a == "--":
            if not cur:
                raise ValueError(f"an empty job in {argv}")
            jobs.append(cur)
            cur = []
        else:
            cur.append(a)
    return jobs


def run(jobs: list) -> int:
    """Run each (main, argv) of `jobs` in turn inside the one process
    group; returns the first non-zero code, else 0."""
    joined = maybe_init_distributed()
    try:
        for main, argv in jobs:
            rc = main(argv)
            if rc:
                return rc
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if dist.is_initialized():
                dist.barrier()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    return run([(importlib.import_module(f"ecc_ldpc_tpu_torch.{mod}").main,
                 rest) for mod, *rest in parse_jobs(argv)])


if __name__ == "__main__":
    raise SystemExit(main())
