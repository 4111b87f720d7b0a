"""The sharded Monte-Carlo sweep (port of ecc_ldpc_tpu/dist/): ranks on a
(batch, snr) grid, per-frame noise, counters summed by a ring all-reduce
(K5, csrc/ring.cu)."""

from .mesh import Mesh, MeshSpec, make_mesh, maybe_init_distributed
from .montecarlo import make_sharded_step, sharded_sweep_counters

__all__ = [
    "Mesh",
    "MeshSpec",
    "make_mesh",
    "maybe_init_distributed",
    "make_sharded_step",
    "sharded_sweep_counters",
]
