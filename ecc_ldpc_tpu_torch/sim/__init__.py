"""Monte-Carlo BER/FER simulation harness (port of ecc_ldpc_tpu/sim/):
run (code x decoder x Eb/N0) sweeps, batching frames per step, until a
sequential stopping rule is satisfied, then report BER/FER with confidence
intervals. The sharded sweep waits for ROADMAP.md Queue 1 step 13.
"""

from .stopping import StoppingRule, wilson_interval
from .runner import PointResult, SweepSpec, run_sweep
from .report import format_table, results_to_json, curves_overlap

__all__ = [
    "StoppingRule",
    "wilson_interval",
    "PointResult",
    "SweepSpec",
    "run_sweep",
    "format_table",
    "results_to_json",
    "curves_overlap",
]
