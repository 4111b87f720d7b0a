"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and exits non-zero):
  1. device  — the card's name and nvidia-smi's name and power limit.
  2. build   — nvcc builds every kernel of the path into build/kernels/.
  3. kernel vs plain — the CUDA layered kernel against its plain PyTorch
     version on the same LLRs on the card: bits, ok, iterations and the
     final posteriors must be identical (fixed and track mode, rate 1/2,
     3/4 and 9/10 — row
     degrees 7-8, 14-15 and 30-31, one build of the kernel each — scalar
     and offset alpha/beta, the learned schedule, the stored trap batch,
     and each main-path leg's shapes), and the tile plans
     (decode/layered_qc.tile_plan): the 32-frame cases take clusters of 4
     (DSMEM), 13 frames the fallback's plan (one frame to a cluster of 8),
     8023an at 601 frames a cluster of one with a ragged last tile, and
     the leg shapes a cluster of one a frame with the lowest-degree
     block-columns in the L2 scratch. Each case prints its plan and the
     clusters resident (cudaOccupancyMaxActiveClusters); the cases must
     include a plan with CS > 1 and one with CS = 1.
  4. main path — the three benchmark legs through bench.run_benchmark
     (headline dvbs2/64800/12 fixed-25 at batch 4096; rate 3/4; the
     production leg with early termination and the learned schedule),
     with the kernel's launch count read around them.
  5. waterfall — frame error rates at 0.95 and 1.2 dB inside bands set
     from curves/dvbs2_64800_12_tpu_golden.json (same surrogate code; a
     frame error is a wrong message bit, as the golden sweep counted).
  6. exact kernel vs plain — the layered exact-BP kernel (spa and
     minstar) against its plain version on the same LLRs on the card:
     rate 1/2 fixed at 1.0 dB and track at 1.2 dB (32 frames, and 13
     for a ragged last tile), rate 3/4 fixed at 3.0 dB, rate 9/10 fixed
     at 4.0 dB and track at 3.8 dB (its 8-, 16- and 32-wide builds), the
     stored trap batch with layered/spa/50, each rule at the timed
     shape (4096 frames), and 8023an at 601 frames (CS = 1, ragged).
     Bits, ok and iterations must be identical, and the posteriors after
     one sweep within EXACT_MAX_ULPS; plans printed and gated as in 3.
  7. exact kernel timed — run_benchmark on dvbs2/64800/12 with
     layered/spa/25/noet and layered/minstar/25/noet at 4096 frames,
     1.5 dB: ms, launches, bound, plain ms, FER <= 0.01.
  8. sweep vs golden — run_sweep of layered/norm:0.8125/25 at 1.0, 1.05
     and 1.1 dB (batch 2048, 100 frame errors or 32768 frames) must
     overlap the golden FER curve (report.curves_overlap).
  9. production inputs — the production sweep's first batch of 4096
     frames at 1.5 dB, drawn as run_sweep draws it, through the min-sum
     kernel and its plain version with the primary layered/norm:0.8125/50
     (track mode); the rows it failed through the exact kernel and its
     plain version with the fallback layered/spa/50; criteria as in 3
     and 6, plans printed.
  10. production path — the CLI's sweep with the production retry decoder
     layered/norm:0.8125/50;retry=layered/spa/50 at 1.5 dB, 65536 frames
     in batches of 4096: FER <= 1.5e-4, the fallback fired, the exact
     kernel launched; then the 8 trap frames through the same decoder:
     the primary fails all 8 and the retry recovers each codeword.
  11. flooding kernel vs plain — K2 (csrc/flooding.cu) against its plain
     version on mackay1008 on the same LLRs on the card: minsum fixed at
     2.5 dB and track at 2.0 dB, spa and minstar fixed and track at
     1.5 dB (32 frames; 13, a frame a tile), each rule in track mode
     at 601 frames (F >= 2, a ragged last tile) and minsum fixed there,
     minsum track at 2048 frames (tiles of 2 whose frames stop at
     different iterations), each rule at the timed leg's shape (2048
     frames), and the form "global" on a seeded (3,6)-regular n = 16384
     graph (bench/flooding_probe.regular_graph; the all-zero codeword's
     LLRs), minsum track and spa fixed. Bits, ok and iterations identical;
     posteriors after one iteration within EXACT_MAX_ULPS. Each case
     prints its plan (decode/flooding.flooding_plan: a tile's whole state
     in one block's shared memory, form "chip", or in a device-memory
     scratch, form "global") and the blocks launched; the cases must
     include both forms, a ragged tile of F >= 2 and such a track tile.
  12. QC flooding kernel vs plain — K3 (csrc/flooding_qc.cu) the same
     way on dvbs2/64800/12, each rule: fixed at 1.5 dB and track at 1.2
     dB (32 and 13 frames), r=3/4 fixed at 3.0 dB and r=9/10 fixed at 4.0
     dB (its 16- and 32-wide builds), the stored trap batch with spa/50,
     and each timed leg's shape (4096 frames). Each case prints the tile
     plan (decode/layered_qc.tile_plan, form "flooding": a dvbs2/64800
     frame over a cluster of 8, its whole decoder state on chip) and the
     clusters resident.
  13. flooding legs timed — bench.FLOODING_LEGS through run_benchmark
     (mackay1008 minsum, and spa and minstar on the same shape; the three
     dvbs2/64800/12 flooding legs): ms, Mbit/s, launches, bound, plain ms,
     FER (mackay1008 <= 0.01; the DVB-S2 legs are held to no band: the
     repo stores no flooding FER for that code); each mackay1008 leg also
     K2's device and host µs a decode (bench/flooding_probe.time_decode)
     and its plan.
  14. mackay1008 sweep vs golden — run_sweep of spa/50 and
     minsum/norm:0.8125/25 at 1.5 and 2.0 dB (batch 4096, 100 frame
     errors or 65536 frames) must overlap curves/mackay1008_tpu_golden.json
     and curves/mackay1008_cpu_golden.json.
  15. flooding fallback in production — the CLI's sweep with
     layered/norm:0.8125/50;retry=spa/50 at 1.5 dB, 65536 frames in
     batches of 4096: FER <= 1.5e-4, K1a and K3 launched, the fallback
     got frames; then the 8 trap frames: the primary fails all 8 and the
     flooding retry recovers each codeword.
  16. classic kernel vs plain — K1b/K1c' (csrc/layered_classic.cu, graphs
     that repeat a block-column in a layer) against its plain version on
     ccsds/4096/12, /23 and /45 (row degrees 6, 10 and 18: its 8-, 16- and
     32-wide builds), each rule fixed and track (32 frames, and 13 for a
     ragged last tile) at an Eb/N0 where some of 32 frames fail; min-sum
     also with offset:0.15 and the per-iteration schedule
     dvbs2_64800_12_T25; each rule at the timed shape (4096 frames, a
     frame an SM); each rule in track mode on ccsds/1024/12 at 601 frames
     (several frames a tile, a ragged last tile) and on ccsds/16384/12 at
     16 frames (a frame over a cluster of 8; the all-zero codeword's LLRs,
     since the port cannot encode k = 16384 yet); two K3 cases (spa fixed
     and track) on the multi-edge ccsds/4096/12 and one on ccsds/4096/45 at
     601 frames (its LLRs read from [B, n], not held on chip). Bits, ok and
     iterations identical; posteriors after one sweep within
     EXACT_MAX_ULPS; each case prints its tile plan (form "classic") and
     the clusters resident, and the cases must include a plan with
     F >= 2 and one with CS > 1. The other layered kernels refuse a
     multi-edge graph and the classic kernel a graph without one.
  17. CCSDS legs timed — bench.CCSDS_LEGS through run_benchmark
     (ccsds/4096/12, 2.5 dB, 4096 frames, layered/{norm:0.8125,spa,minstar}
     /25/noet): ms, Mbit/s, launches, bound, plain ms, FER < 0.5.
  18. CCSDS sweep vs the JAX reference — run_sweep of
     layered/norm:0.8125/50 at 2.0 and 2.5 dB, 8192 frames each, must
     overlap ecc_ldpc_tpu_torch/data/ccsds_4096_12_jax_cpu.json.
  19. CCSDS production path — the CLI's sweep with
     layered/norm:0.8125/50;retry=layered/spa/50 at the reference's retry
     points, 1.5 and 2.5 dB, 65536 frames each in batches of 4096: the
     classic kernel ran both the primary (min-sum) and the fallback (spa),
     the fallback got frames (at 1.5 dB: from 2.0 dB up this surrogate's
     frame errors are undetected), and the FER overlaps the reference.
  20. xor kernels vs plain — the XOR instantiations of csrc/layered_qc.cu
     and csrc/flooding_qc.cu (K4's layered and flooding modes) and of
     csrc/layered_exact.cu against their plain versions on 8023an (Z = 64
     XOR-permutation blocks, row degree 32): each rule, layered and
     flooding, fixed at 3.6 dB and track at 3.4 dB (32 frames, and 13 for
     a ragged last tile); layered and flooding min-sum and spa also at 601
     frames (CS = 1, a ragged last tile of F); layered min-sum also with
     offset:0.15 and the per-iteration schedule dvbs2_64800_12_T25; the
     toy Z = 16 xor code
     (the 8-wide builds), min-sum layered and flooding, fixed and track;
     each XOR_LEGS shape (2048 frames). Bits, ok and iterations identical;
     posteriors after one sweep within EXACT_MAX_ULPS, and min-sum's final
     posteriors identical. The K3 cases of phases 12, 16 and 20 must
     include a plan with CS = 8 on dvbs2/64800 and one with CS = 1, F >= 2
     and a ragged last tile. The classic kernel
     refuses a xor graph, and no roll instantiation launches in 20-22.
  21. xor legs timed — bench.XOR_LEGS through run_benchmark (8023an,
     4.0 dB, 2048 frames, layered/norm:0.8125/25/noet and
     minsum/norm:0.8125/25/noet), and layered/spa/25/noet on the same
     shape: ms, Mbit/s, launches by perm, bound, plain ms, FER <= 0.01.
  22. 8023an sweeps vs the JAX reference — run_sweep of
     layered/norm:0.8125/25 at 3.4 and 3.6 dB and of minsum/norm:0.8125/25
     at 3.6 and 3.8 dB, 8192 frames a point, must overlap
     ecc_ldpc_tpu_torch/data/8023an_jax_cpu.json (the overlap with the TPU
     goldens, measured through a bf16 permutation, is printed and gates
     nothing); then the CLI's sweep with
     layered/norm:0.8125/50;retry=layered/spa/50 at 3.6 dB, 65536 frames
     in batches of 4096: both xor kernels launched, the fallback got
     frames, and the FER overlaps the reference's retry point.
  23. K5 vs plain — the all-reduce (csrc/ring.cu: one push into every
     rank's slot, ordered on the device by interprocess events, then the
     sum) on D = 2 and D = 4 ranks (processes under
     torch.distributed.run, gloo between them) of the one card, through
     bench/ring.py: f32 and int64 at the sweep counters' shape [2, 4], at
     a ragged 1001 elements and at 16 MiB per rank; K5's sum identical to
     the plain version's on every rank and the ranks identical to each
     other, 2 launches a call; K5, the plain version and gloo's
     all_reduce timed on the same CUDA tensors. The card's compute mode
     is printed.
  24. the sharded sweep at full width — bench/sharded.py on meshes 1x1,
     2x1 and 2x2 (separate rank sets): dvbs2/64800/12,
     layered/norm:0.8125/25, 1.0 and 1.1 dB, 4096 frames a point per step,
     2 steps; the integer counters identical on every rank and mesh, K1a
     and K5 launched on every rank of 2x1 and 2x2; frames/s per mesh, and
     run_sweep's on the same points beside them.
  25. the entry point — the CLI's sweep under torch.distributed.run on a
     2x2 mesh (4 ranks), 100 frame errors or 32768 frames a point: every
     rank exits 0 and rank 0's results overlap the golden curve.
Then the kernels line, nvidia-smi's line, and the result line last.
"""
from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ecc_ldpc_tpu_torch import _build
from ecc_ldpc_tpu_torch.bench.flooding_probe import (
    regular_graph,
    time_decode,
    zero_codeword_llr,
)
from ecc_ldpc_tpu_torch.bench.throughput import (
    CCSDS_LEGS,
    CCSDS_PRODUCTION_SWEEP,
    EXACT_LEGS,
    SHARDED_MESHES,
    SHARDED_SWEEP,
    FLOODING_LEGS,
    FLOODING_PRODUCTION_SWEEP,
    LEGS,
    PRODUCTION_SWEEP,
    XOR_LEGS,
    XOR_PRODUCTION_SWEEP,
    make_inputs,
    run_benchmark,
)
from ecc_ldpc_tpu_torch.chan.awgn import awgn_llr, make_channel
from ecc_ldpc_tpu_torch.cli.main import main as cli_main
from ecc_ldpc_tpu_torch.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import (
    choose_graph,
    get_decoder,
    parse_decoder_spec,
)
from ecc_ldpc_tpu_torch.decode.flooding import (
    flooding_decode_cuda,
    flooding_with_posteriors_cuda,
    flooding_with_posteriors_plain,
)
from ecc_ldpc_tpu_torch.decode.flooding_qc import (
    flooding_qc_decode_cuda,
    flooding_qc_with_posteriors_cuda,
    flooding_qc_with_posteriors_plain,
)
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    classic_with_posteriors_cuda,
    exact_with_posteriors_cuda,
    layered_classic_cuda,
    layered_decode_cuda,
    layered_exact_cuda,
    minsum_with_posteriors_cuda,
    plain_with_posteriors,
)
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph
from ecc_ldpc_tpu_torch.sim import (
    PointResult,
    StoppingRule,
    SweepSpec,
    curves_overlap,
    run_sweep,
)
from ecc_ldpc_tpu_torch.sim.runner import Pipeline, step_seed

ROOT = pathlib.Path(__file__).resolve().parent
# FER limits: the headline and production legs decode at operating points
# where the code is far below 1e-2; the repo stores no r=3/4 FER at 3.0 dB,
# so that leg is held only to "decodes most frames".
FER_MAX = {"headline": 0.01, "r34": 0.5, "prod": 0.01}
# kernel vs plain on the card: (name, code, decoder spec, Eb/N0 dB), B=32
PARITY_CASES = [
    ("r12_fixed_1.0dB", "dvbs2/64800/12", "layered/norm:0.8125/25/noet", 1.0),
    ("r12_fixed_1.5dB", "dvbs2/64800/12", "layered/norm:0.8125/25/noet", 1.5),
    ("r12_track_op2_1.2dB", "dvbs2/64800/12",
     "layered/sched:dvbs2_64800_12_T25_op2", 1.2),
    ("r12_track_norm_1.05dB", "dvbs2/64800/12", "layered/norm:0.8125/25", 1.05),
    ("r12_fixed_offset_1.2dB", "dvbs2/64800/12",
     "layered/norm:0.8125/offset:0.15/25/noet", 1.2),
    ("r34_fixed_3.0dB", "dvbs2/64800/34", "layered/norm:0.8125/25/noet", 3.0),
    ("r910_fixed_4.0dB", "dvbs2/64800/910", "layered/norm:0.8125/25/noet", 4.0),
    ("r910_fixed_offset_4.0dB", "dvbs2/64800/910",
     "layered/norm:0.8125/offset:0.15/25/noet", 4.0),
    ("r910_track_3.8dB", "dvbs2/64800/910", "layered/norm:0.8125/25", 3.8),
]
# K1a's tile plans (decode/layered_qc.tile_plan) at their own batch sizes:
# (name, code, decoder spec, Eb/N0 dB, B). 13 frames is the fallback's
# plan (one frame to a cluster of 8 blocks); 8023an at 601 frames takes
# CS = 1 and ends in a ragged tile
PLAN_CASES = [
    ("r12_track_1.05dB_13frames", "dvbs2/64800/12", "layered/norm:0.8125/25",
     1.05, 13),
    ("8023an_track_3.4dB_601frames", "8023an", "layered/norm:0.8125/25",
     3.4, 601),
]
# waterfall bands around the golden curve (0.79 at 0.95 dB, 0.0011 at 1.2)
WATERFALL = [(0.95, ">=", 0.5), (1.2, "<=", 0.02)]
WATERFALL_DECODER = "layered/norm:0.8125/25"
WATERFALL_FRAMES = 2048
TRAP_FILE = ROOT / "tests" / "data" / "trap_batch_dvbs2_64800_12.npz"
GOLDEN = ROOT / "curves" / "dvbs2_64800_12_tpu_golden.json"
# exact kernel vs plain on the card: (name, code, spec with {cn}, Eb/N0, B)
EXACT_CASES = [
    ("r12_fixed_1.0dB", "dvbs2/64800/12", "layered/{cn}/25/noet", 1.0, 32),
    ("r12_track_1.2dB", "dvbs2/64800/12", "layered/{cn}/25", 1.2, 32),
    # a ragged last tile, as the retry fallback's batches have
    ("r12_track_1.2dB_13frames", "dvbs2/64800/12", "layered/{cn}/25", 1.2, 13),
    ("r34_fixed_3.0dB", "dvbs2/64800/34", "layered/{cn}/25/noet", 3.0, 32),
    ("r910_fixed_4.0dB", "dvbs2/64800/910", "layered/{cn}/25/noet", 4.0, 32),
    ("r910_track_3.8dB", "dvbs2/64800/910", "layered/{cn}/25", 3.8, 32),
    ("8023an_track_3.4dB_601frames", "8023an", "layered/{cn}/25", 3.4,
     601),
]
# Posteriors after one fixed sweep may differ from the plain version's by
# at most this many f32 ulps; bits, ok and iterations must be identical.
EXACT_MAX_ULPS = 0
EXACT_FER_MAX = 0.01
SWEEP_DECODER = "layered/norm:0.8125/25"
SWEEP_EBN0 = (1.0, 1.05, 1.1)
# the production point: the reference saw 0 frame errors in 1.0M frames
# with retry and FER 3.9e-5 without at 1.5 dB (README.md); 65536 frames
PRODUCTION_FRAMES = 65536
PRODUCTION_FER_MAX = 1.5e-4
KINDS = ("minsum", "spa", "minstar")
RULE = {"minsum": "minsum/norm:0.8125", "spa": "spa", "minstar": "minstar"}
# K2 vs plain on mackay1008: (name, spec, Eb/N0 dB, B). 601 frames take
# tiles of F = 2 (track) and 6 (fixed), the last one ragged; 2048 track
# frames tiles of 2, whose frames stop at different iterations
FLOODING_CASES = [
    ("minsum_fixed_2.5dB", "minsum/norm:0.8125/25/noet", 2.5, 32),
    ("minsum_track_2.0dB", "minsum/norm:0.8125/25", 2.0, 32),
    ("minsum_track_2.0dB_13frames", "minsum/norm:0.8125/25", 2.0, 13),
    *[(f"{k}_{m}_1.5dB", f"{k}/25" + ("/noet" if m == "fixed" else ""),
       1.5, 32) for k in ("spa", "minstar") for m in ("fixed", "track")],
    ("spa_track_1.5dB_13frames", "spa/50", 1.5, 13),
    *[(f"{k}_track_1.5dB_601frames", f"{r}/25", 1.5, 601)
      for k, r in (("minsum", "minsum/norm:0.8125"), ("spa", "spa"),
                   ("minstar", "minstar"))],
    ("minsum_fixed_2.0dB_601frames", "minsum/norm:0.8125/25/noet", 2.0, 601),
    ("minsum_track_2.0dB_2048frames", "minsum/norm:0.8125/25", 2.0, 2048),
]
# K2's form "global": (name, decoder arguments) on the seeded (3,6)-regular
# n = 16384 graph, whose frame (262 KB of state) does not fit a block
FLOODING_GLOBAL_N = 16384
FLOODING_GLOBAL_CASES = [
    ("regular16384_minsum_track_2.0dB",
     dict(kind="minsum", alpha=0.8125, max_iters=25, early_term=True)),
    ("regular16384_spa_fixed_2.0dB",
     dict(kind="spa", max_iters=10, early_term=False)),
]
FLOODING_GLOBAL_B = 32
# K3 vs plain: (name, code, spec with {r} for the rule, Eb/N0, B)
FLOODING_QC_CASES = [
    ("r12_fixed_1.5dB", "dvbs2/64800/12", "{r}/25/noet", 1.5, 32),
    ("r12_track_1.2dB", "dvbs2/64800/12", "{r}/25", 1.2, 32),
    ("r12_track_1.2dB_13frames", "dvbs2/64800/12", "{r}/25", 1.2, 13),
    ("r34_fixed_3.0dB", "dvbs2/64800/34", "{r}/25/noet", 3.0, 32),
    ("r910_fixed_4.0dB", "dvbs2/64800/910", "{r}/25/noet", 4.0, 32),
]
MACKAY_FER_MAX = 0.01
GOLDEN_MACKAY = {"spa/50": ROOT / "curves" / "mackay1008_tpu_golden.json",
                 "minsum/norm:0.8125/25":
                     ROOT / "curves" / "mackay1008_cpu_golden.json"}
MACKAY_SWEEP_EBN0 = (1.5, 2.0)
# K1b/K1c' vs plain: code -> Eb/N0 where 25 iterations fail some of 32
# frames (on the card, seed 1, min-sum decodes 27, 14 and 18 of them)
CLASSIC_CODES = {"ccsds/4096/12": 1.5, "ccsds/4096/23": 2.0,
                 "ccsds/4096/45": 2.8}
CLASSIC_CASES = [  # (name, spec with {r} for the rule, B)
    ("fixed", "layered/{r}/25/noet", 32),
    ("track", "layered/{r}/25", 32),
    ("track_13frames", "layered/{r}/25", 13),
]
CLASSIC_MINSUM_CASES = [
    ("fixed_offset", "layered/norm:0.8125/offset:0.15/25/noet", 32),
    ("track_sched", "layered/sched:dvbs2_64800_12_T25", 32),
]
# the classic kernel's other plans, each rule in track mode: (name, code,
# Eb/N0, B, whether the code has an encoder); several frames a tile with a
# ragged last one, and a frame over a cluster of 8 (the all-zero
# codeword's LLRs: the port cannot encode k = 16384 yet)
CLASSIC_PLAN_CASES = [
    ("track_601frames", "ccsds/1024/12", 1.5, 601, True),
    ("track_16frames", "ccsds/16384/12", 1.2, 16, False),
]
# K3 on multi-edge graphs: (name, code, spec, B); the 601-frame plan keeps
# its LLRs in [B, n]
CLASSIC_FLOODING_CASES = [
    ("spa_fixed", "ccsds/4096/12", "spa/25/noet", 32),
    ("spa_track", "ccsds/4096/12", "spa/25", 32),
    ("spa_track_601frames", "ccsds/4096/45", "spa/25", 601),
]
CCSDS_REFERENCE = (ROOT / "ecc_ldpc_tpu_torch" / "data"
                   / "ccsds_4096_12_jax_cpu.json")
CCSDS_SWEEP_DECODER = "layered/norm:0.8125/50"
CCSDS_SWEEP_EBN0 = (2.0, 2.5)
CCSDS_SWEEP_FRAMES = 8192
CCSDS_FER_MAX = 0.5
# the xor kernels vs plain on 8023an: (name, spec with {r} for the rule,
# Eb/N0, B); at 3.4-3.6 dB 25 iterations fail some of 32 frames
XOR_CASES = [
    ("fixed_3.6dB", "{r}/25/noet", 3.6, 32),
    ("track_3.4dB", "{r}/25", 3.4, 32),
    ("track_3.4dB_13frames", "{r}/25", 3.4, 13),
]
# the xor tile kernels (K1a, K1c, K3) at CS = 1 with a ragged last tile
XOR_PLAN_CASES = [("track_3.4dB_601frames", "{r}/25", 3.4, 601)]
XOR_MINSUM_CASES = [
    ("fixed_offset_3.6dB", "layered/norm:0.8125/offset:0.15/25/noet", 3.6),
    ("track_sched_3.4dB", "layered/sched:dvbs2_64800_12_T25", 3.4),
]
XOR_RULES = {"layered": {"minsum": "layered/norm:0.8125", "spa": "layered/spa",
                         "minstar": "layered/minstar"},
             "flooding": RULE}
XOR_TOY_EBN0 = 2.0  # the toy code fails some of 32 frames here
XOR_REFERENCE = ROOT / "ecc_ldpc_tpu_torch" / "data" / "8023an_jax_cpu.json"
# sweep decoder -> (Eb/N0 points, the TPU golden printed beside them)
XOR_SWEEPS = {
    "layered/norm:0.8125/25": ((3.4, 3.6), ROOT / "curves"
                               / "8023an_layered_tpu_golden.json"),
    "minsum/norm:0.8125/25": ((3.6, 3.8), ROOT / "curves"
                              / "8023an_tpu_golden.json"),
}
XOR_SWEEP_FRAMES = 8192
XOR_FER_MAX = 0.01
RING_RANKS = (2, 4)
# the integer counters a sharded sweep must reproduce on every mesh
SHARDED_COUNTERS = ("frames", "bit_errors", "frame_errors", "iters_sum",
                    "bit_errors_sq")
CLI_MESH = "2x2"
CLI_MESH_FRAMES = 32768


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line for a phase, with the script's elapsed seconds."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter()
                                                - T_START, 1), **kw}),
          flush=True)


def smi_sample() -> str:
    """The card's SM and memory clocks, power draw, temperature and active
    clock-limit reasons, as nvidia-smi prints them (its error text if the
    query fails), to read beside a timing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (out.stdout or out.stderr).strip()


def timed(fn, *args, **kw):
    """(result, ms) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_floats(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two f32 tensors hold the same bits (NaN and -0.0 too)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def tile_line(wrapper, B: int) -> dict:
    """The tile plan of a tile kernel's wrapper's last launch (K1a, K1c,
    K1b/K1c', K3: its cluster size, frames a tile, tiles, and the clusters
    launched, at most those resident by cudaOccupancyMaxActiveClusters; K2:
    its form, frames a tile, tiles and the blocks launched), and whether
    the last tile is ragged."""
    plan, resident = wrapper.last_plan
    return dict(plan=dict(plan.as_dict(), resident=resident),
                ragged=B % plan.frames != 0)


def frozen(res, max_iters: int) -> int:
    """Frames that stopped before max_iters (track mode's freeze)."""
    return int((res.iterations < max_iters).sum().item())


def compare(graph, llr, kw):
    """Kernel and plain version on the same LLRs; raises unless bits, ok,
    iterations and the final posteriors are identical. Returns (the
    numbers to print, the kernel's DecodeResult)."""
    dkw = {k: kw[k] for k in ("alpha", "beta", "max_iters", "early_term")
           if k in kw}
    (kern, ktot), kern_ms = timed(minsum_with_posteriors_cuda, graph, llr,
                                  **dkw)
    (plain, ptot), plain_ms = timed(plain_with_posteriors, graph, llr, **dkw)
    err = max(
        (kern.bits.int() - plain.bits.int()).abs().max().item(),
        (kern.ok.int() - plain.ok.int()).abs().max().item(),
        (kern.iterations - plain.iterations).abs().max().item(),
        (ktot - ptot).abs().max().item(),
    )
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations)
            and same_floats(ktot, ptot))
    if not same:
        raise AssertionError(f"kernel and plain version differ (max abs err {err})")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=float(err),
                frames=llr.shape[0], ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item(),
                frozen_frames=frozen(kern, dkw.get("max_iters", 25)),
                **tile_line(layered_decode_cuda, llr.shape[0])), kern


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 on a line where adjacent floats differ by 1 (+0 = -0)."""
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _first(x):
    """A per-iteration schedule's first entry (as a schedule), or x."""
    return np.asarray(x)[:1] if np.ndim(x) else x


def compare_posteriors(kernel_fn, plain_fn, graph, llr, dkw,
                       final_exact: bool = False, tiles=None) -> dict:
    """A kernel's with-posteriors wrapper and its plain version on the same
    LLRs with decoder arguments dkw: raises unless bits, ok and iterations
    are identical and, after one fixed iteration (a schedule's first
    alpha/beta), the posteriors are within EXACT_MAX_ULPS; with
    final_exact (min-sum) also unless the final posteriors are identical.
    With `tiles` (the tile kernel's wrapper) the line carries the decode's
    tile plan, and whether a tile's frames stopped at different
    iterations."""
    (kern, ktot), kern_ms = timed(kernel_fn, graph, llr, **dkw)
    plan = {} if tiles is None else dict(
        tile_line(tiles, llr.shape[0]),
        spread_stops=spread_stops(kern, tiles.last_plan[0].frames))
    (plain, ptot), plain_ms = timed(plain_fn, graph, llr, **dkw)
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations))
    max_abs = (ktot - ptot).abs().max().item()
    one = dict(dkw, max_iters=1, early_term=False)
    for ab in ("alpha", "beta"):
        if ab in one:
            one[ab] = _first(one[ab])
    _, k1 = kernel_fn(graph, llr, **one)
    _, p1 = plain_fn(graph, llr, **one)
    ulps1 = int((_ordered(k1) - _ordered(p1)).abs().max().item())
    if not same:
        raise AssertionError(
            f"{kernel_fn.__name__} and its plain version decide differently "
            f"(posterior max abs err {max_abs}, one-sweep ulps {ulps1})")
    if ulps1 > EXACT_MAX_ULPS:
        raise AssertionError(f"{kernel_fn.__name__}: one-sweep posteriors "
                             f"{ulps1} ulps apart")
    if final_exact and not same_floats(ktot, ptot):
        raise AssertionError(f"{kernel_fn.__name__}: final posteriors differ "
                             f"(max abs err {max_abs})")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=max_abs,
                one_sweep_max_ulps=ulps1, frames=llr.shape[0],
                ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item(),
                frozen_frames=frozen(kern, dkw.get("max_iters", 25)), **plan)


def compare_exact(graph, llr, kw) -> dict:
    """The exact-BP kernel (K1c) against its plain version."""
    dkw = dict(max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True), cn=kw["cn"])
    return compare_posteriors(exact_with_posteriors_cuda,
                              plain_with_posteriors, graph, llr, dkw,
                              tiles=layered_exact_cuda)


def need_plan(kernel: str, lines, what: str, pred) -> None:
    """Raise unless one of a kernel's cases launched a plan that `pred`
    (of the case line) accepts; `what` names it."""
    if not any(pred(r) for r in lines):
        raise AssertionError(f"{kernel}: no case launched {what}")


def check_plans(kernel: str, lines) -> None:
    """Raise unless a kernel's cases launched a plan with CS > 1 and one
    with CS = 1."""
    need_plan(kernel, lines, "a plan with CS = 1",
              lambda r: r["plan"]["cluster"] == 1)
    need_plan(kernel, lines, "a plan with CS > 1",
              lambda r: r["plan"]["cluster"] > 1)


def compare_classic(graph, llr, kw) -> dict:
    """The classic kernel (K1b, K1c'; multi-edge graphs) against its plain
    version."""
    dkw = dict(alpha=kw.get("alpha", 1.0), beta=kw.get("beta", 0.0),
               max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True),
               cn=kw.get("cn", "minsum"))
    return compare_posteriors(classic_with_posteriors_cuda,
                              plain_with_posteriors, graph, llr, dkw,
                              tiles=layered_classic_cuda)


def compare_flooding(graph, llr, kw, kernel_fn, plain_fn) -> dict:
    """A flooding kernel (K2 or K3) against its plain version; the line
    carries its tile plan."""
    dkw = dict(kind=kw["kind"], alpha=kw.get("alpha", 1.0),
               beta=kw.get("beta", 0.0), max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True))
    tiles = (flooding_qc_decode_cuda
             if kernel_fn is flooding_qc_with_posteriors_cuda
             else flooding_decode_cuda)
    return compare_posteriors(kernel_fn, plain_fn, graph, llr, dkw,
                              tiles=tiles)


def spread_stops(res, frames: int) -> bool:
    """Some tile of `frames` frames holds frames that stopped at different
    iterations (track mode's per-frame freeze inside one tile)."""
    it = res.iterations
    whole = it.shape[0] // frames * frames
    tiles = it[:whole].view(-1, frames)
    return bool((tiles.amax(1) != tiles.amin(1)).any().item())


def check_k2_plans(lines) -> None:
    """Raise unless K2's cases launched both forms, a tile of F >= 2 with a
    ragged last tile, and a track tile whose frames stopped at different
    iterations."""
    need_plan("K2", lines, 'the form "chip"',
              lambda r: r["plan"]["form"] == "chip")
    need_plan("K2", lines, 'the form "global"',
              lambda r: r["plan"]["form"] == "global")
    need_plan("K2", lines, "F >= 2 with a ragged last tile",
              lambda r: r["plan"]["frames"] >= 2 and r["ragged"])
    need_plan("K2", lines, "a tile whose frames stop at different "
              "iterations", lambda r: r["spread_stops"])


def bench_line(res, launches, smi_before) -> dict:
    return dict(smi_before=smi_before, smi_after=smi_sample(),
                ms=res.wall_s_per_batch * 1e3, mbps=res.throughput_mbps,
                tries_ms=[t * 1e3 for t in res.tries_s], launches=launches,
                bound_ms=res.bound_ms, bound_by=res.roofline_form,
                frame_errors=res.frame_errors, frames=res.batch,
                fer=res.frame_errors / res.batch,
                codeword_frame_errors=res.codeword_frame_errors,
                mean_iters=res.mean_iters)


def point_line(pr: PointResult) -> dict:
    return dict(ebn0_db=pr.ebn0_db, frames=pr.frames,
                frame_errors=pr.frame_errors, fer=pr.fer, fer_ci=pr.fer_ci,
                bit_errors=pr.bit_errors, ber=pr.ber,
                mean_iters=pr.mean_iters, wall_s=pr.wall_s)


def ccsds_path(dev, spec12, k3, flood_err, k3_lines) -> list:
    """Phases 16-19: the classic kernel on multi-edge graphs (CCSDS
    AR4JA) against its plain version, timed, in a sweep and in the
    production retry decoder; returns its entries of the kernels line.
    flood_err and k3_lines gain the K3 cases on the multi-edge graphs."""
    # 16. the classic kernel (K1b, K1c') against its plain version
    t0 = time.perf_counter()
    classic_err = dict.fromkeys(KINDS, 0.0)
    classic_lines = []

    def note(code, name, spec_str, ebn0, graph, llr, kw):
        r = compare_classic(graph, llr, kw)
        cn = kw.get("cn", "minsum")
        classic_err[cn] = max(classic_err[cn], r["max_abs_err"])
        classic_lines.append(r)
        emit("classic_vs_plain", code=code, case=name, decoder=spec_str,
             ebn0_db=ebn0, **r)
        return r

    for code, ebn0 in CLASSIC_CODES.items():
        cases = [(f"{k}_{name}", spec_str.format(r=RULE[k]), B)
                 for k in KINDS for name, spec_str, B in CLASSIC_CASES]
        cases += [(f"minsum_{name}", spec_str, B)
                  for name, spec_str, B in CLASSIC_MINSUM_CASES]
        for name, spec_str, B in cases:
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            note(code, name, spec_str, ebn0, x.graph, x.llr, x.kw)
    for name, code, ebn0, B, encodable in CLASSIC_PLAN_CASES:
        for k in KINDS:
            spec_str = f"layered/{RULE[k]}/25"
            if encodable:
                x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
                inputs = x.graph, x.llr, x.kw
            else:
                inputs = zero_codeword(code, spec_str, B, ebn0, dev)
            note(code, f"{k}_{name}", spec_str, ebn0, *inputs)
    classic_parity = {}
    for cn in KINDS:
        x = make_inputs(**CCSDS_LEGS[cn], device=dev, seed=0)
        classic_parity[cn] = note(CCSDS_LEGS[cn]["code"], f"{cn}_bench_shape",
                                  CCSDS_LEGS[cn]["decoder"],
                                  CCSDS_LEGS[cn]["ebn0_db"], x.graph, x.llr,
                                  x.kw)
        del x
    need_plan("layered_classic", classic_lines, "a plan with F >= 2",
              lambda r: r["plan"]["frames"] >= 2)
    need_plan("layered_classic", classic_lines, "a plan with CS > 1",
              lambda r: r["plan"]["cluster"] > 1)
    for name, code, spec_str, B in CLASSIC_FLOODING_CASES:
        x = make_inputs(code, spec_str, B, CLASSIC_CODES[code], dev, seed=1)
        r = compare_flooding(x.graph, x.llr, x.kw, *k3)
        flood_err["flooding_qc:spa"] = max(flood_err["flooding_qc:spa"],
                                           r["max_abs_err"])
        k3_lines.append(dict(r, code=code))
        emit("flooding_qc_vs_plain", code=code, case=name,
             decoder=spec_str, **r)
        del x
    # each layered kernel takes only its own form of graph
    ccsds12 = choose_graph(get_code(CCSDS_PRODUCTION_SWEEP["code"]),
                           "layered/spa/2")
    refusals = [
        (layered_classic_cuda, choose_graph(spec12, "layered/spa/2"), {}),
        (layered_decode_cuda, ccsds12, {}),
        (layered_exact_cuda, ccsds12, {"cn": "spa"}),
    ]
    for fn, graph, kw in refusals:
        try:
            fn(graph, torch.zeros((1, graph.n), device=dev), max_iters=2, **kw)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__} took the other form of graph")
    emit("classic_vs_plain", refusals=len(refusals),
         seconds=time.perf_counter() - t0)

    # 17. the CCSDS legs timed; each rule's count read around its own run
    classic_bench, classic_bench_launches, classic_plans = {}, {}, {}
    for cn in KINDS:
        layered_classic_cuda.by_rule = dict.fromkeys(KINDS, 0)
        smi_before = smi_sample()
        res = run_benchmark(**CCSDS_LEGS[cn], device=dev)
        classic_bench_launches[cn] = layered_classic_cuda.by_rule[cn]
        classic_plans[cn] = tile_line(layered_classic_cuda, res.batch)["plan"]
        emit("ccsds_bench", cn=cn, code=res.code, decoder=res.decoder,
             plain_ms=classic_parity[cn]["plain_ms"], plan=classic_plans[cn],
             **bench_line(res, classic_bench_launches[cn], smi_before))
        if not res.frame_errors / res.batch < CCSDS_FER_MAX:
            raise AssertionError(f"ccsds {cn}: FER above {CCSDS_FER_MAX}")
        if classic_bench_launches[cn] <= 0:
            raise AssertionError(f"ccsds {cn}: the classic kernel never "
                                 f"launched")
        classic_bench[cn] = res

    # 18. the CCSDS sweep against the JAX package's CPU reference
    with open(CCSDS_REFERENCE) as f:
        reference = [PointResult.from_json(d) for d in json.load(f)]
    t0 = time.perf_counter()
    swept = run_sweep(SweepSpec(
        code=CCSDS_PRODUCTION_SWEEP["code"], decoder=CCSDS_SWEEP_DECODER,
        ebn0_db=CCSDS_SWEEP_EBN0, batch=CCSDS_PRODUCTION_SWEEP["batch"],
        stopping=StoppingRule(min_frame_errors=10 ** 9,
                              max_frames=CCSDS_SWEEP_FRAMES)), device=dev)
    ref = [q for q in reference if q.decoder == CCSDS_SWEEP_DECODER]
    overlap = curves_overlap(swept, ref, "fer")
    for pr in swept:
        g = next(q for q in ref if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        emit("ccsds_vs_reference", decoder=CCSDS_SWEEP_DECODER,
             **point_line(pr), reference_fer=g.fer,
             reference_fer_ci=g.fer_ci)
    emit("ccsds_vs_reference", overlap=overlap,
         seconds=time.perf_counter() - t0)
    if not overlap:
        raise AssertionError("the CCSDS sweep misses the JAX reference")

    # 19. the CCSDS production path through the CLI at the reference's
    # retry points (the fallback gets frames at the lower one): counts
    # from this run
    ref_retry = [q for q in reference
                 if q.decoder == CCSDS_PRODUCTION_SWEEP["decoder"]]
    layered_classic_cuda.launches = 0
    layered_classic_cuda.frames = 0
    layered_classic_cuda.by_rule = dict.fromkeys(KINDS, 0)
    layered_classic_cuda.frames_by_rule = dict.fromkeys(KINDS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production_ccsds.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", CCSDS_PRODUCTION_SWEEP["code"],
            "--decoder", CCSDS_PRODUCTION_SWEEP["decoder"],
            "--ebn0", ",".join(str(q.ebn0_db) for q in ref_retry),
            "--batch", str(CCSDS_PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        prods = [PointResult.from_json(d) for d in json.loads(out.read_text())]
    ccsds_sweep = dict(layered_classic_cuda.by_rule)
    overlap = curves_overlap(prods, ref_retry, "fer")
    for pr, q in zip(prods, ref_retry):
        emit("production_ccsds", decoder=pr.decoder, **point_line(pr),
             reference_fer=q.fer, reference_fer_ci=q.fer_ci)
    emit("production_ccsds", rc=rc, seconds=wall, launches=ccsds_sweep,
         frames_to_fallback=layered_classic_cuda.frames_by_rule["spa"],
         overlap=overlap)
    if rc != 0 or [pr.frames for pr in prods] != [PRODUCTION_FRAMES] * len(
            ref_retry):
        raise AssertionError(f"ccsds production sweep: rc {rc}, "
                             f"{[pr.frames for pr in prods]} frames")
    if ccsds_sweep["minsum"] <= 0 or ccsds_sweep["spa"] <= 0:
        raise AssertionError("the CCSDS production sweep missed a rule of "
                             "the classic kernel")
    if layered_classic_cuda.frames_by_rule["spa"] <= 0:
        raise AssertionError("the CCSDS fallback got no frames")
    if not overlap:
        raise AssertionError("the CCSDS production FER misses the reference")

    kernels = []
    # K1b's and K1c' spa's counts are the CCSDS production sweep's (primary
    # and fallback), minstar's its own timed run's
    for cn in KINDS:
        res = classic_bench[cn]
        kernels.append({
            "name": f"layered_classic:{cn}",
            "route": "cuda",
            "source": "ecc_ldpc_tpu_torch/csrc/layered_classic.cu",
            "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:"
                        + ("415" if cn == "minsum" else "630"),
            "launches": (classic_bench_launches[cn] if cn == "minstar"
                         else ccsds_sweep[cn]),
            "max_abs_err": classic_err[cn],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": classic_parity[cn]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
            "plan": classic_plans[cn],
        })
    return kernels


def compare_xor(schedule: str, graph, llr, kw) -> dict:
    """The xor instantiation of the kernel that serves `schedule` and the
    rule in kw against its plain version."""
    if schedule == "flooding":
        dkw = dict(kind=kw["kind"], alpha=kw.get("alpha", 1.0),
                   beta=kw.get("beta", 0.0), max_iters=kw.get("max_iters", 25),
                   early_term=kw.get("early_term", True))
        return compare_posteriors(
            flooding_qc_with_posteriors_cuda, flooding_qc_with_posteriors_plain,
            graph, llr, dkw, final_exact=kw["kind"] == "minsum",
            tiles=flooding_qc_decode_cuda)
    if kw.get("cn", "minsum") != "minsum":
        return compare_exact(graph, llr, kw)
    dkw = {k: kw[k] for k in ("alpha", "beta", "max_iters", "early_term")
           if k in kw}
    return compare_posteriors(minsum_with_posteriors_cuda,
                              plain_with_posteriors, graph, llr, dkw,
                              final_exact=True, tiles=layered_decode_cuda)


def xor_toy(dev):
    """The toy xor code (Z = 16, a 4x8 base from default_rng(3), as the
    JAX package's tests build it): its graph and 32 frames of LLRs of the
    all-zero codeword at XOR_TOY_EBN0."""
    Z = 16
    base = np.random.default_rng(3).integers(0, Z, size=(4, 8)).astype(
        np.int32)
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toyxor16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cw = torch.zeros((32, spec.n), dtype=torch.uint8, device=dev)
    return compile_qc_graph(spec), awgn_llr(gen, cw, XOR_TOY_EBN0, 0.5)


def zero_codeword(code: str, spec_str: str, B: int, ebn0: float, dev,
                  seed: int = 1):
    """(graph, LLRs of B all-zero codewords through the code's channel at
    ebn0, decoder arguments): for codes the port cannot encode yet."""
    spec = get_code(code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cw = torch.zeros((B, spec.n), dtype=torch.uint8, device=dev)
    return (choose_graph(spec, spec_str), make_channel(spec)(gen, cw, ebn0),
            parse_decoder_spec(spec_str))


def check_k3_plans(lines) -> None:
    """Raise unless K3's cases (phases 12, 16, 20) launched a dvbs2/64800
    frame over a cluster of 8 and several frames an SM with a ragged last
    tile."""
    need_plan("flooding_qc", lines, "a cluster of 8 on dvbs2/64800",
              lambda r: r["plan"]["cluster"] == 8
              and r["code"].startswith("dvbs2/64800"))
    need_plan("flooding_qc", lines, "CS = 1, F >= 2 with a ragged last tile",
              lambda r: r["plan"]["cluster"] == 1
              and r["plan"]["frames"] >= 2 and r["ragged"])


def xor_path(dev, k3_lines) -> list:
    """Phases 20-22: the xor instantiations of the QC kernels (K4's two
    modes, and exact BP) on IEEE 802.3an against their plain versions,
    timed, in sweeps and in the production retry decoder; returns their
    entries of the kernels line."""
    wrappers = {"layered": layered_decode_cuda, "exact": layered_exact_cuda,
                "flooding": flooding_qc_decode_cuda}
    roll_before = {k: w.launches_by_perm["roll"] for k, w in wrappers.items()}

    # 20. each xor kernel against its plain version
    t0 = time.perf_counter()
    xor_err = {}

    def note(key, r):
        xor_err[key] = max(xor_err.get(key, 0.0), r["max_abs_err"])

    code = XOR_LEGS["layered"]["code"]
    for schedule, rules in XOR_RULES.items():
        cases = [(f"{k}_{name}", spec_str.format(r=rules[k]), ebn0, B)
                 for k in KINDS for name, spec_str, ebn0, B in XOR_CASES]
        if schedule == "layered":
            cases += [(f"minsum_{name}", spec_str, ebn0, 32)
                      for name, spec_str, ebn0 in XOR_MINSUM_CASES]
        cases += [(f"{k}_{name}", spec_str.format(r=rules[k]), ebn0, B)
                  for k in ("minsum", "spa")
                  for name, spec_str, ebn0, B in XOR_PLAN_CASES]
        for name, spec_str, ebn0, B in cases:
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_xor(schedule, x.graph, x.llr, x.kw)
            note(f"{schedule}:{name.split('_')[0]}", r)
            if schedule == "flooding":
                k3_lines.append(dict(r, code=code))
            emit("xor_vs_plain", code=code, schedule=schedule, case=name,
                 decoder=spec_str, ebn0_db=ebn0, **r)
    toy, toy_llr = xor_toy(dev)
    for schedule in ("layered", "flooding"):
        for mode, et in (("fixed", False), ("track", True)):
            kw = dict(alpha=0.8125, max_iters=25, early_term=et,
                      kind="minsum")
            r = compare_xor(schedule, toy, toy_llr, kw)
            note(f"{schedule}:minsum", r)
            emit("xor_vs_plain", code=toy.name, schedule=schedule,
                 case=f"minsum_{mode}", ebn0_db=XOR_TOY_EBN0, **r)
    xor_parity = {}
    for leg, cfg in XOR_LEGS.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        xor_parity[leg] = r = compare_xor(leg, x.graph, x.llr, x.kw)
        note(f"{leg}:minsum", r)
        emit("xor_vs_plain", code=cfg["code"], schedule=leg,
             case="minsum_bench_shape", decoder=cfg["decoder"], **r)
        del x
    an = choose_graph(get_code(code), "layered/spa/2")
    for cn in ("minsum", "spa"):  # K1b, K1c′
        try:
            layered_classic_cuda(an, torch.zeros((1, an.n), device=dev),
                                 max_iters=2, cn=cn)
        except ValueError:
            pass
        else:
            raise AssertionError(f"layered_classic_cuda ({cn}) took a xor "
                                 f"graph")
    check_k3_plans(k3_lines)
    emit("xor_vs_plain", refusals=2, seconds=time.perf_counter() - t0)

    # 21. the xor legs timed, and exact BP on the same shape; each count
    # read around its own run
    timed_legs = {**XOR_LEGS,
                  "spa": dict(XOR_LEGS["layered"], decoder="layered/spa/25/noet")}
    kernel_of = {"layered": "layered", "flooding": "flooding", "spa": "exact"}
    xor_bench, xor_launches, xor_plans = {}, {}, {}
    for leg, cfg in timed_legs.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        if leg == "spa":
            xor_parity[leg] = r = compare_xor("layered", x.graph, x.llr, x.kw)
            note("layered:spa", r)
            emit("xor_vs_plain", code=cfg["code"], schedule="layered",
                 case="spa_bench_shape", decoder=cfg["decoder"], **r)
        del x
        w = wrappers[kernel_of[leg]]
        w.launches_by_perm = dict.fromkeys(w.launches_by_perm, 0)
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        xor_launches[leg] = dict(w.launches_by_perm)
        xor_plans[leg] = (tile_line(w, res.batch)["plan"]
                          if hasattr(w, "last_plan") else None)
        emit("xor_bench", leg=leg, code=res.code, decoder=res.decoder,
             plan=xor_plans[leg],
             plain_ms=xor_parity[leg]["plain_ms"],
             launches_by_perm=xor_launches[leg],
             **bench_line(res, xor_launches[leg]["xor"], smi_before))
        if not res.frame_errors / res.batch <= XOR_FER_MAX:
            raise AssertionError(f"8023an {leg}: FER above {XOR_FER_MAX}")
        if xor_launches[leg]["xor"] <= 0 or xor_launches[leg]["roll"]:
            raise AssertionError(f"8023an {leg}: not the xor kernel alone")
        xor_bench[leg] = res

    # 22. the sweeps against the JAX package's CPU reference; K4's flooding
    # count read around its sweep
    with open(XOR_REFERENCE) as f:
        reference = [PointResult.from_json(d) for d in json.load(f)]
    sweep_launches = {}
    for dec_spec, (ebn0s, golden_path) in XOR_SWEEPS.items():
        with open(golden_path) as f:
            golden = [PointResult.from_json(d) for d in json.load(f)]
        ref = [q for q in reference if q.decoder == dec_spec]
        for w in wrappers.values():
            w.launches_by_perm = dict.fromkeys(w.launches_by_perm, 0)
        t0 = time.perf_counter()
        swept = run_sweep(SweepSpec(
            code=code, decoder=dec_spec, ebn0_db=ebn0s,
            batch=XOR_LEGS["layered"]["batch"],
            stopping=StoppingRule(min_frame_errors=10 ** 9,
                                  max_frames=XOR_SWEEP_FRAMES)), device=dev)
        sweep_launches[dec_spec] = {k: dict(w.launches_by_perm)
                                    for k, w in wrappers.items()}
        overlap = curves_overlap(swept, ref, "fer")
        golden_overlap = curves_overlap(swept, golden, "fer")
        for pr in swept:
            q = next(q for q in ref if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            emit("xor_vs_reference", decoder=dec_spec, **point_line(pr),
                 reference_fer=q.fer, reference_fer_ci=q.fer_ci,
                 golden_fer=g.fer, golden_fer_ci=g.fer_ci)
        emit("xor_vs_reference", decoder=dec_spec, overlap=overlap,
             golden_overlap_information_only=golden_overlap,
             golden=golden_path.name, launches=sweep_launches[dec_spec],
             seconds=time.perf_counter() - t0)
        if not overlap:
            raise AssertionError(f"{dec_spec}: the 8023an sweep misses the "
                                 f"JAX reference")

    # the production retry decoder through the CLI: counts from this run
    (ref_retry,) = [q for q in reference
                    if q.decoder == XOR_PRODUCTION_SWEEP["decoder"]]
    for w in wrappers.values():
        w.launches_by_perm = dict.fromkeys(w.launches_by_perm, 0)
    layered_exact_cuda.frames_by_perm = dict.fromkeys(
        layered_exact_cuda.frames_by_perm, 0)
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production_8023an.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", XOR_PRODUCTION_SWEEP["code"],
            "--decoder", XOR_PRODUCTION_SWEEP["decoder"],
            "--ebn0", str(XOR_PRODUCTION_SWEEP["ebn0_db"]),
            "--batch", str(XOR_PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        (prod,) = [PointResult.from_json(d)
                   for d in json.loads(out.read_text())]
    retry_launches = {k: dict(w.launches_by_perm) for k, w in wrappers.items()}
    overlap = curves_overlap([prod], [ref_retry], "fer")
    emit("production_8023an", decoder=prod.decoder, rc=rc, **point_line(prod),
         reference_fer=ref_retry.fer, reference_fer_ci=ref_retry.fer_ci,
         seconds=wall, launches=retry_launches,
         frames_to_fallback=layered_exact_cuda.frames_by_perm["xor"],
         overlap=overlap)
    if rc != 0 or prod.frames != PRODUCTION_FRAMES:
        raise AssertionError(f"8023an production sweep: rc {rc}, "
                             f"{prod.frames} frames")
    if (retry_launches["layered"]["xor"] <= 0
            or retry_launches["exact"]["xor"] <= 0):
        raise AssertionError("the 8023an production sweep missed a xor kernel")
    if layered_exact_cuda.frames_by_perm["xor"] <= 0:
        raise AssertionError("the 8023an fallback got no frames")
    if not overlap:
        raise AssertionError("the 8023an production FER misses the reference")
    roll_after = {k: w.launches_by_perm["roll"] for k, w in wrappers.items()}
    if any(roll_after.values()):
        raise AssertionError(f"a roll kernel launched on a xor path "
                             f"({roll_after}; before: {roll_before})")

    # K4 layered's count is the production sweep's primary, K4 flooding's
    # the flooding sweep's, exact BP's (xor) the production fallback's
    rows = [
        ("layered_qc:xor", "layered", "layered:minsum",
         "ecc_ldpc_tpu_torch/csrc/layered_qc.cu",
         "ecc_ldpc_tpu/decode/pallas/layered_xor.py:65",
         retry_launches["layered"]["xor"]),
        ("flooding_qc:minsum:xor", "flooding", "flooding:minsum",
         "ecc_ldpc_tpu_torch/csrc/flooding_qc.cu",
         "ecc_ldpc_tpu/decode/pallas/layered_xor.py:65",
         sweep_launches["minsum/norm:0.8125/25"]["flooding"]["xor"]),
        ("layered_exact:spa:xor", "spa", "layered:spa",
         "ecc_ldpc_tpu_torch/csrc/layered_exact.cu",
         "ecc_ldpc_tpu/decode/pallas/layered_qc.py:501",
         retry_launches["exact"]["xor"]),
    ]
    kernels = []
    for name, leg, err_key, src, replaces, launches in rows:
        res = xor_bench[leg]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": xor_err[err_key],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": xor_parity[leg]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
        })
        if xor_plans[leg] is not None:  # the tile kernels, K1a, K1c, K3
            kernels[-1]["plan"] = xor_plans[leg]
    return kernels


def run_ranks(nproc: int, args: list, timeout: float) -> str:
    """`python -m torch.distributed.run --standalone` with nproc ranks of
    the module args[0] (its arguments after it), in its own process group,
    killed whole at the time limit; raises unless it exits 0 (which it
    does only when every rank does). Returns its output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            process_group=0)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{args[0]} on {nproc} ranks: no end after "
                             f"{timeout} s\n{out[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]} on {nproc} ranks: exit "
                             f"{proc.returncode}\n{out[-4000:]}")
    return out


def rank_lines(out_dir: pathlib.Path, stem: str, nproc: int) -> list:
    return [json.loads((out_dir / f"{stem}_rank{r}.json").read_text())
            for r in range(nproc)]


def dist_path(dev) -> list:
    """Phases 23-25: K5 on several ranks of the one card against its plain
    version, the sharded sweep at full width on three meshes, and the CLI
    under torch.distributed.run; returns K5's entry of the kernels line."""
    torch.cuda.empty_cache()  # the ranks need the card's memory
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True)
    emit("ring_device", compute_mode=(mode.stdout or mode.stderr).strip())

    # 23. K5 against its plain version on D ranks of the card
    ring_cases = {}
    for D in RING_RANKS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            run_ranks(D, ["ecc_ldpc_tpu_torch.bench.ring", tmp], 300)
            lines = rank_lines(pathlib.Path(tmp), "ring", D)
        for line in lines:
            for c in line["cases"]:
                if not (c["identical_to_plain"] and c["ranks_identical"]):
                    raise AssertionError(f"K5 differs from its plain version "
                                         f"or across ranks: rank "
                                         f"{line['rank']}, {c}")
                if c["launches"] != 2:
                    raise AssertionError(f"K5 launched {c['launches']} "
                                         f"kernels a call for D = {D}")
        ring_cases[D] = lines[0]["cases"]
        for c in ring_cases[D]:
            emit("ring_vs_plain", **c)
        emit("ring_vs_plain", D=D, ranks=D, seconds=time.perf_counter() - t0)

    # 24. the sharded sweep on each mesh; counts from each rank's own run
    sharded = {}
    for mesh in SHARDED_MESHES:
        b, s = (int(x) for x in mesh.split("x"))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            run_ranks(b * s, ["ecc_ldpc_tpu_torch.bench.sharded", mesh, tmp],
                      600)
            lines = rank_lines(pathlib.Path(tmp), f"sharded_{mesh}", b * s)
        for line in lines:
            emit("sharded_sweep", **line)
            if line["counters"] != lines[0]["counters"]:
                raise AssertionError(f"{mesh}: ranks disagree on counters")
            if line["launches"]["layered_qc"] <= 0:
                raise AssertionError(f"{mesh} rank {line['rank']}: K1a never "
                                     f"launched")
            if b * s > 1 and line["launches"]["ring"] <= 0:
                raise AssertionError(f"{mesh} rank {line['rank']}: K5 never "
                                     f"launched")
        emit("sharded_sweep", mesh=mesh, ranks=b * s,
             frames_per_s=lines[0]["frames_per_s"],
             seconds=time.perf_counter() - t0)
        sharded[mesh] = lines
    want = [{k: c[k] for k in SHARDED_COUNTERS}
            for c in sharded[SHARDED_MESHES[0]][0]["counters"]]
    for mesh, lines in sharded.items():
        got = [{k: c[k] for k in SHARDED_COUNTERS} for c in lines[0]["counters"]]
        if got != want:
            raise AssertionError(f"mesh {mesh} counters {got} != 1x1's {want}")
    frames = SHARDED_SWEEP["steps"] * SHARDED_SWEEP["batch"]
    if any(c["frames"] != frames for c in want):
        raise AssertionError(f"the sharded sweep ran {want}")
    # run_sweep (one process, a step-seeded stream) on the same points
    swept = run_sweep(SweepSpec(
        code=SHARDED_SWEEP["code"], decoder=SHARDED_SWEEP["decoder"],
        ebn0_db=SHARDED_SWEEP["ebn0_db"], batch=SHARDED_SWEEP["batch"],
        stopping=StoppingRule(min_frame_errors=10 ** 9, max_frames=frames)),
        device=dev)
    emit("sharded_sweep", run_sweep_frames_per_s=sum(
        pr.frames for pr in swept) / sum(pr.wall_s for pr in swept),
        run_sweep=[point_line(pr) for pr in swept])

    # 25. the entry point: the CLI's sweep on a 2x2 mesh of ranks
    with open(GOLDEN) as f:
        golden = [PointResult.from_json(d) for d in json.load(f)]
    b, s = (int(x) for x in CLI_MESH.split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "sharded_cli.json"
        t0 = time.perf_counter()
        run_ranks(b * s, [
            "ecc_ldpc_tpu_torch.cli", "sweep", "--code", SHARDED_SWEEP["code"],
            "--decoder", SHARDED_SWEEP["decoder"],
            "--ebn0", ",".join(map(str, SHARDED_SWEEP["ebn0_db"])),
            "--batch", str(SHARDED_SWEEP["batch"]), "--mesh", CLI_MESH,
            "--min-frame-errors", "100", "--max-frames", str(CLI_MESH_FRAMES),
            "--out", str(out)], 900)
        wall = time.perf_counter() - t0
        cli = [PointResult.from_json(d) for d in json.loads(out.read_text())]
    overlap = curves_overlap(cli, golden, "fer")
    for pr in cli:
        g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        emit("sharded_cli", mesh=CLI_MESH, decoder=pr.decoder, **point_line(pr),
             golden_fer=g.fer, golden_fer_ci=g.fer_ci)
    emit("sharded_cli", mesh=CLI_MESH, overlap=overlap, seconds=wall)
    if not overlap:
        raise AssertionError("the sharded CLI sweep misses the golden curve")

    # K5's numbers at the main path's shape: the counters (int64 [2, 4]) on
    # the 2x2 mesh's 4 ranks; its launches are rank 0's in the 2x2 sweep
    (main_case,) = [c for c in ring_cases[4]
                    if c["case"] == "counters" and c["dtype"] == "int64"]
    return [{
        "name": "ring",
        "route": "cuda",
        "source": "ecc_ldpc_tpu_torch/csrc/ring.cu",
        "replaces": "ecc_ldpc_tpu/dist/ring.py:27",
        "launches": sharded["2x2"][0]["launches"]["ring"],
        "max_abs_err": max(c["max_abs_err"] for cs in ring_cases.values()
                           for c in cs),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["gloo_all_reduce_ms"],
    }]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs on the card")
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: [ln.strip() for ln in v["ptxas"].splitlines()
                      if "registers" in ln or "spill" in ln]
                  for k, v in built.items()})

    dev = torch.device("cuda", 0)
    max_err = 0.0
    k1a_lines = []
    cases = [(name, code, spec_str, ebn0, 32)
             for name, code, spec_str, ebn0 in PARITY_CASES] + PLAN_CASES
    for name, code, spec_str, ebn0, B in cases:
        x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
        r, _ = compare(x.graph, x.llr, x.kw)
        max_err = max(max_err, r["max_abs_err"])
        k1a_lines.append(r)
        emit("kernel_vs_plain", case=name, code=code, **r)
    trap = np.load(TRAP_FILE)
    spec12 = get_code("dvbs2/64800/12")
    trap_spec = "layered/sched:dvbs2_64800_12_T25_op2"
    r, _ = compare(choose_graph(spec12, trap_spec),
                torch.as_tensor(trap["llr"], device=dev),
                parse_decoder_spec(trap_spec))
    max_err = max(max_err, r["max_abs_err"])
    emit("kernel_vs_plain", case="trap_batch_track_op2", **r)
    # each main-path leg's own shapes and inputs (run_benchmark's seed)
    leg_parity = {}
    for leg, cfg in LEGS.items():
        x = make_inputs(**cfg, device=dev, seed=0)
        r, _ = compare(x.graph, x.llr, x.kw)
        leg_parity[leg] = r
        max_err = max(max_err, r["max_abs_err"])
        k1a_lines.append(r)
        emit("kernel_vs_plain", case=f"{leg}_shape", **r)
        del x
    check_plans("layered_qc", k1a_lines)

    # the main path: counts from these three legs only
    layered_decode_cuda.launches = 0
    results, leg_plans = {}, {}
    for leg, cfg in LEGS.items():
        before = layered_decode_cuda.launches
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        leg_plans[leg] = tile_line(layered_decode_cuda, res.batch)["plan"]
        fer = res.frame_errors / res.batch
        emit("main_path", leg=leg, smi_before=smi_before,
             smi_after=smi_sample(), mbps=res.throughput_mbps,
             s_per_batch=res.wall_s_per_batch, mean_iters=res.mean_iters,
             tries_ms=[t * 1e3 for t in res.tries_s],
             frame_errors=res.frame_errors, frames=res.batch, fer=fer,
             codeword_frame_errors=res.codeword_frame_errors,
             bound_ms=res.bound_ms, bound_by=res.roofline_form,
             bound_mbps=res.roofline_mbps,
             launches=layered_decode_cuda.launches - before,
             plan=leg_plans[leg],
             line=json.loads(res.json_line()))
        if not fer <= FER_MAX[leg]:
            raise AssertionError(f"{leg}: FER {fer} above {FER_MAX[leg]}")
        results[leg] = res
    launches = layered_decode_cuda.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the layered kernel")

    for ebn0, op, lim in WATERFALL:
        x = make_inputs("dvbs2/64800/12", WATERFALL_DECODER, WATERFALL_FRAMES,
                        ebn0, dev, seed=3)
        res = x.decode(x.llr)
        errors, cw_errors = x.frame_errors(res.bits)
        fer = errors / WATERFALL_FRAMES
        emit("waterfall", ebn0_db=ebn0, decoder=WATERFALL_DECODER,
             frames=WATERFALL_FRAMES, fer=fer, band=f"{op} {lim}",
             codeword_frame_errors=cw_errors,
             mean_iters=res.iterations.float().mean().item())
        if not (fer >= lim if op == ">=" else fer <= lim):
            raise AssertionError(f"FER {fer} at {ebn0} dB outside {op} {lim}")

    # 6. the exact-BP kernel against its plain version
    exact_err = {"spa": 0.0, "minstar": 0.0}
    k1c_lines = []
    for cn in ("spa", "minstar"):
        for name, code, spec_str, ebn0, B in EXACT_CASES:
            spec_str = spec_str.format(cn=cn)
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_exact(x.graph, x.llr, x.kw)
            exact_err[cn] = max(exact_err[cn], r["max_abs_err"])
            k1c_lines.append(r)
            emit("exact_vs_plain", case=f"{cn}_{name}", code=code,
                 decoder=spec_str, **r)
    check_plans("layered_exact", k1c_lines)
    trap_spa = "layered/spa/50"
    r = compare_exact(choose_graph(spec12, trap_spa),
                      torch.as_tensor(trap["llr"], device=dev),
                      parse_decoder_spec(trap_spa))
    exact_err["spa"] = max(exact_err["spa"], r["max_abs_err"])
    emit("exact_vs_plain", case="spa_trap_batch_track_50", decoder=trap_spa, **r)
    exact_parity = {}
    for cn in ("spa", "minstar"):
        x = make_inputs(**EXACT_LEGS[cn], device=dev, seed=0)
        exact_parity[cn] = r = compare_exact(x.graph, x.llr, x.kw)
        exact_err[cn] = max(exact_err[cn], r["max_abs_err"])
        emit("exact_vs_plain", case=f"{cn}_bench_shape", **r)
        del x

    # 7. the exact kernel timed at full width; each rule's count is read
    # around its own run
    exact_bench, exact_bench_launches, exact_plans = {}, {}, {}
    for cn in ("spa", "minstar"):
        layered_exact_cuda.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(**EXACT_LEGS[cn], device=dev)
        exact_bench_launches[cn] = layered_exact_cuda.launches
        exact_plans[cn] = tile_line(layered_exact_cuda, res.batch)["plan"]
        fer = res.frame_errors / res.batch
        emit("exact_bench", cn=cn, smi_before=smi_before,
             smi_after=smi_sample(), ms=res.wall_s_per_batch * 1e3,
             mbps=res.throughput_mbps,
             tries_ms=[t * 1e3 for t in res.tries_s],
             launches=exact_bench_launches[cn], bound_ms=res.bound_ms,
             bound_by=res.roofline_form,
             plain_ms=exact_parity[cn]["plain_ms"], plan=exact_plans[cn],
             frame_errors=res.frame_errors,
             frames=res.batch, fer=fer,
             codeword_frame_errors=res.codeword_frame_errors)
        if not fer <= EXACT_FER_MAX:
            raise AssertionError(f"{cn}: FER {fer} above {EXACT_FER_MAX}")
        if exact_bench_launches[cn] <= 0:
            raise AssertionError(f"{cn}: the exact kernel never launched")
        exact_bench[cn] = res

    # 8. the sweep against the golden curve
    with open(GOLDEN) as f:
        golden = [PointResult.from_json(d) for d in json.load(f)]
    t0 = time.perf_counter()
    swept = run_sweep(SweepSpec(
        code="dvbs2/64800/12", decoder=SWEEP_DECODER, ebn0_db=SWEEP_EBN0,
        batch=2048, stopping=StoppingRule(min_frame_errors=100,
                                          max_frames=32768)), device=dev)
    overlap = curves_overlap(swept, golden, "fer")
    for pr in swept:
        g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
        emit("sweep_vs_golden", decoder=SWEEP_DECODER, **point_line(pr),
             golden_fer=g.fer, golden_fer_ci=g.fer_ci)
    emit("sweep_vs_golden", overlap=overlap,
         seconds=time.perf_counter() - t0)
    if not overlap:
        raise AssertionError("the sweep's FER curve misses the golden curve")

    # 9. the production sweep's own inputs: its first batch, as run_sweep
    # draws it, through the primary's kernel and plain version; then the
    # rows the primary failed, as with_retry gathers them, through the
    # fallback's
    prod_spec = SweepSpec(code=PRODUCTION_SWEEP["code"],
                          decoder=PRODUCTION_SWEEP["decoder"],
                          ebn0_db=(PRODUCTION_SWEEP["ebn0_db"],),
                          batch=PRODUCTION_SWEEP["batch"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(step_seed(prod_spec.seed, 0, 0, 0))
    _, llr = Pipeline.build(prod_spec, dev).frames(gen, prod_spec.ebn0_db[0])
    primary_spec, fallback_spec = prod_spec.decoder.split(";retry=")
    graph = choose_graph(spec12, prod_spec.decoder)
    r, kern = compare(graph, llr, parse_decoder_spec(primary_spec))
    max_err = max(max_err, r["max_abs_err"])
    emit("kernel_vs_plain", case="production_first_batch",
         decoder=primary_spec, **r)
    failed = torch.nonzero(~kern.ok).squeeze(1)
    if len(failed) == 0:
        raise AssertionError("the production batch sent no frame to retry")
    r = compare_exact(graph, llr.index_select(0, failed),
                      parse_decoder_spec(fallback_spec))
    exact_err["spa"] = max(exact_err["spa"], r["max_abs_err"])
    emit("exact_vs_plain", case="spa_production_fallback_rows",
         decoder=fallback_spec, **r)
    del llr, kern

    # 10. the production path through the CLI: counts from this run only
    layered_decode_cuda.launches = 0
    layered_exact_cuda.launches = 0
    layered_exact_cuda.frames = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", PRODUCTION_SWEEP["code"],
            "--decoder", PRODUCTION_SWEEP["decoder"],
            "--ebn0", str(PRODUCTION_SWEEP["ebn0_db"]),
            "--batch", str(PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        (prod,) = [PointResult.from_json(d)
                   for d in json.loads(out.read_text())]
    sweep_launches = {"layered_qc": layered_decode_cuda.launches,
                      "layered_exact": layered_exact_cuda.launches}
    emit("production", decoder=prod.decoder, rc=rc, **point_line(prod),
         seconds=wall, launches=sweep_launches,
         frames_to_fallback=layered_exact_cuda.frames)
    if rc != 0 or prod.frames != PRODUCTION_FRAMES:
        raise AssertionError(f"production sweep: rc {rc}, {prod.frames} frames")
    if not prod.fer <= PRODUCTION_FER_MAX:
        raise AssertionError(f"production FER {prod.fer} above "
                             f"{PRODUCTION_FER_MAX}")
    if sweep_launches["layered_exact"] <= 0 or layered_exact_cuda.frames <= 0:
        raise AssertionError("the retry fallback never ran: no exact launch")
    if sweep_launches["layered_qc"] <= 0:
        raise AssertionError("the production primary never launched")
    # the stored trap frames through the same decoder on the card
    production = PRODUCTION_SWEEP["decoder"]
    graph = choose_graph(spec12, production)
    llr = torch.as_tensor(trap["llr"], device=dev)
    cw = torch.as_tensor(trap["cw"], device=dev)
    primary = get_decoder(graph, production.split(";retry=")[0], device=dev)(llr)
    retried = get_decoder(graph, production, device=dev)(llr)
    emit("production_trap", frames=len(cw),
         primary_ok=int(primary.ok.sum().item()),
         retry_ok=int(retried.ok.sum().item()),
         retry_exact=bool(torch.equal(retried.bits, cw)),
         iterations=retried.iterations.tolist())
    if bool(primary.ok.any()):
        raise AssertionError("the primary decodes a stored trap frame")
    if not (bool(retried.ok.all()) and torch.equal(retried.bits, cw)):
        raise AssertionError("the retry decoder misses a trap codeword")

    # 11. the flooding kernel (K2) against its plain version on mackay1008
    k2 = (flooding_with_posteriors_cuda, flooding_with_posteriors_plain)
    k3 = (flooding_qc_with_posteriors_cuda, flooding_qc_with_posteriors_plain)
    flood_err = {f"flooding:{k}": 0.0 for k in KINDS}
    flood_err.update({f"flooding_qc:{k}": 0.0 for k in KINDS})
    k2_lines = []
    for name, spec_str, ebn0, B in FLOODING_CASES:
        x = make_inputs("mackay1008", spec_str, B, ebn0, dev, seed=1)
        r = compare_flooding(x.graph, x.llr, x.kw, *k2)
        key = f"flooding:{x.kw['kind']}"
        flood_err[key] = max(flood_err[key], r["max_abs_err"])
        k2_lines.append(r)
        emit("flooding_vs_plain", case=name, decoder=spec_str, **r)
    big = regular_graph(FLOODING_GLOBAL_N)
    for name, kw in FLOODING_GLOBAL_CASES:
        llr = zero_codeword_llr(big, FLOODING_GLOBAL_B, 2.0, dev)
        r = compare_flooding(big, llr, kw, *k2)
        key = f"flooding:{kw['kind']}"
        flood_err[key] = max(flood_err[key], r["max_abs_err"])
        k2_lines.append(r)
        emit("flooding_vs_plain", case=name, code=big.name, **r)
    del big
    check_k2_plans(k2_lines)
    # each rule at the timed leg's shape (the leg's code, batch and seed)
    mackay_legs = {k: dict(FLOODING_LEGS["mackay"],
                           decoder=f"{RULE[k]}/25/noet") for k in KINDS}
    flood_parity = {}
    for k in KINDS:
        x = make_inputs(**mackay_legs[k], device=dev, seed=0)
        flood_parity[f"flooding:{k}"] = r = compare_flooding(
            x.graph, x.llr, x.kw, *k2)
        flood_err[f"flooding:{k}"] = max(flood_err[f"flooding:{k}"],
                                         r["max_abs_err"])
        emit("flooding_vs_plain", case=f"{k}_bench_shape", **r)

    # 12. the QC flooding kernel (K3) against its plain version; its case
    # lines (with 16's and 20's) are held to the plans they must include
    k3_lines = []
    for k in KINDS:
        for name, code, spec_str, ebn0, B in FLOODING_QC_CASES:
            spec_str = spec_str.format(r=RULE[k])
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_flooding(x.graph, x.llr, x.kw, *k3)
            flood_err[f"flooding_qc:{k}"] = max(flood_err[f"flooding_qc:{k}"],
                                                r["max_abs_err"])
            k3_lines.append(dict(r, code=code))
            emit("flooding_qc_vs_plain", code=code, case=f"{k}_{name}",
                 decoder=spec_str, **r)
    r = compare_flooding(choose_graph(spec12, "spa/50"),
                         torch.as_tensor(trap["llr"], device=dev),
                         parse_decoder_spec("spa/50"), *k3)
    flood_err["flooding_qc:spa"] = max(flood_err["flooding_qc:spa"],
                                       r["max_abs_err"])
    emit("flooding_qc_vs_plain", case="spa_trap_batch_track_50",
         decoder="spa/50", **r)
    for k in KINDS:
        x = make_inputs(**FLOODING_LEGS[f"dvbs2_{k}"], device=dev, seed=0)
        flood_parity[f"flooding_qc:{k}"] = r = compare_flooding(
            x.graph, x.llr, x.kw, *k3)
        flood_err[f"flooding_qc:{k}"] = max(flood_err[f"flooding_qc:{k}"],
                                            r["max_abs_err"])
        emit("flooding_qc_vs_plain", case=f"{k}_bench_shape", **r)
        del x

    # 13. the flooding legs timed; each count read around its own run
    flood_bench, flood_launches, flood_plans = {}, {}, {}
    timed_legs = [(f"flooding:{k}", mackay_legs[k], flooding_decode_cuda)
                  for k in KINDS]
    timed_legs += [(f"flooding_qc:{k}", FLOODING_LEGS[f"dvbs2_{k}"],
                    flooding_qc_decode_cuda) for k in KINDS]
    for key, cfg, wrapper in timed_legs:
        wrapper.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        flood_launches[key] = wrapper.launches
        flood_plans[key] = tile_line(wrapper, res.batch)["plan"]
        per_decode = {}
        if wrapper is flooding_decode_cuda:  # host and device µs a decode
            x = make_inputs(**cfg, device=dev, seed=0)
            per_decode = time_decode(x.graph, x.llr, x.kw)[0]
            del per_decode["plan"], x
        emit("flooding_bench", kernel=key, code=cfg["code"],
             decoder=cfg["decoder"], plain_ms=flood_parity[key]["plain_ms"],
             plan=flood_plans[key], **per_decode,
             **bench_line(res, flood_launches[key], smi_before))
        if flood_launches[key] <= 0:
            raise AssertionError(f"{key}: the kernel never launched")
        if cfg["code"] == "mackay1008" and not (
                res.frame_errors / res.batch <= MACKAY_FER_MAX):
            raise AssertionError(f"{key}: FER above {MACKAY_FER_MAX}")
        flood_bench[key] = res

    # 14. the mackay1008 sweep against the golden curves; K2's count read
    # around the spa/50 sweep, the path that decodes with it in a sweep
    for dec_spec, path in GOLDEN_MACKAY.items():
        with open(path) as f:
            golden = [PointResult.from_json(d) for d in json.load(f)
                      if d["decoder"] == dec_spec]
        flooding_decode_cuda.launches = 0
        t0 = time.perf_counter()
        swept = run_sweep(SweepSpec(
            code="mackay1008", decoder=dec_spec, ebn0_db=MACKAY_SWEEP_EBN0,
            batch=4096, stopping=StoppingRule(min_frame_errors=100,
                                              max_frames=65536)), device=dev)
        if dec_spec == "spa/50":
            flood_launches["flooding:spa"] = flooding_decode_cuda.launches
        overlap = curves_overlap(swept, golden, "fer")
        for pr in swept:
            g = next(q for q in golden if abs(q.ebn0_db - pr.ebn0_db) < 1e-9)
            emit("mackay_vs_golden", decoder=dec_spec, **point_line(pr),
                 golden_fer=g.fer, golden_fer_ci=g.fer_ci, golden=path.name)
        emit("mackay_vs_golden", decoder=dec_spec, overlap=overlap,
             launches=flooding_decode_cuda.launches,
             seconds=time.perf_counter() - t0)
        if not overlap:
            raise AssertionError(f"{dec_spec}: mackay1008 FER misses "
                                 f"{path.name}")

    # 15. the floor program's first production decoder, with the flooding
    # fallback, through the CLI: counts from this run only
    layered_decode_cuda.launches = 0
    flooding_qc_decode_cuda.launches = 0
    flooding_qc_decode_cuda.frames = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "production_flooding.json"
        t0 = time.perf_counter()
        rc = cli_main([
            "sweep", "--code", FLOODING_PRODUCTION_SWEEP["code"],
            "--decoder", FLOODING_PRODUCTION_SWEEP["decoder"],
            "--ebn0", str(FLOODING_PRODUCTION_SWEEP["ebn0_db"]),
            "--batch", str(FLOODING_PRODUCTION_SWEEP["batch"]),
            "--min-frame-errors", "1000000",
            "--max-frames", str(PRODUCTION_FRAMES), "--out", str(out)])
        wall = time.perf_counter() - t0
        (prod,) = [PointResult.from_json(d)
                   for d in json.loads(out.read_text())]
    flood_sweep = {"layered_qc": layered_decode_cuda.launches,
                   "flooding_qc": flooding_qc_decode_cuda.launches}
    emit("production_flooding", decoder=prod.decoder, rc=rc,
         **point_line(prod), seconds=wall, launches=flood_sweep,
         frames_to_fallback=flooding_qc_decode_cuda.frames)
    if rc != 0 or prod.frames != PRODUCTION_FRAMES:
        raise AssertionError(f"flooding production sweep: rc {rc}, "
                             f"{prod.frames} frames")
    if not prod.fer <= PRODUCTION_FER_MAX:
        raise AssertionError(f"flooding production FER {prod.fer} above "
                             f"{PRODUCTION_FER_MAX}")
    if flood_sweep["flooding_qc"] <= 0 or flooding_qc_decode_cuda.frames <= 0:
        raise AssertionError("the flooding fallback never ran")
    if flood_sweep["layered_qc"] <= 0:
        raise AssertionError("the production primary never launched")
    flood_launches["flooding_qc:spa"] = flood_sweep["flooding_qc"]
    production = FLOODING_PRODUCTION_SWEEP["decoder"]
    graph = choose_graph(spec12, production)
    llr = torch.as_tensor(trap["llr"], device=dev)
    cw = torch.as_tensor(trap["cw"], device=dev)
    primary = get_decoder(graph, production.split(";retry=")[0],
                          device=dev)(llr)
    retried = get_decoder(graph, production, device=dev)(llr)
    emit("production_flooding_trap", frames=len(cw),
         primary_ok=int(primary.ok.sum().item()),
         retry_ok=int(retried.ok.sum().item()),
         retry_exact=bool(torch.equal(retried.bits, cw)),
         iterations=retried.iterations.tolist())
    if bool(primary.ok.any()):
        raise AssertionError("the primary decodes a stored trap frame")
    if not (bool(retried.ok.all()) and torch.equal(retried.bits, cw)):
        raise AssertionError("the flooding retry misses a trap codeword")

    kernels_ccsds = ccsds_path(dev, spec12, k3, flood_err, k3_lines)
    kernels_xor = xor_path(dev, k3_lines)
    kernels_dist = dist_path(dev)

    hl = results["headline"]
    kernels = [{
        "name": "layered_qc",
        "route": "cuda",
        "source": "ecc_ldpc_tpu_torch/csrc/layered_qc.cu",
        "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:146",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": hl.wall_s_per_batch * 1e3,
        "plain_ms": leg_parity["headline"]["plain_ms"],
        "bound_ms": hl.bound_ms,
        "bound_by": hl.roofline_form,
        "library_ms": None,
        "plan": leg_plans["headline"],
    }]
    for cn in ("spa", "minstar"):
        res = exact_bench[cn]
        kernels.append({
            "name": f"layered_exact:{cn}",
            "route": "cuda",
            "source": "ecc_ldpc_tpu_torch/csrc/layered_exact.cu",
            "replaces": "ecc_ldpc_tpu/decode/pallas/layered_qc.py:501",
            # spa: the production sweep (the retry fallback); minstar: its
            # own timed run, the only path that decodes with it
            "launches": (sweep_launches["layered_exact"] if cn == "spa"
                         else exact_bench_launches[cn]),
            "max_abs_err": exact_err[cn],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": exact_parity[cn]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
            "plan": exact_plans[cn],
        })
    # K2's minsum count is its leg's (the benchmark's mackay1008 path), spa's
    # the spa/50 golden sweep's, minstar's its own timed run's; K3's spa
    # count is the production sweep's fallback, minsum's and minstar's
    # their timed legs'
    sources = {"flooding": ("ecc_ldpc_tpu_torch/csrc/flooding.cu",
                            "ecc_ldpc_tpu/decode/pallas/fused_mm.py:151"),
               "flooding_qc": ("ecc_ldpc_tpu_torch/csrc/flooding_qc.cu",
                               "ecc_ldpc_tpu/decode/pallas/flooding_qc.py:85")}
    for key, res in flood_bench.items():
        src, replaces = sources[key.split(":")[0]]
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": flood_launches[key],
            "max_abs_err": flood_err[key],
            "ms": res.wall_s_per_batch * 1e3,
            "plain_ms": flood_parity[key]["plain_ms"],
            "bound_ms": res.bound_ms,
            "bound_by": res.roofline_form,
            "library_ms": None,
        })
        kernels[-1]["plan"] = flood_plans[key]
    kernels += kernels_ccsds + kernels_xor + kernels_dist
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the path never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
