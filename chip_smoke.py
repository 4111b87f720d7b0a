"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and exits non-zero):
  1. device  — the card's name and nvidia-smi's name and power limit.
  2. build   — nvcc builds every kernel of the path into build/kernels/.
  3. kernel vs plain — the CUDA layered kernel against its plain PyTorch
     version on the same LLRs on the card: bits, ok and iterations must be
     identical (fixed and track mode, rate 1/2, 3/4 and 9/10 — row
     degrees 7-8, 14-15 and 30-31, one build of the kernel each — scalar
     and offset alpha/beta, the learned schedule, the stored trap batch,
     and each main-path leg's shapes).
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
     stored trap batch with layered/spa/50, and each rule at the timed
     shape (4096 frames). Bits, ok and iterations must be identical, and the
     posteriors after one sweep within EXACT_MAX_ULPS.
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
     and 6.
  10. production path — the CLI's sweep with the production retry decoder
     layered/norm:0.8125/50;retry=layered/spa/50 at 1.5 dB, 65536 frames
     in batches of 4096: FER <= 1.5e-4, the fallback fired, the exact
     kernel launched; then the 8 trap frames through the same decoder:
     the primary fails all 8 and the retry recovers each codeword.
  11. flooding kernel vs plain — K2 (csrc/flooding.cu) against its plain
     version on mackay1008 on the same LLRs on the card: minsum fixed at
     2.5 dB and track at 2.0 dB, spa and minstar fixed and track at
     1.5 dB (32 frames; 13 for a ragged last tile), and each rule at the
     timed leg's shape (2048 frames). Bits, ok and iterations identical;
     posteriors after one iteration within EXACT_MAX_ULPS.
  12. QC flooding kernel vs plain — K3 (csrc/flooding_qc.cu) the same
     way on dvbs2/64800/12, each rule: fixed at 1.5 dB and track at 1.2
     dB (32 and 13 frames), r=3/4 fixed at 3.0 dB and r=9/10 fixed at 4.0
     dB (its 16- and 32-wide builds), the stored trap batch with spa/50,
     and each timed leg's shape (4096 frames).
  13. flooding legs timed — bench.FLOODING_LEGS through run_benchmark
     (mackay1008 minsum, and spa and minstar on the same shape; the three
     dvbs2/64800/12 flooding legs): ms, Mbit/s, launches, bound, plain ms,
     FER (mackay1008 <= 0.01; the DVB-S2 legs are held to no band: the
     repo stores no flooding FER for that code).
  14. mackay1008 sweep vs golden — run_sweep of spa/50 and
     minsum/norm:0.8125/25 at 1.5 and 2.0 dB (batch 4096, 100 frame
     errors or 65536 frames) must overlap curves/mackay1008_tpu_golden.json
     and curves/mackay1008_cpu_golden.json.
  15. flooding fallback in production — the CLI's sweep with
     layered/norm:0.8125/50;retry=spa/50 at 1.5 dB, 65536 frames in
     batches of 4096: FER <= 1.5e-4, K1a and K3 launched, the fallback
     got frames; then the 8 trap frames: the primary fails all 8 and the
     flooding retry recovers each codeword.
Then the kernels line, nvidia-smi's line, and the result line last.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ecc_ldpc_tpu_torch import _build
from ecc_ldpc_tpu_torch.bench.throughput import (
    EXACT_LEGS,
    FLOODING_LEGS,
    FLOODING_PRODUCTION_SWEEP,
    LEGS,
    PRODUCTION_SWEEP,
    make_inputs,
    run_benchmark,
)
from ecc_ldpc_tpu_torch.cli.main import main as cli_main
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
    exact_with_posteriors_cuda,
    layered_decode_cuda,
    layered_decode_plain,
    layered_exact_cuda,
    plain_with_posteriors,
)
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
# K2 vs plain on mackay1008: (name, spec with {r}, Eb/N0 dB, B)
FLOODING_CASES = [
    ("minsum_fixed_2.5dB", "minsum/norm:0.8125/25/noet", 2.5, 32),
    ("minsum_track_2.0dB", "minsum/norm:0.8125/25", 2.0, 32),
    ("minsum_track_2.0dB_13frames", "minsum/norm:0.8125/25", 2.0, 13),
    *[(f"{k}_{m}_1.5dB", f"{k}/25" + ("/noet" if m == "fixed" else ""),
       1.5, 32) for k in ("spa", "minstar") for m in ("fixed", "track")],
    ("spa_track_1.5dB_13frames", "spa/50", 1.5, 13),
]
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def compare(graph, llr, kw):
    """Kernel and plain version on the same LLRs; raises unless identical.
    Returns (the numbers to print, the kernel's DecodeResult)."""
    dkw = {k: kw[k] for k in ("alpha", "beta", "max_iters", "early_term")
           if k in kw}
    kern, kern_ms = timed(layered_decode_cuda, graph, llr, **dkw)
    plain, plain_ms = timed(layered_decode_plain, graph, llr, **dkw)
    err = max(
        (kern.bits.int() - plain.bits.int()).abs().max().item(),
        (kern.ok.int() - plain.ok.int()).abs().max().item(),
        (kern.iterations - plain.iterations).abs().max().item(),
    )
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations))
    if not same:
        raise AssertionError(f"kernel and plain version differ (max abs err {err})")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=float(err),
                frames=llr.shape[0], ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item()), kern


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 on a line where adjacent floats differ by 1 (+0 = -0)."""
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def compare_exact(graph, llr, kw) -> dict:
    """Exact kernel and plain version on the same LLRs: raises unless bits,
    ok and iterations are identical and, after one fixed sweep, the
    posteriors are within EXACT_MAX_ULPS."""
    dkw = dict(max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True), cn=kw["cn"])
    (kern, ktot), kern_ms = timed(exact_with_posteriors_cuda, graph, llr, **dkw)
    (plain, ptot), plain_ms = timed(plain_with_posteriors, graph, llr, **dkw)
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations))
    max_abs = (ktot - ptot).abs().max().item()
    one = dict(dkw, max_iters=1, early_term=False)
    _, k1 = exact_with_posteriors_cuda(graph, llr, **one)
    _, p1 = plain_with_posteriors(graph, llr, **one)
    ulps1 = int((_ordered(k1) - _ordered(p1)).abs().max().item())
    if not same:
        raise AssertionError(
            f"exact kernel and plain version decide differently (posterior "
            f"max abs err {max_abs}, one-sweep ulps {ulps1})")
    if ulps1 > EXACT_MAX_ULPS:
        raise AssertionError(f"one-sweep posteriors {ulps1} ulps apart")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=max_abs,
                one_sweep_max_ulps=ulps1, frames=llr.shape[0],
                ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item())


def compare_flooding(graph, llr, kw, kernel_fn, plain_fn) -> dict:
    """A flooding kernel (`kernel_fn`, its with-posteriors wrapper) and its
    plain version (`plain_fn`) on the same LLRs: raises unless bits, ok and iterations
    are identical and, after one fixed iteration, the posteriors are within
    EXACT_MAX_ULPS."""
    dkw = dict(kind=kw["kind"], alpha=kw.get("alpha", 1.0),
               beta=kw.get("beta", 0.0), max_iters=kw.get("max_iters", 25),
               early_term=kw.get("early_term", True))
    (kern, ktot), kern_ms = timed(kernel_fn, graph, llr, **dkw)
    (plain, ptot), plain_ms = timed(plain_fn, graph, llr, **dkw)
    same = (torch.equal(kern.bits, plain.bits) and torch.equal(kern.ok, plain.ok)
            and torch.equal(kern.iterations, plain.iterations))
    max_abs = (ktot - ptot).abs().max().item()
    one = dict(dkw, max_iters=1, early_term=False)
    _, k1 = kernel_fn(graph, llr, **one)
    _, p1 = plain_fn(graph, llr, **one)
    ulps1 = int((_ordered(k1) - _ordered(p1)).abs().max().item())
    if not same:
        raise AssertionError(
            f"flooding kernel and plain version decide differently "
            f"(posterior max abs err {max_abs}, one-sweep ulps {ulps1})")
    if ulps1 > EXACT_MAX_ULPS:
        raise AssertionError(f"one-iteration posteriors {ulps1} ulps apart")
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, max_abs_err=max_abs,
                one_sweep_max_ulps=ulps1, frames=llr.shape[0],
                ok_frames=int(kern.ok.sum().item()),
                mean_iters=kern.iterations.float().mean().item())


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
    for name, code, spec_str, ebn0 in PARITY_CASES:
        x = make_inputs(code, spec_str, 32, ebn0, dev, seed=1)
        r, _ = compare(x.graph, x.llr, x.kw)
        max_err = max(max_err, r["max_abs_err"])
        emit("kernel_vs_plain", case=name, **r)
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
        emit("kernel_vs_plain", case=f"{leg}_shape", **r)
        del x

    # the main path: counts from these three legs only
    layered_decode_cuda.launches = 0
    results = {}
    for leg, cfg in LEGS.items():
        before = layered_decode_cuda.launches
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
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
    for cn in ("spa", "minstar"):
        for name, code, spec_str, ebn0, B in EXACT_CASES:
            spec_str = spec_str.format(cn=cn)
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_exact(x.graph, x.llr, x.kw)
            exact_err[cn] = max(exact_err[cn], r["max_abs_err"])
            emit("exact_vs_plain", case=f"{cn}_{name}", decoder=spec_str, **r)
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
    exact_bench, exact_bench_launches = {}, {}
    for cn in ("spa", "minstar"):
        layered_exact_cuda.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(**EXACT_LEGS[cn], device=dev)
        exact_bench_launches[cn] = layered_exact_cuda.launches
        fer = res.frame_errors / res.batch
        emit("exact_bench", cn=cn, smi_before=smi_before,
             smi_after=smi_sample(), ms=res.wall_s_per_batch * 1e3,
             mbps=res.throughput_mbps,
             tries_ms=[t * 1e3 for t in res.tries_s],
             launches=exact_bench_launches[cn], bound_ms=res.bound_ms,
             bound_by=res.roofline_form,
             plain_ms=exact_parity[cn]["plain_ms"], frame_errors=res.frame_errors,
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
    for name, spec_str, ebn0, B in FLOODING_CASES:
        x = make_inputs("mackay1008", spec_str, B, ebn0, dev, seed=1)
        r = compare_flooding(x.graph, x.llr, x.kw, *k2)
        key = f"flooding:{x.kw['kind']}"
        flood_err[key] = max(flood_err[key], r["max_abs_err"])
        emit("flooding_vs_plain", case=name, decoder=spec_str, **r)
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

    # 12. the QC flooding kernel (K3) against its plain version
    for k in KINDS:
        for name, code, spec_str, ebn0, B in FLOODING_QC_CASES:
            spec_str = spec_str.format(r=RULE[k])
            x = make_inputs(code, spec_str, B, ebn0, dev, seed=1)
            r = compare_flooding(x.graph, x.llr, x.kw, *k3)
            flood_err[f"flooding_qc:{k}"] = max(flood_err[f"flooding_qc:{k}"],
                                                r["max_abs_err"])
            emit("flooding_qc_vs_plain", case=f"{k}_{name}", decoder=spec_str,
                 **r)
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
    flood_bench, flood_launches = {}, {}
    timed_legs = [(f"flooding:{k}", mackay_legs[k], flooding_decode_cuda)
                  for k in KINDS]
    timed_legs += [(f"flooding_qc:{k}", FLOODING_LEGS[f"dvbs2_{k}"],
                    flooding_qc_decode_cuda) for k in KINDS]
    for key, cfg, wrapper in timed_legs:
        wrapper.launches = 0
        smi_before = smi_sample()
        res = run_benchmark(**cfg, device=dev)
        flood_launches[key] = wrapper.launches
        emit("flooding_bench", kernel=key, code=cfg["code"],
             decoder=cfg["decoder"], plain_ms=flood_parity[key]["plain_ms"],
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
