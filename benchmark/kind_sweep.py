"""Traffic kind "sweep": one step of the Monte-Carlo sweep, in a closed loop.

System under test: sim.runner.Pipeline.build(SweepSpec(...)) for the cell's
code, decoder and batch; a step is pipeline.counts(msg, noise, ebn0_db)
(encode, channel, decode with its retry, tally) followed by the host read
of its four counters, as run_sweep's step does. The message bits and the
channel's normals are the benchmark's (traffic.py), a pool made at set-up
and sent in turn, as the sharded sweep hands its own draws to counts(); the
port's own draw (torch's generator) is therefore outside the window.
Warm-up: one step on every pool batch, so the fallback decoder has seen
every batch size the window gives it. The window goes on past its length
until every compared step has run. Each step is timed by the host clock
from the call to the end of the read.

Correctness, stage by stage, for the pool batches traffic.compared() draws
(one step's outputs of each kept inside the window, as the port's encoder
and decoder hand them on):
  cw_bits_off   codeword bits that differ from the reference encoder's
  llr_gap       largest |LLR - reference LLR| over the largest |reference
                LLR|; the reference works its LLRs out from its own
                codewords and the same normals
  msg_bits_off  message bits that differ from the reference decoder's on
                the port's LLRs (the decoder with its retry)
  iters_off     frames whose iteration count differs
  tally_off     sum of |counter - reference counter| over every step of
                the window that sent those batches
The decoder stage follows the port's own LLRs, so a channel within its
limit cannot move the decoder's comparison.
"""
from __future__ import annotations

import collections
import time

import torch

from . import harness, traffic
from .tracing import stamp, wait

REQUEST_SPAN = "sweep.step"
# check -> limit. Exact comparisons have the limit 0. llr_gap: sound runs
# read 0 (the port computes the channel with the same float32 operations in
# the same order; a reordering would read an ulp, ~6e-8), the bf16 control
# 2.6e-3 and more; 1e-4 lies three decades above an ulp and one and a half
# below the control (PERF.md gives the readings)
LIMITS = {"cw_bits_off": 0, "llr_gap": 1e-4, "msg_bits_off": 0,
          "iters_off": 0, "tally_off": 0}


def build(config: dict, mix: traffic.Mix, device):
    """(the port's code, its sweep pipeline) for the cell."""
    from ecc_ldpc_tpu_torch.codes.registry import get_code
    from ecc_ldpc_tpu_torch.sim.runner import Pipeline, SweepSpec

    spec = SweepSpec(code=config["code"], decoder=mix.decoder,
                     ebn0_db=(mix.ebn0_db,), batch=mix.batch)
    return get_code(config["code"]), Pipeline.build(spec, device)


def instrument(pipe, tracer, state: dict) -> None:
    """Spans around the pipeline's channel (with its encoder) and decoder,
    and the keeping of a step's codewords, LLRs and decoder outputs when
    state["keep"] is a dict."""
    encode0, llr0, decode0 = pipe.encode, pipe.llr, pipe.decode

    def encode_(msg):
        cw = encode0(msg)
        if state["keep"] is not None:
            state["keep"]["cw"] = cw
        return cw

    def llr_(msg, noise, ebn0_db):
        with tracer.timed("sweep.llr"):
            return llr0(msg, noise, ebn0_db)

    def decode_(llr):
        with tracer.timed("sweep.decode"):
            msg_hat, iters = decode0(llr)
        if state["keep"] is not None:
            state["keep"].update(llr=llr, msg_hat=msg_hat, iters=iters)
        return msg_hat, iters

    pipe.encode, pipe.llr, pipe.decode = encode_, llr_, decode_


def run(cell, seed, seconds, tracer, device, t_start, wrap=None):
    table, mix = cell.table, cell.mix
    code, pipe = build(cell.config, mix, device)
    cell.code_ref.check_registered(table, code)
    if wrap is not None:
        pipe = wrap(pipe)
    state = {"keep": None}
    instrument(pipe, tracer, state)
    pool = list(traffic.make_pool(mix, table.k, table.n, seed, device))
    picks = traffic.compared(mix, seed)
    last = max(picks.values())
    for msg, noise in pool:
        pipe.counts(msg, noise, mix.ebn0_db).tolist()
    wait(stamp(device))
    tracer.events.clear()
    before = harness.counters()
    if device.type == "cuda":
        # the window's peak: the pool and the pipeline at work
        torch.cuda.reset_peak_memory_stats(device)

    step_ms, kept, steps = [], {}, collections.defaultdict(list)
    with tracer.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            p = i % mix.pool
            state["keep"] = kept.setdefault(p, {}) if picks.get(p) == i else None
            msg, noise = pool[p]
            h = time.perf_counter()
            with tracer.span(REQUEST_SPAN):
                counts = pipe.counts(msg, noise, mix.ebn0_db)
                with tracer.span("sweep.read"):
                    values = counts.tolist()
            step_ms.append((time.perf_counter() - h) * 1e3)
            if p in picks:
                steps[p].append(values)
            i += 1
            if time.perf_counter() - t0 >= seconds and i > last:
                break
        window_s = time.perf_counter() - t0
    state["keep"] = None
    record = {
        "kind": "sweep", "device": device.type, "setup_s": t0 - t_start,
        "window_s": window_s, "requests": i, "frames": i * mix.batch,
        "k": table.k, "batch": mix.batch, "request_ms": step_ms,
        "spans_ms": tracer.span_ms(),
        "counters": harness.counter_deltas(before),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
        "retry": ";retry=" in mix.decoder,
    }
    del pipe, code, counts
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = compare(cell, pool, kept, steps)
    return record, checks, failed


def tally(msg, msg_hat, iters) -> list:
    """(bit errors, frame errors, iterations, sum of squared bit errors a
    frame) of one batch: a frame error is a wrong message bit."""
    w = (msg_hat != msg).sum(1, dtype=torch.int64)
    return [int(w.sum()), int((w > 0).sum()), int(iters.sum(dtype=torch.int64)),
            int((w * w).sum())]


def compare(cell, pool, kept, steps):
    code_ref, dec_ref, table = cell.code_ref, cell.decoder_ref, cell.table
    spec = dec_ref.parse(cell.mix.decoder)
    off = collections.Counter()
    gap, failed = 0.0, 0
    for p, out in sorted(kept.items()):
        msg, noise = pool[p]
        cw = code_ref.encode(table, msg)
        ref_llr = code_ref.llr(table, cw, noise, cell.mix.ebn0_db)
        same = out["llr"].shape == ref_llr.shape
        bits, _, iters = dec_ref.decode(
            table, out["llr"] if same else ref_llr, spec)
        msg_ref = bits[:, :table.k]
        ref = tally(msg, msg_ref, iters)
        diff = {
            "cw_bits_off": harness.off(out["cw"], cw),
            "msg_bits_off": harness.off(out["msg_hat"], msg_ref),
            "iters_off": harness.off(out["iters"], iters),
            "tally_off": sum(abs(a - b) for v in steps[p]
                             for a, b in zip(v, ref)),
        }
        g = (float((out["llr"] - ref_llr).abs().max() / ref_llr.abs().max())
             if same else 1.0)
        gap = max(gap, g)
        failed += any(diff.values()) or g > LIMITS["llr_gap"]
        off.update(diff)
    checks = {k: off[k] for k in ("cw_bits_off", "msg_bits_off",
                                  "iters_off", "tally_off")}
    checks["llr_gap"] = gap
    return {k: (v, LIMITS[k]) for k, v in checks.items()}, failed
