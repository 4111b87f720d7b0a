"""Traffic kind "decode": the port's decoder alone, in a closed loop.

System under test: the callable decode.api.get_decoder(choose_graph(code,
spec), spec, device) returns, the entry a decoder user calls. Inputs: a
pool of LLR batches that the benchmark makes at set-up, one at a time
(traffic.py: message bits and normals from the seed, encoded and sent
through the channel by the configuration's code reference); making them
counts as set-up. Warm-up: one call at the batch shape, the only shape the window
sends. The window calls the decoder on the pool's batches in turn (and
goes on past its length until every compared call has run), one caller, each call timed from a CUDA event recorded before it to one after
it, which the host waits on before the next call: the time until the bits
are ready on the device.

Correctness: for each pool batch traffic.compared() draws, the outputs of
one of its calls in the window (bits, ok flags, iterations) are kept and,
once the window has closed and the decoder is freed, held against the
mix's decoder reference on the same LLRs. The decoder's
contract is bit-identity with the plain f32 decoder, so every count of
differences has the limit 0.
"""
from __future__ import annotations

import time

import torch

from . import harness, traffic
from .tracing import elapsed_ms, stamp, wait

REQUEST_SPAN = "decode.request"
# check -> limit: bits, ok flags and iteration counts that differ from the
# reference over the compared calls
LIMITS = {"bits_off": 0, "ok_off": 0, "iters_off": 0}


def build(config: dict, mix: traffic.Mix, device):
    """(the port's code, its decoder) for the cell."""
    from ecc_ldpc_tpu_torch.codes.registry import get_code
    from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder

    code = get_code(config["code"])
    return code, get_decoder(choose_graph(code, mix.decoder), mix.decoder,
                             device=device)


def inputs(cell, seed: int, device) -> list:
    """The pool of channel LLR batches, f32 [batch, n] each; each batch's
    draws are dropped once its LLRs are made."""
    ref, table, mix = cell.code_ref, cell.table, cell.mix
    return [ref.llr(table, ref.encode(table, msg), noise, mix.ebn0_db)
            for msg, noise in traffic.make_pool(mix, table.k, table.n, seed,
                                                device)]


def run(cell, seed, seconds, tracer, device, t_start, wrap=None):
    table, mix = cell.table, cell.mix
    code, dec = build(cell.config, mix, device)
    cell.code_ref.check_registered(table, code)
    if wrap is not None:
        dec = wrap(dec)
    llrs = inputs(cell, seed, device)
    picks = traffic.compared(mix, seed)
    keep_at = {r: p for p, r in picks.items()}
    last = max(keep_at)
    dec(llrs[0])
    wait(stamp(device))
    before = harness.counters()
    if device.type == "cuda":
        # the window's peak: the pool and the decoder at work, not set-up's
        torch.cuda.reset_peak_memory_stats(device)

    marks, host_us, iterations, kept = [], [], [], {}
    with tracer.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            with tracer.span(REQUEST_SPAN):
                a = stamp(device)
                h = time.perf_counter()
                with tracer.span("decode.call"):
                    res = dec(llrs[i % mix.pool])
                host_us.append((time.perf_counter() - h) * 1e6)
                b = stamp(device)
                with tracer.span("decode.wait"):
                    wait(b)
            marks.append((a, b))
            iterations.append(res.iterations)
            if i in keep_at:
                kept[keep_at[i]] = res
            i += 1
            if time.perf_counter() - t0 >= seconds and i > last:
                break
        window_s = time.perf_counter() - t0
    setup_s = t0 - t_start
    record = {
        "kind": "decode", "device": device.type, "setup_s": setup_s,
        "window_s": window_s, "requests": i, "frames": i * mix.batch,
        "k": table.k, "n": table.n, "m": table.m,
        "edges": table.num_edges, "batch": mix.batch,
        "request_ms": [elapsed_ms(a, b) for a, b in marks],
        "host_us": host_us,
        "iteration_sums": [int(t.sum()) for t in iterations],
        "counters": harness.counter_deltas(before),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
        "rule": cell.decoder_ref.parse(mix.decoder).rule,
    }
    del dec, code, iterations, res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = compare(cell, llrs, kept)
    return record, checks, failed


def compare(cell, llrs, kept):
    """(checks {name: (value, limit)}, calls that differ) of the kept
    outputs against the reference."""
    ref, table = cell.decoder_ref, cell.table
    spec = ref.parse(cell.mix.decoder)
    off = dict.fromkeys(("bits_off", "ok_off", "iters_off"), 0)
    failed = 0
    for p, res in sorted(kept.items()):
        bits, ok, iters = ref.decode(table, llrs[p], spec)
        diff = {"bits_off": harness.off(res.bits, bits),
                "ok_off": harness.off(res.ok, ok),
                "iters_off": harness.off(res.iterations, iters)}
        failed += any(diff.values())
        for key, v in diff.items():
            off[key] += v
    return {k: (v, LIMITS[k]) for k, v in off.items()}, failed
