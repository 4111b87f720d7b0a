"""Decoded-throughput benchmark on the card: decoded Mbit/s per GPU.

Port of ecc_ldpc_tpu/bench/throughput.py. The chain is the user's: code ->
graph -> structured encoder -> AWGN channel -> decoder, on the card, with
random messages and noise from a seeded torch.Generator. Each try is timed
with CUDA events around one decode of the whole batch, after a warm-up
decode; the result is the median of the tries. The JSON line keeps the JAX
package's BenchResult schema; `device` is the card's name.

The bound (roofline_mbps) is the least time an H100 SXM could take for
the same decode, from its published rates: the larger of the compulsory
bytes (4 B of LLR in and 1 B of bits out per code bit per frame) over
3.35 TB/s and the decoder's operations, for the iterations this batch
actually ran, of the check-node rule it decoded (decode_ops): the larger
of the arithmetic over 67 TFLOP/s of fp32 outside the tensor cores and
the transcendentals (exp, log, tanh, log1p of the exact rules) over the
special-function units' 4.18e12 results/s, since the two units issue in
parallel; layered and flooding schedules count differently, and so do the
layered set and accumulate forms (decode_ops). `roofline_form` names the
side that bounds it.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import torch

from ..device import device_name, resolve_device

NORTH_STAR_MBPS = 1000.0
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
# special-function results per second: 16 per clock per SM (Hopper's
# SFU rate), 132 SMs, 1.98 GHz boost clock
H100_SFU_PER_S = 16 * 132 * 1.98e9
OPS_PER_EDGE_VISIT = 12
# The benchmark legs (bench.py:67-103 of the JAX package): the headline
# rate-1/2 leg, rate 3/4 on the same decoder, and the production leg with
# early termination and the learned schedule.
LEGS = {
    "headline": dict(code="dvbs2/64800/12",
                     decoder="layered/norm:0.8125/25/noet",
                     batch=4096, ebn0_db=1.5),
    "r34": dict(code="dvbs2/64800/34", decoder="layered/norm:0.8125/25/noet",
                batch=2048, ebn0_db=3.0),
    "prod": dict(code="dvbs2/64800/12",
                 decoder="layered/sched:dvbs2_64800_12_T25_op2",
                 batch=2048, ebn0_db=2.5),
}
# The exact-BP kernel's legs: the headline's code, batch and Eb/N0 with
# each exact rule, fixed 25 iterations.
EXACT_LEGS = {
    cn: dict(code="dvbs2/64800/12", decoder=f"layered/{cn}/25/noet",
             batch=4096, ebn0_db=1.5)
    for cn in ("spa", "minstar")
}
# The flooding legs: the JAX package's mackay1008 fallback leg
# (bench.py:69-70, at run_benchmark's default 2.5 dB) and each flooding
# kind on the headline's code, batch and Eb/N0, fixed 25 iterations.
FLOODING_LEGS = {
    "mackay": dict(code="mackay1008", decoder="minsum/norm:0.8125/25/noet",
                   batch=2048, ebn0_db=2.5),
    **{f"dvbs2_{kind}": dict(
        code="dvbs2/64800/12",
        decoder=("minsum/norm:0.8125" if kind == "minsum" else kind)
        + "/25/noet", batch=4096, ebn0_db=1.5)
       for kind in ("minsum", "spa", "minstar")},
}
# The CCSDS AR4JA legs (k = 4096, rate 1/2: a block-column repeated in
# every layer, so the layered decoders take the accumulate form): each
# layered rule, fixed 25 iterations, at 2.5 dB, the upper point of the
# stored JAX reference (FER ~0.03; PERF.md section 4).
CCSDS_LEGS = {
    cn: dict(code="ccsds/4096/12",
             decoder=("layered/norm:0.8125" if cn == "minsum"
                      else f"layered/{cn}") + "/25/noet",
             batch=4096, ebn0_db=2.5)
    for cn in ("minsum", "spa", "minstar")
}
# The message precisions (fixed 25 iterations): on the headline's code,
# batch and Eb/N0, min-sum and spa with the TPU kernel's bf16 storage
# (/pallas on dvbs2/64800/12) and on the q:6:0.25 grid; on the CCSDS legs'
# shape, min-sum and spa on the q:6:0.25 grid (the TPU kernel stored
# ccsds/4096/12 in f32, so /pallas is f32 there).
PRECISION_LEGS = {
    **{f"{cn}_{p}": dict(
        code="dvbs2/64800/12",
        decoder=("layered/norm:0.8125" if cn == "minsum" else f"layered/{cn}")
        + ("/25/noet/pallas" if p == "bf16" else "/q:6:0.25/25/noet"),
        batch=4096, ebn0_db=1.5)
       for cn in ("minsum", "spa") for p in ("bf16", "q6")},
    **{f"ccsds_{cn}_q6": dict(
        CCSDS_LEGS[cn], decoder=CCSDS_LEGS[cn]["decoder"].replace(
            "/25/noet", "/q:6:0.25/25/noet"))
       for cn in ("minsum", "spa")},
}
# The IEEE 802.3an legs (8023an: n = 2048, k = 1723, Z = 64 XOR-permutation
# blocks, 192 block-edges, row degree 32): the JAX package's family leg
# (bench/families.py:29), layered, and the same with flooding min-sum, the
# two modes of ecc_ldpc_tpu/decode/pallas/layered_xor.py (K4).
# The TPU kernels' roundings under `/pallas` (decode/api.py), each timed
# beside its f32 leg (the same spec without "/pallas") in one call: K3's
# bf16 storage on nr5g/bg1/384 (its f32 state past VMEM on the TPU), K2's
# bf16 matmul inputs on mackay1008, K4's bf16 permutations on 8023an,
# layered and flooding.
PALLAS_LEGS = {
    "nr5g_flooding": dict(code="nr5g/bg1/384",
                          decoder="minsum/norm:0.8125/25/noet/pallas",
                          batch=4096, ebn0_db=1.0),
    "mackay": dict(code="mackay1008",
                   decoder="minsum/norm:0.8125/25/noet/pallas",
                   batch=4096, ebn0_db=2.5),
    "8023an_layered": dict(code="8023an",
                           decoder="layered/norm:0.8125/25/noet/pallas",
                           batch=4096, ebn0_db=4.0),
    "8023an_flooding": dict(code="8023an",
                            decoder="minsum/norm:0.8125/25/noet/pallas",
                            batch=4096, ebn0_db=4.0),
}
XOR_LEGS = {
    "layered": dict(code="8023an", decoder="layered/norm:0.8125/25/noet",
                    batch=2048, ebn0_db=4.0),
    "flooding": dict(code="8023an", decoder="minsum/norm:0.8125/25/noet",
                     batch=2048, ebn0_db=4.0),
}
# The production retry decoder on 8023an at 3.6 dB, where the primary
# fails to converge on some frames (JAX CPU reference: FER ~0.08 with
# layered/norm:0.8125/25; PERF.md section 4).
XOR_PRODUCTION_SWEEP = dict(code="8023an",
                            decoder="layered/norm:0.8125/50;retry=layered/spa/50",
                            batch=4096, ebn0_db=3.6)
# The production sweep point: the floor program's retry decoder at the
# 1.5 dB operating point, in batches of 4096 frames.
PRODUCTION_SWEEP = dict(code="dvbs2/64800/12",
                        decoder="layered/norm:0.8125/50;retry=layered/spa/50",
                        batch=4096, ebn0_db=1.5)
# The same point with the floor program's first production decoder, whose
# fallback is flooding spa (the QC flooding kernel).
FLOODING_PRODUCTION_SWEEP = dict(
    PRODUCTION_SWEEP, decoder="layered/norm:0.8125/50;retry=spa/50")
# The production retry decoder on ccsds/4096/12 at 1.5 dB, where the
# primary fails to converge on some frames. From 2.0 dB up nearly every
# frame error of this surrogate lifting is undetected (the decoder
# converges to another codeword), so the fallback gets no frames there.
CCSDS_PRODUCTION_SWEEP = dict(PRODUCTION_SWEEP, code="ccsds/4096/12",
                              ebn0_db=1.5)
# The sharded sweep (sim/runner.run_sweep_sharded): the golden curve's
# decoder and two of its waterfall points at the headline's code and
# batch, 4096 frames a point per step for 2 steps, on each (batch x snr)
# mesh of ranks.
SHARDED_SWEEP = dict(code="dvbs2/64800/12", decoder="layered/norm:0.8125/25",
                     ebn0_db=(1.0, 1.1), batch=4096, steps=2)
SHARDED_MESHES = ("1x1", "2x1", "2x2")
# the sharded sweep over a modem channel (bench/sharded.py's "modem"):
# DVB-S2 16APSK at rate 5/6's ring ratio with the bit interleaver, at two
# points of its golden curve's waterfall
SHARDED_MODEM_SWEEP = dict(code="dvbs2/16200/12",
                           decoder="layered/norm:0.8125/25",
                           ebn0_db=(3.8, 4.0), batch=4096, steps=2,
                           channel="apsk16:r56:il")


@dataclasses.dataclass
class BenchResult:
    throughput_mbps: float
    code: str
    decoder: str
    batch: int
    iters: int
    k: int
    n: int
    num_edges: int
    wall_s_per_batch: float
    mean_iters: float
    roofline_mbps: float
    device: str
    roofline_form: str
    frame_errors: int            # frames with a wrong message bit
    codeword_frame_errors: int   # frames with any wrong code bit
    bound_ms: float
    tries_s: list                # seconds of each timed decode

    def json_line(self) -> str:
        return json.dumps(
            {
                "metric": "decoded_throughput",
                "value": self.throughput_mbps,
                "unit": "Mbit/s/chip",
                "vs_baseline": self.throughput_mbps / NORTH_STAR_MBPS,
                "code": self.code,
                "decoder": self.decoder,
                "batch": self.batch,
                "iters": self.iters,
                "k_bits_per_frame": self.k,
                "wall_s_per_batch": self.wall_s_per_batch,
                "roofline_mbps": self.roofline_mbps,
                "roofline_form": self.roofline_form,
                "device": self.device,
                "mean_iters": self.mean_iters,
                "frame_errors": self.frame_errors,
                "fer": self.frame_errors / self.batch,
                "codeword_frame_errors": self.codeword_frame_errors,
            }
        )


def decode_ops(num_edges: int, num_checks: int, cn: str = "minsum",
               schedule: str = "layered", accumulate: bool = False):
    """(transcendentals, arithmetic operations) of one iteration of one
    frame under check-node rule `cn`, for E edges and m checks (every
    check of degree >= 2).

    schedule="layered":
      minsum   0; 12 per edge visit (pass 1: subtract, abs, min, max, min,
               sign xor; pass 2: abs-compare, select, xor, and, or, add).
      spa      5 per edge visit (tanh and log in pass 1; exp and two log1p
               in pass 2, log|tanh| kept from pass 1); 14 arithmetic
               (pass 1: subtract, abs, max, min, halve, accumulate, sign
               xor; pass 2: subtract, clip, subtract, xor, and, or, add).
      minstar  3(d-2) box-plus per check of degree d (forward prefixes,
               backward suffix and the middle slots' combinations), each
               2 exp + 2 log1p and 16 arithmetic (two abs, min, two
               compares, xor, select, add, abs, negate, subtract, abs,
               negate, subtract, multiply, add); plus 4 per edge visit
               (subtract, clip low and high, add): 12(E - 2m) and
               48(E - 2m) + 4E.
    schedule="flooding" (decode/cn_ops.py's rules; csrc/flooding*.cu):
      the same check-node work, except that spa's magnitude is the
      oracle's 2*atanh(t), so 4 transcendentals per edge visit (tanh, log,
      exp, atanh), not 5; plus 2 arithmetic per edge visit: the VN
      accumulate (an add into the new posterior) and the recompute of the
      extrinsic total - C. So minsum 0 and 14E, spa 4E and 16E, minstar
      12(E - 2m) and 48(E - 2m) + 6E.
    accumulate=True (layered, on graphs that repeat a block-column in a
    layer; csrc/layered_classic.cu): the layered counts plus 2 arithmetic
    per edge visit, the message change Cnew - Cold and its add into the
    posterior. spa keeps 5 transcendentals (log|tanh| stays in registers
    from pass 1 to pass 2; the TPU kernel recomputes it, 7). So minsum 0
    and 14E, spa 5E and 16E, minstar 12(E - 2m) and 48(E - 2m) + 6E."""
    E, m = num_edges, num_checks
    if schedule not in ("layered", "flooding"):
        raise KeyError(f"schedule must be layered/flooding, got {schedule!r}")
    if accumulate and schedule != "layered":
        raise ValueError("the accumulate form is a layered schedule's")
    extra = 2 * E if schedule == "flooding" or accumulate else 0
    if cn == "minsum":
        return 0, OPS_PER_EDGE_VISIT * E + extra
    if cn == "spa":
        return (4 if schedule == "flooding" else 5) * E, 14 * E + extra
    if cn == "minstar":
        return 12 * (E - 2 * m), 48 * (E - 2 * m) + 4 * E + extra
    raise KeyError(f"cn must be minsum/spa/minstar, got {cn!r}")


def decode_bound(n: int, num_edges: int, batch: int, iteration_sum: int,
                 cn: str = "minsum", num_checks: int = 0,
                 schedule: str = "layered", accumulate: bool = False):
    """(seconds, "bytes" | "operations"): the least time an H100 could
    take to decode `batch` frames that ran `iteration_sum` iterations in
    all (batch * max_iters in fixed-iteration mode) with rule `cn` on
    `schedule` (layered: in the accumulate form if `accumulate`). The
    special-function units and the fp32 pipes run side by side, so the
    operations take the longer of the two, not their sum."""
    t_bytes = batch * n * (4 + 1) / H100_HBM_BYTES_PER_S
    trans, arith = decode_ops(num_edges, num_checks, cn, schedule,
                              accumulate)
    t_ops = iteration_sum * max(trans / H100_SFU_PER_S,
                                arith / H100_FP32_OPS_PER_S)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rule_of(kw: dict):
    """(cn, schedule) of a parsed decoder spec: a layered spec's check
    rule, or a flooding kind."""
    if kw["kind"] == "layered":
        return kw.get("cn", "minsum"), "layered"
    return kw["kind"], "flooding"


@functools.lru_cache(maxsize=None)
def _encoder(code: str):
    """The encoder of a registered code, built once per process: the
    dense generator of a CCSDS code takes seconds of host elimination."""
    from ..codes.registry import get_code
    from ..encode.structured import build_encoder

    return build_encoder(get_code(code))


@dataclasses.dataclass
class BenchInputs:
    spec: object
    graph: object
    decode: object
    kw: dict
    enc: object        # the encoder (its extract_message finds the message)
    msg: torch.Tensor  # uint8 [B, k] sent messages
    cw: torch.Tensor   # uint8 [B, n] transmitted codewords
    llr: torch.Tensor  # f32 [B, n] channel LLRs

    def frame_errors(self, bits: torch.Tensor):
        """(frames with a wrong message bit — the sweep runner's FER in
        the JAX package, against which the golden curves were measured —
        and frames with any wrong code bit). The message bits are where
        the encoder put them: a prefix for the structured encoders, the
        generator's info_cols for the dense one."""
        wrong_msg = self.enc.extract_message(bits) != self.msg
        return (int(wrong_msg.any(1).sum().item()),
                int((bits != self.cw).any(1).sum().item()))


def make_inputs(code: str, decoder: str, batch: int, ebn0_db: float,
                device="cuda", seed: int = 0,
                source: str = None) -> BenchInputs:
    """Code, graph, decoder, codewords and LLRs for one benchmark leg.
    `source`, when given, is a registered code with the same H whose
    encoder makes the codewords (a mat: or dense: load of a rank-deficient
    H counts k as n - m, not the true dimension)."""
    from ..chan.awgn import make_channel
    from ..codes.registry import get_code
    from ..decode.api import choose_graph, get_decoder, parse_decoder_spec

    dev = resolve_device(device)
    kw = parse_decoder_spec(decoder)
    # the spec's own backend picks the view, as --backend does in a sweep
    graph = choose_graph(get_code(code), decoder, backend=kw.get("backend"))
    dec = get_decoder(graph, decoder, device=dev)
    spec = get_code(source or code)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    msg = torch.randint(0, 2, (batch, spec.k), generator=gen, device=dev,
                        dtype=torch.uint8)
    enc = _encoder(source or code)
    cw = enc(msg)
    llr = make_channel(spec)(gen, cw, ebn0_db)
    return BenchInputs(spec=spec, graph=graph, decode=dec, kw=kw, enc=enc,
                       msg=msg, cw=cw, llr=llr)


def event_seconds(fn) -> float:
    """Seconds of one call of fn() on the current stream's clock: CUDA
    events recorded before and after it, the second waited on."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def run_benchmark(code: str = "dvbs2/64800/12",
                  decoder: str = "layered/norm:0.8125/25/noet",
                  batch: int = 4096, ebn0_db: float = 1.5, device="cuda",
                  tries: int = 5, seed: int = 0,
                  source: str = None, profile_dir: str = None) -> BenchResult:
    """Decoded Mbit/s on the card for one (code, decoder, batch, Eb/N0);
    `source` as make_inputs takes it. With `profile_dir` the timed decodes
    run under bench/profile.trace (a Chrome trace written there)."""
    from .profile import trace

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("run_benchmark times the card; it has no CPU mode")
    x = make_inputs(code, decoder, batch, ebn0_db, dev, seed, source)
    res = x.decode(x.llr)  # warm-up (and the build, on first use)
    torch.cuda.synchronize(dev)
    times = []
    with trace(profile_dir):
        for _ in range(tries):
            times.append(event_seconds(lambda: x.decode(x.llr)))
    wall = float(np.median(times))
    iteration_sum = int(res.iterations.sum().item())
    frame_errors, cw_errors = x.frame_errors(res.bits)
    cn, schedule = rule_of(x.kw)
    accumulate = schedule == "layered" and not x.graph.intra_layer_dup_free
    bound_s, form = decode_bound(x.spec.n, x.spec.num_edges, batch,
                                 iteration_sum, cn, x.spec.m, schedule,
                                 accumulate)
    return BenchResult(
        throughput_mbps=batch * x.spec.k / wall / 1e6,
        code=code,
        decoder=decoder,
        batch=batch,
        iters=x.kw.get("max_iters", 25),
        k=x.spec.k,
        n=x.spec.n,
        num_edges=x.spec.num_edges,
        wall_s_per_batch=wall,
        mean_iters=iteration_sum / batch,
        roofline_mbps=batch * x.spec.k / bound_s / 1e6,
        device=device_name(dev),
        roofline_form=form,
        frame_errors=frame_errors,
        codeword_frame_errors=cw_errors,
        bound_ms=bound_s * 1e3,
        tries_s=times,
    )
