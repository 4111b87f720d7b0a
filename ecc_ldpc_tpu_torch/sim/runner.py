"""Monte-Carlo sweep loop (port of ecc_ldpc_tpu/sim/runner.py:35-335,
446-457).

For each (code, decoder, Eb/N0) grid point, run batches of frames until the
stopping rule fires, tallying message-bit errors and frame errors. One
step runs on the device: random message -> encode -> channel -> decode ->
tally; only four scalars per step come back to the host.

Noise: every step draws its message and its noise from a fresh
torch.Generator on the step's device, seeded with
step_seed(seed, host_index, point index, step index). That stands in for
the JAX package's fold_in(fold_in(fold_in(key(seed), host), point), step)
chain: streams differ across grid points, steps and hosts, and a resumed
sweep continues the stream exactly where it stopped. The numbers differ
from JAX's threefry, so curves are compared statistically
(report.curves_overlap), not bit for bit.

Resume states and result files keep the JAX package's keys and fields, so
either package can read the other's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import time
from typing import Callable, Optional

import torch

from ..chan.modem import build_channel
from ..codes.registry import get_code
from ..decode.api import choose_graph, get_decoder
from ..device import resolve_device
from .stopping import StoppingRule, wilson_interval

# the counters a resume state keeps per grid point
_STATE_FIELDS = ("frames", "bit_errors", "frame_errors", "iters_sum",
                 "steps", "wall_s", "bit_errors_sq")


def step_seed(seed: int, host_index: int, point: int, step: int) -> int:
    """Seed of one sweep step's torch.Generator: BLAKE2b (8-byte digest)
    of the four integers packed as little-endian int64, read as a
    little-endian integer and shifted right by one (a 63-bit seed). A pure
    function, so a resumed sweep regenerates the same step streams."""
    digest = hashlib.blake2b(struct.pack("<4q", seed, host_index, point, step),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweep = a grid of (code x decoder x Eb/N0)."""

    code: str
    decoder: str
    ebn0_db: tuple
    batch: int = 256
    seed: int = 0
    stopping: StoppingRule = StoppingRule()
    channel: str = "bpsk"  # channel-spec string (chan/modem.py)

    def point_key(self, ebn0: float) -> str:
        base = f"{self.code}|{self.decoder}|{ebn0:g}"
        # default channel keeps the legacy key so old resume states load
        return base if self.channel == "bpsk" else f"{base}|{self.channel}"


@dataclasses.dataclass
class PointResult:
    code: str
    decoder: str
    ebn0_db: float
    channel: str = "bpsk"  # channel-spec string the point was measured over
    frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    iters_sum: int = 0
    steps: int = 0
    message_bits_per_frame: int = 0
    wall_s: float = 0.0
    # sum over frames of (per-frame bit errors)^2, as a float (an int32
    # overflows at ~2 heavy frames of a 32k-bit code); see ber_ci
    bit_errors_sq: float = 0.0

    @property
    def ber(self) -> float:
        bits = self.frames * self.message_bits_per_frame
        return self.bit_errors / bits if bits else 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / self.frames if self.frames else 0.0

    @property
    def fer_ci(self):
        return wilson_interval(self.frame_errors, self.frames)

    @property
    def ber_ci(self):
        """Cluster-corrected Wilson interval on BER.

        Bit errors arrive in bursts inside errored frames, so they are not
        independent trials. The effective trial count is total_bits / D for
        the design effect D = sum(w^2)/sum(w) over per-frame error weights
        w (bit_errors_sq / bit_errors), with x_eff = sum(w)^2/sum(w^2)
        effective error events, which keeps the point estimate at ber.
        Points recorded without bit_errors_sq fall back to D = the mean
        burst size (bit_errors / frame_errors)."""
        bits = self.frames * self.message_bits_per_frame
        if not bits:
            return (0.0, 1.0)
        if self.bit_errors == 0 or self.frame_errors == 0:
            return wilson_interval(self.bit_errors, bits)
        if self.bit_errors_sq > 0:
            design = self.bit_errors_sq / self.bit_errors
            x_eff = self.bit_errors**2 / self.bit_errors_sq
        else:
            design = self.bit_errors / self.frame_errors
            x_eff = self.frame_errors
        return wilson_interval(x_eff, max(round(bits / design), 1))

    @property
    def mean_iters(self) -> float:
        return self.iters_sum / self.frames if self.frames else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(ber=self.ber, fer=self.fer, mean_iters=self.mean_iters,
                 ber_ci=self.ber_ci, fer_ci=self.fer_ci)
        return d

    @staticmethod
    def from_json(d: dict) -> "PointResult":
        fields = {f.name for f in dataclasses.fields(PointResult)}
        return PointResult(**{k: v for k, v in d.items() if k in fields})


def tally(msg: torch.Tensor, msg_hat: torch.Tensor, iterations: torch.Tensor):
    """(bit_errors, frame_errors, iters_sum, bit_errors_sq) of one batch as
    Python numbers, from one device-to-host copy. A frame error is a wrong
    message bit; bit_errors_sq sums the squared per-frame error counts in
    f32, as the JAX package does."""
    diff = msg_hat != msg
    w = diff.sum(1, dtype=torch.int32)
    vals = torch.stack([
        w.sum(dtype=torch.int64).double(),
        diff.any(1).sum().double(),
        iterations.sum(dtype=torch.int64).double(),
        w.float().square().sum().double(),
    ]).tolist()
    return int(vals[0]), int(vals[1]), int(vals[2]), vals[3]


class Pipeline:
    """message -> encode -> channel -> decode -> tally for one (code,
    decoder) pair on one device.

    frames(gen, ebn0_db) -> (message, channel LLRs) of one batch, and
    step(gen, ebn0_db) -> (bit_errors, frame_errors, iters_sum,
    bit_errors_sq) of the same batch decoded, both drawing the message and
    the noise from `gen`."""

    def __init__(self, k: int, rate: float, frames_fn: Callable,
                 step_fn: Callable, batch: int, device: torch.device):
        self.k = k
        self.rate = rate
        self.frames = frames_fn
        self.step = step_fn
        self.batch = batch
        self.device = device

    @staticmethod
    def build(spec: SweepSpec, device) -> "Pipeline":
        if spec.code.startswith("bpsk"):
            return _bpsk_pipeline(spec, device)
        return _ldpc_pipeline(spec, device)


def _ldpc_pipeline(spec: SweepSpec, dev: torch.device) -> Pipeline:
    from ..encode.structured import build_encoder

    code = get_code(spec.code)
    graph = choose_graph(code, spec.decoder)
    enc = build_encoder(code)
    dec = get_decoder(graph, spec.decoder, device=dev)
    channel = build_channel(code, spec.channel)
    B, k = spec.batch, code.k

    def frames(gen, ebn0_db):
        msg = torch.randint(0, 2, (B, k), generator=gen, device=dev,
                            dtype=torch.uint8)
        return msg, channel(gen, enc(msg), ebn0_db)

    def step(gen, ebn0_db):
        msg, llr = frames(gen, ebn0_db)
        res = dec(llr)
        return tally(msg, enc.extract_message(res.bits), res.iterations)

    return Pipeline(k=k, rate=code.rate, frames_fn=frames, step_fn=step,
                    batch=B, device=dev)


def _bpsk_pipeline(spec: SweepSpec, dev: torch.device) -> Pipeline:
    """Uncoded baseline. Code string: "bpsk" or "bpsk/<n>"; rate 1,
    decode = hard decision."""
    from ..codes.spec import CodeSpec

    parts = spec.code.split("/")
    n = int(parts[1]) if len(parts) > 1 else 1024
    B = spec.batch
    # rate-1 "code" with an empty parity set, to carry (n, rate=1) through
    # build_channel
    identity = CodeSpec(name="uncoded", n=n, m=0, row_cols=(), k=n)
    channel = build_channel(identity, spec.channel)

    def frames(gen, ebn0_db):
        msg = torch.randint(0, 2, (B, n), generator=gen, device=dev,
                            dtype=torch.uint8)
        return msg, channel(gen, msg, ebn0_db)

    def step(gen, ebn0_db):
        msg, llr = frames(gen, ebn0_db)
        hard = (llr < 0).to(torch.uint8)
        return tally(msg, hard, torch.zeros(B, dtype=torch.int32, device=dev))

    return Pipeline(k=n, rate=1.0, frames_fn=frames, step_fn=step, batch=B,
                    device=dev)


def run_sweep(
    spec: SweepSpec,
    *,
    device="cuda",
    resume_path: Optional[str] = None,
    progress: Optional[Callable[[PointResult], None]] = None,
    host_index: int = 0,
) -> list:
    """Run every grid point to its stopping rule on `device` (default
    "cuda"; "cpu" runs the plain PyTorch path). Returns [PointResult].

    If resume_path is given, counters are flushed there after every step
    and reloaded on restart; the step index continues the noise stream."""
    dev = resolve_device(device)
    pipeline = Pipeline.build(spec, dev)
    state = _load_state(resume_path)
    results = []
    for pi, ebn0 in enumerate(spec.ebn0_db):
        pr = PointResult(
            code=spec.code, decoder=spec.decoder, ebn0_db=float(ebn0),
            channel=spec.channel, message_bits_per_frame=pipeline.k,
        )
        saved = state.get(spec.point_key(ebn0))
        if saved:
            for f in _STATE_FIELDS:
                # .get: resume states written before bit_errors_sq existed
                setattr(pr, f, saved.get(f, getattr(pr, f)))
        while not spec.stopping.done(pr.frame_errors, pr.frames):
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev)
            gen.manual_seed(step_seed(spec.seed, host_index, pi, pr.steps))
            be, fe, it, be2 = pipeline.step(gen, float(ebn0))
            pr.wall_s += time.perf_counter() - t0
            pr.frames += pipeline.batch
            pr.bit_errors += be
            pr.frame_errors += fe
            pr.iters_sum += it
            pr.bit_errors_sq += be2
            pr.steps += 1
            if resume_path:
                state[spec.point_key(ebn0)] = {
                    f: getattr(pr, f) for f in _STATE_FIELDS}
                _save_state(resume_path, state)
        if progress:
            progress(pr)
        results.append(pr)
    return results


def _load_state(path) -> dict:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_state(path, state) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
