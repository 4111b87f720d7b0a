"""Monte-Carlo sweep loops (port of ecc_ldpc_tpu/sim/runner.py:35-457).

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

The sharded sweep (run_sweep_sharded) draws its noise per frame instead
(dist/montecarlo.py), so that its counters do not depend on the mesh.

Resume states and result files keep the JAX package's keys and fields, so
either package can read the other's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import struct
import time
from typing import Callable, Optional

import torch

from .. import trace
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
    # decoder backend override (decode/api.make_decoder): "pallas" rounds
    # as the TPU's kernels did, "xla-mm" decodes the expanded graph; both
    # pick the graph view too (choose_graph); None keeps the spec's own
    backend: Optional[str] = None
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


def tally_counts(msg: torch.Tensor, msg_hat: torch.Tensor,
                 iterations: torch.Tensor) -> torch.Tensor:
    """int64 [4] (bit_errors, frame_errors, iters_sum, bit_errors_sq) of one
    batch, on its device. A frame error is a wrong message bit. The squared
    per-frame bit errors are summed exactly in int64 (the JAX package sums
    them in f32): a sum over ranks is then the same whatever the mesh."""
    diff = msg_hat != msg
    w = diff.sum(1, dtype=torch.int64)
    return torch.stack([w.sum(), diff.any(1).sum(dtype=torch.int64),
                        iterations.sum(dtype=torch.int64), (w * w).sum()])


def tally(msg: torch.Tensor, msg_hat: torch.Tensor, iterations: torch.Tensor):
    """tally_counts as Python numbers, from one device-to-host copy
    (bit_errors_sq a float, as PointResult keeps it)."""
    be, fe, it, be2 = tally_counts(msg, msg_hat, iterations).tolist()
    return be, fe, it, float(be2)


class Pipeline:
    """message -> encode -> channel -> decode -> tally for one (code,
    decoder) pair on one device.

    The message bits and the channel's draws (chan/modem.Channel: its
    `draws`, normals or uniforms, and their `count` a frame) are the
    caller's: counts(msg, noise, ebn0_db) -> int64 [4] (tally_counts)
    decodes them, as the sharded sweep does with its per-frame draws
    (dist/montecarlo.py). run_sweep draws them from a torch.Generator:
    frames(gen, ebn0_db) -> (message, channel LLRs) of one batch, and
    step(gen, ebn0_db) -> tally of the same batch decoded."""

    def __init__(self, k: int, n: int, rate: float, encode: Callable,
                 channel: Callable, decode: Callable, batch: int,
                 device: torch.device):
        self.k = k
        self.n = n
        self.rate = rate
        self.encode = encode  # msg -> codeword bits
        self.channel = channel  # a chan/modem.Channel (build_channel)
        self.decode = decode  # llr -> (message estimate, iterations)
        self.batch = batch
        self.device = device

    def draw(self, gen: torch.Generator) -> tuple:
        """(message bits uint8 [batch, k], the channel's draws f32 [batch,
        count]) from gen, in that order (for bpsk: n unit normals, the same
        two calls as before the channel layer)."""
        msg = torch.randint(0, 2, (self.batch, self.k), generator=gen,
                            device=self.device, dtype=torch.uint8)
        return msg, self.channel.draw(gen, self.batch, self.device)

    def llr(self, msg, noise, ebn0_db) -> torch.Tensor:
        with trace.span("encode"):
            cw = self.encode(msg)
        with trace.span("channel"):
            return self.channel(None, cw, ebn0_db, noise)

    def counts(self, msg, noise, ebn0_db) -> torch.Tensor:
        msg_hat, iterations = self.decode(self.llr(msg, noise, ebn0_db))
        with trace.span("tally"):
            return tally_counts(msg, msg_hat, iterations)

    def frames(self, gen, ebn0_db) -> tuple:
        msg, noise = self.draw(gen)
        return msg, self.llr(msg, noise, ebn0_db)

    def step(self, gen, ebn0_db) -> tuple:
        be, fe, it, be2 = self.counts(*self.draw(gen), ebn0_db).tolist()
        return be, fe, it, float(be2)

    @staticmethod
    def build(spec: SweepSpec, device) -> "Pipeline":
        if spec.code.startswith("bpsk"):
            return _bpsk_pipeline(spec, device)
        return _ldpc_pipeline(spec, device)


def _ldpc_pipeline(spec: SweepSpec, dev: torch.device) -> Pipeline:
    from ..encode.structured import build_encoder

    code = get_code(spec.code)
    channel = build_channel(code, spec.channel)
    graph = choose_graph(code, spec.decoder, backend=spec.backend)
    enc = build_encoder(code)
    overrides = {"backend": spec.backend} if spec.backend else {}
    dec = get_decoder(graph, spec.decoder, device=dev, **overrides)

    def decode(llr):
        res = dec(llr)
        return enc.extract_message(res.bits), res.iterations

    return Pipeline(k=code.k, n=code.n, rate=code.rate, encode=enc,
                    channel=channel, decode=decode, batch=spec.batch,
                    device=dev)


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

    def decode(llr):
        return ((llr < 0).to(torch.uint8),
                torch.zeros(llr.shape[0], dtype=torch.int32, device=dev))

    return Pipeline(k=n, n=n, rate=1.0, encode=lambda msg: msg,
                    channel=channel, decode=decode, batch=B, device=dev)


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


@contextlib.contextmanager
def sharded_step(spec: SweepSpec, mesh):
    """The step of the sharded sweep on this rank, within its Ring: yields
    (pipeline, step), step(seed, ebn0_grid, step_index) -> int64 [n_points,
    4] counters, the same on every rank (dist.montecarlo.make_sharded_step).
    The reference's checks come first (runner.py:362-376): a ';retry='
    decoder, a grid or batch that does not divide over the mesh raise
    ValueError; every channel build_channel builds runs (its per-frame
    draws: dist/montecarlo.py), and an uncoded bpsk/N code too. On a card
    with several ranks, each node's leader builds the kernels before the
    others load them, so that one nvcc runs per source and node, not one
    per rank (dist.mesh.build_per_node)."""
    from ..dist.mesh import build_per_node
    from ..dist.montecarlo import COUNTERS, make_sharded_step
    from ..dist.ring import Ring

    if ";retry=" in spec.decoder:
        raise ValueError(
            "';retry=' decoders are host-level and cannot run inside the "
            "sharded step — sweep with the primary, re-decode failures "
            "with run_sweep (its step supports retry), or offline"
        )
    if len(spec.ebn0_db) % mesh.snr:
        raise ValueError(
            f"{len(spec.ebn0_db)} grid points do not divide over "
            f"snr={mesh.snr}")
    if spec.batch % mesh.batch:
        raise ValueError(f"batch {spec.batch} does not divide over "
                         f"{mesh.batch}")
    if mesh.device.type == "cuda" and mesh.group is not None:
        build_per_node(mesh.group)
    pipeline = Pipeline.build(spec, mesh.device)
    nbytes = len(spec.ebn0_db) * len(COUNTERS) * 8
    with Ring(mesh.group, mesh.device, nbytes) as ring:
        yield pipeline, make_sharded_step(pipeline, mesh,
                                          spec.batch // mesh.batch, ring=ring)


def run_sweep_sharded(
    spec: SweepSpec,
    mesh,
    *,
    resume_path: Optional[str] = None,
    progress: Optional[Callable[[PointResult], None]] = None,
) -> list:
    """The sharded sweep (port of ecc_ldpc_tpu/sim/runner.py:338-443): the
    whole Eb/N0 grid advances together, codewords sharded over the mesh's
    'batch' axis and grid points over its 'snr' axis (dist.Mesh, one per
    rank), the counters summed over the ranks by the ring all-reduce (K5
    on the card). Running "finished" points costs nothing extra (their
    ranks would otherwise idle), so the loop continues until EVERY point
    satisfies the stopping rule. Every rank returns the same results;
    rank 0 writes the resume state.

    Every frame's noise depends only on (seed, point, step, global frame
    index) (dist/montecarlo.py), so the counters are identical on every
    mesh shape with the same total batch."""
    state = [_load_state(resume_path) if mesh.rank == 0 else None]
    if mesh.group is not None:
        torch.distributed.broadcast_object_list(state, src=0, group=mesh.group)
    state = state[0]
    with sharded_step(spec, mesh) as (pipeline, step):
        results = [
            PointResult(code=spec.code, decoder=spec.decoder,
                        ebn0_db=float(e), channel=spec.channel,
                        message_bits_per_frame=pipeline.k)
            for e in spec.ebn0_db
        ]
        for pr, e in zip(results, spec.ebn0_db):
            saved = state.get(spec.point_key(e))
            if saved:
                for f in _STATE_FIELDS:
                    setattr(pr, f, saved.get(f, getattr(pr, f)))
        step_idx = min(pr.steps for pr in results)
        while not all(
            spec.stopping.done(pr.frame_errors, pr.frames) for pr in results
        ):
            t0 = time.perf_counter()
            counters = step(spec.seed, spec.ebn0_db, step_idx).tolist()
            dt = time.perf_counter() - t0
            for pr, (be, fe, it, be2) in zip(results, counters):
                if pr.steps > step_idx:  # already counted (resume overlap)
                    continue
                pr.frames += spec.batch
                pr.bit_errors += be
                pr.frame_errors += fe
                pr.iters_sum += it
                pr.bit_errors_sq += float(be2)
                pr.steps += 1
                # every point advances concurrently on its own ranks, so the
                # wall time THIS point experienced is the full step dt
                pr.wall_s += dt
            step_idx += 1
            if resume_path and mesh.rank == 0:
                for pr, e in zip(results, spec.ebn0_db):
                    state[spec.point_key(e)] = {
                        f: getattr(pr, f) for f in _STATE_FIELDS}
                _save_state(resume_path, state)
    if progress:
        for pr in results:
            progress(pr)
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
