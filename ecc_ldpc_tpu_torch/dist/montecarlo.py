"""The sharded Monte-Carlo step: batch and Eb/N0 sharding, counters summed
over the ranks (port of ecc_ldpc_tpu/dist/montecarlo.py).

Codewords are sharded over the mesh's 'batch' axis and Eb/N0 grid points
over its 'snr' axis; each rank writes its points' counters into a
zero-padded copy of the full grid and one ring all-reduce over every rank
(dist/ring.py, K5 on the card) leaves the same integers on every rank that
the reference's psum over 'batch' and all_gather over 'snr' give.

Noise. Every frame's message bits and noise depend only on (seed, grid
point, step, global frame index), as the reference's per_frame_keys makes
them (montecarlo.py:29), so the counters are identical on every mesh shape
with the same total batch: a one-card run validates a many-rank one. The
generator is Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011) written in plain tensor ops on uint32 values
held in int64 (each 32x32-bit product split at 16 bits, so no int64
overflows): key (seed mod 2^32, seed >> 32 mod 2^32), counter (block j,
global frame index mod 2^32, step, 2 x point + stream), stream 0 for the
message bits and 1 for the channel's draws, whatever the channel (a third
stream would collide: 2 x point + 2 is stream 0 of the next point). Block
j of a frame gives message bits 128 j .. 128 j + 127 (bit b of word t is
bit 128 j + 32 t + b), or normals 4 j .. 4 j + 3 (Box-Muller on words (0,
1) and (2, 3)), or uniforms 4 j .. 4 j + 3 (one a word); a uniform is
((word >> 8) + 1) / 2^24, 24 bits in (0, 1], so the log never sees 0. A
channel takes `count` normals or uniforms a frame (chan/modem.Channel).
Rows [a, b) of a batch are rows [a, b) of the whole batch drawn at once.
The numbers differ from the JAX package's threefry, so curves are compared
statistically. run_sweep's step-seeded torch.Generator stays as it is: as
in the JAX package, the unsharded and the sharded sweep key their noise
differently.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from .ring import ring_allreduce

_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
STREAM_MESSAGE, STREAM_NOISE = 0, 1
# the counters of one grid point, in this order, int64
COUNTERS = ("bit_errors", "frame_errors", "iters_sum", "bit_errors_sq")


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c for a 32-bit constant m and uint32
    values c in int64: m is split at 16 bits so no product exceeds 2^48."""
    a = c * (m & 0xFFFF)
    t = c * (m >> 16) + (a >> 16)  # (m * c) >> 16
    return t >> 16, ((t & 0xFFFF) << 16) | (a & 0xFFFF)


def philox4x32(c0, c1, c2, c3, key: tuple, rounds: int = 10) -> tuple:
    """Philox4x32-`rounds` of counters (c0, c1, c2, c3), int64 tensors of
    uint32 values (broadcastable), under key (k0, k1): four int64 tensors
    of uint32 values."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def frame_words(seed: int, point: int, step: int, stream: int,
                frames: torch.Tensor, blocks: int) -> torch.Tensor:
    """int64 [len(frames), blocks, 4] of uint32 values: Philox block j of
    each global frame index in `frames` (int64 [B], on the output's
    device)."""
    dev = frames.device
    c0 = torch.arange(blocks, dtype=torch.int64, device=dev)[None, :]
    c1 = (frames.to(torch.int64) & _MASK)[:, None]
    c2, c3 = (torch.tensor(v & _MASK, dtype=torch.int64, device=dev)
              for v in (step, 2 * point + stream))
    words = philox4x32(c0, c1, c2, c3, (seed, seed >> 32))
    return torch.stack(torch.broadcast_tensors(*words), dim=-1)


def frame_bits(seed: int, point: int, step: int, frames: torch.Tensor,
               k: int) -> torch.Tensor:
    """uint8 [B, k] fair message bits of the frames in `frames`."""
    words = frame_words(seed, point, step, STREAM_MESSAGE, frames,
                        -(-k // 128))
    shifts = torch.arange(32, dtype=torch.int64, device=frames.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(len(frames), -1)[:, :k].to(torch.uint8)


def _unit(words: torch.Tensor) -> torch.Tensor:
    """f32 uniforms ((word >> 8) + 1) / 2^24 in (0, 1]."""
    return ((words >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))


def frame_uniforms(seed: int, point: int, step: int, frames: torch.Tensor,
                   n: int) -> torch.Tensor:
    """f32 [B, n] uniforms in (0, 1] of the frames in `frames`, one a word
    of the channel's stream."""
    words = frame_words(seed, point, step, STREAM_NOISE, frames, -(-n // 4))
    return _unit(words).reshape(len(frames), -1)[:, :n].contiguous()


def frame_normals(seed: int, point: int, step: int, frames: torch.Tensor,
                  n: int) -> torch.Tensor:
    """f32 [B, n] standard normals of the frames in `frames`."""
    words = frame_words(seed, point, step, STREAM_NOISE, frames, -(-n // 4))
    u = _unit(words)
    r = torch.sqrt(-2.0 * torch.log(u[..., 0::2]))
    theta = (2.0 * math.pi) * u[..., 1::2]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    # (r0 cos, r0 sin, r1 cos, r1 sin) per block
    return z.reshape(len(frames), -1)[:, :n].contiguous()


def point_counters(pipeline, seed: int, point: int, step: int,
                   frame_start: int, batch: int,
                   ebn0_db: float) -> torch.Tensor:
    """int64 [4] counters (COUNTERS) of `batch` frames of one grid point,
    frames frame_start .. frame_start + batch - 1, through `pipeline` (a
    sim.runner.Pipeline, on its device): their per-frame message bits and
    channel draws (the pipeline's channel's kind and count), encode, the
    channel, decode, tally."""
    frames = frame_start + torch.arange(batch, dtype=torch.int64,
                                        device=pipeline.device)
    ch = pipeline.channel
    draw = frame_normals if ch.draws == "normals" else frame_uniforms
    return pipeline.counts(frame_bits(seed, point, step, frames, pipeline.k),
                           draw(seed, point, step, frames, ch.count), ebn0_db)


def make_sharded_step(pipeline, mesh, batch_per_rank: int,
                      ring=None) -> Callable:
    """step(seed, ebn0_grid, step_index) -> int64 [n_points, 4] counters
    (COUNTERS), the same on every rank: this rank's points and frames
    through `pipeline` (a sim.runner.Pipeline on mesh.device), then the sum
    over the mesh's ranks through `ring` (a dist.ring.Ring; None for a
    single process). step.local(...) is this rank's zero-padded part
    before the sum.

    ebn0_grid: the Eb/N0 points, dividing evenly over mesh.snr. Per call
    every grid point sees batch_per_rank * mesh.batch frames; this rank's
    are frame_start = step_index * total_batch + batch_shard *
    batch_per_rank onward (montecarlo.py:140-142)."""
    if ring is None and mesh.group is not None:
        raise ValueError("a mesh of several processes sums its counters "
                         "through a Ring")
    if pipeline.device != mesh.device:
        raise ValueError(f"the pipeline runs on {pipeline.device}, the mesh "
                         f"on {mesh.device}")
    total_batch = batch_per_rank * mesh.batch

    def local(seed: int, ebn0_grid, step_index: int) -> torch.Tensor:
        n_points = len(ebn0_grid)
        if n_points % mesh.snr:
            raise ValueError(f"{n_points} grid points do not divide over "
                             f"snr={mesh.snr}")
        s_local = n_points // mesh.snr
        out = torch.zeros((n_points, len(COUNTERS)), dtype=torch.int64,
                          device=mesh.device)
        frame_start = step_index * total_batch + mesh.batch_shard * batch_per_rank
        for p in range(s_local):
            point = mesh.snr_shard * s_local + p
            out[point] = point_counters(
                pipeline, seed, point, step_index, frame_start,
                batch_per_rank, float(ebn0_grid[point]))
        return out

    def step(seed: int, ebn0_grid, step_index: int) -> torch.Tensor:
        x = local(seed, ebn0_grid, step_index)
        return x if ring is None else ring_allreduce(x, ring)

    step.local = local
    return step


def sharded_sweep_counters(pipeline, mesh, batch_per_rank, ebn0_grid, *,
                           seed=0, steps=1):
    """Run `steps` sharded steps of a single-process mesh and accumulate the
    counters (helper for tests and quick sweeps; the sweep with the
    stopping rule is sim/runner.run_sweep_sharded). Returns (int64
    [n_points, 4] counters, frames per point)."""
    step = make_sharded_step(pipeline, mesh, batch_per_rank)
    acc = sum(step(seed, ebn0_grid, s) for s in range(steps))
    return acc, steps * batch_per_rank * mesh.batch
