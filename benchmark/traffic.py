"""The one traffic generator: reads a mix's parameters (benchmark/traffic/
<mix>.json) and makes its inputs on the device from the run's seed.

A mix's keys:
  kind      the file benchmark/kind_<kind>.py that builds the system under
            test and runs the window: "decode", the decoder alone, fed
            channel LLRs; "sweep", the Monte-Carlo sweep step (message ->
            encode -> channel -> decode -> tally), fed message bits and
            the channel's normals
  decoder   the decoder spec (the port's decode/api grammar)
  reference the decoder reference benchmark/reference/<reference>.py that
            the answers are held to (reference/__init__.py)
  batch     frames in one request (a decode call or a sweep step)
  pool      distinct batches made at set-up, sent in turn
  compare   batches of the pool whose answers are compared with the
            reference after the window (drawn from the seed)
  ebn0_db   the operating point; when absent the configuration's own

Requests go in a closed loop from one caller: each waits for its answer.

Every input comes from one torch.Generator on the device, seeded from
`--seed`: the message bits of every batch (uint8 [batch, k]), then its
normals (f32 [batch, n]). A decode mix encodes and transmits them with the
configuration's code reference, so the decoder's inputs are the
benchmark's, not the program's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import random

import torch


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    kind: str
    decoder: str
    reference: str
    batch: int
    pool: int
    compare: int
    ebn0_db: float


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run's seed (any integer)."""
    digest = hashlib.blake2b(f"{seed}:{purpose}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def load(path, name: str, config: dict, **overrides) -> Mix:
    """The mix in `path`, its operating point defaulting to the
    configuration's; `overrides` replace parameters (the CPU tests' small
    sizes)."""
    with open(path) as f:
        t = json.load(f)
    t.update(overrides)
    if not 1 <= t["compare"] <= t["pool"]:
        raise ValueError(f"{name}: compare must lie in [1, pool]")
    return Mix(name=name, kind=t["kind"], decoder=t["decoder"],
               reference=t["reference"],
               batch=int(t["batch"]), pool=int(t["pool"]),
               compare=int(t["compare"]),
               ebn0_db=float(t.get("ebn0_db", config["ebn0_db"])))


def make_pool(mix: Mix, k: int, n: int, seed: int, device):
    """The pool's batches in turn, (message bits uint8 [batch, k], normals
    f32 [batch, n]), made one at a time, so that a caller that keeps only
    what it derives from a batch holds one batch's draws at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "pool"))
    for _ in range(mix.pool):
        msg = torch.randint(0, 2, (mix.batch, k), generator=gen,
                            device=device, dtype=torch.uint8)
        noise = torch.randn((mix.batch, n), generator=gen, device=device,
                            dtype=torch.float32)
        yield msg, noise


def compared(mix: Mix, seed: int) -> dict:
    """{pool index: request index}: the batches whose answers are compared,
    and for each the request whose outputs are kept, one of its first two
    turns in the window."""
    rng = random.Random(sub_seed(seed, "compare"))
    picks = sorted(rng.sample(range(mix.pool), mix.compare))
    return {p: p + mix.pool * rng.randrange(2) for p in picks}
