"""Trapping-set microscopy: harvest and classify decoder failures (port of
ecc_ldpc_tpu/sim/microscope.py).

Error floors of min-sum/BP decoders are dominated by small (a, b) trapping
sets: a variable nodes whose induced subgraph leaves b checks unsatisfied
(odd-degree). Decode batches at an operating SNR with the production
decoder (on the card, through the ECC facade), keep the failed frames, and
classify each failure's error support on the host:

  a            |{v : bits[v] != tx[v]}|
  b            # checks with an odd number of erroneous neighbors
               (== the failing syndrome weight)
  elementary   every check touching the support has induced degree 1 or 2
  detected     decoder reported ok=False (b>0 <=> detected by syndrome)

QC codes get circulant canonicalization: rotating every member's
intra-block index by the same t maps trapping sets to automorphic copies,
so harvested sets are deduplicated by the lexicographically minimal
rotation; counts then measure the DISTINCT structures, not Z copies of
each.

Usage:
    from ecc_ldpc_tpu_torch.sim.microscope import harvest
    rep = harvest("dvbs2/16200/12", "layered/norm:0.8125/25",
                  ebn0_db=1.8, frames=1 << 16)
    print(rep.summary())

CLI: `python -m ecc_ldpc_tpu_torch.cli trap --code ... --decoder ...
--ebn0 ... --frames ...`.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from ..codes.spec import CodeSpec


@dataclasses.dataclass(frozen=True)
class Failure:
    """One classified decoding failure."""

    a: int
    b: int
    elementary: bool
    detected: bool
    vn_set: tuple  # erroneous codeword positions
    unsat_checks: tuple

    @property
    def ab(self) -> tuple:
        return (self.a, self.b)


@dataclasses.dataclass
class TrapReport:
    code: str
    decoder: str
    ebn0_db: float
    frames: int
    failures: list  # [Failure]
    # canonical-set -> count (QC rotation classes merged)
    set_counts: Counter
    histogram: Counter  # (a, b) -> count

    @property
    def fer(self) -> float:
        return len(self.failures) / max(self.frames, 1)

    def dominant(self, top: int = 10):
        """Most frequent distinct structures: [(canonical_set, count)]."""
        return self.set_counts.most_common(top)

    def summary(self) -> str:
        lines = [
            f"{self.code} | {self.decoder} @ {self.ebn0_db} dB: "
            f"{len(self.failures)} failures / {self.frames} frames "
            f"(FER {self.fer:.3e}), {len(self.set_counts)} distinct "
            f"structures",
            " (a,b)  count  elementary%",
        ]
        elem = Counter()
        for f in self.failures:
            if f.elementary:
                elem[f.ab] += 1
        for ab, cnt in sorted(self.histogram.items(),
                              key=lambda kv: -kv[1])[:12]:
            pct = 100.0 * elem[ab] / cnt
            lines.append(f" {str(ab):7s} {cnt:5d}  {pct:5.1f}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "code": self.code,
            "decoder": self.decoder,
            "ebn0_db": self.ebn0_db,
            "frames": self.frames,
            "n_failures": len(self.failures),
            "fer": self.fer,
            "histogram": {f"{a},{b}": c
                          for (a, b), c in sorted(self.histogram.items())},
            "dominant_sets": [
                {"vns": list(map(int, s)), "count": int(c)}
                for s, c in self.dominant(20)
            ],
        }


def _col_rows(spec: CodeSpec):
    """column -> list of check rows (host adjacency, built once)."""
    adj = [[] for _ in range(spec.n)]
    for i, cols in enumerate(spec.row_cols):
        for c in cols:
            adj[int(c)].append(i)
    return adj


def classify_failure(spec: CodeSpec, tx_bits, rx_bits,
                     detected: bool = True,
                     col_rows: Optional[list] = None) -> Failure:
    """Classify one failed frame's error support as an (a, b) set."""
    tx = np.asarray(tx_bits).ravel()
    rx = np.asarray(rx_bits).ravel()
    err = np.flatnonzero(tx != rx)
    adj = col_rows if col_rows is not None else _col_rows(spec)
    deg = Counter()
    for v in err:
        for r in adj[int(v)]:
            deg[r] += 1
    unsat = tuple(sorted(r for r, d in deg.items() if d % 2))
    elementary = all(d <= 2 for d in deg.values()) and len(err) > 0
    return Failure(a=int(len(err)), b=len(unsat), elementary=bool(elementary),
                   detected=bool(detected), vn_set=tuple(map(int, err)),
                   unsat_checks=unsat)


def canonical_set(spec: CodeSpec, vn_set: Sequence[int]) -> tuple:
    """QC-rotation-canonical form of a variable set (identity off-QC).

    Expanded column v = block*Z + z; the circulant automorphism maps
    z -> (z + t) % Z simultaneously in every block. Returns the
    lexicographically smallest sorted tuple over all t."""
    qc = getattr(spec, "qc", None)
    vs = tuple(sorted(int(v) for v in vn_set))
    if qc is None or not vs:
        return vs
    Z = qc.Z
    best = vs
    blocks = [v // Z for v in vs]
    zs = [v % Z for v in vs]
    for t in range(1, Z):
        cand = tuple(sorted(b * Z + (z + t) % Z for b, z in zip(blocks, zs)))
        if cand < best:
            best = cand
    return best


def harvest_batch(ecc, seed: int, step: int, batch: int, ebn0_db: float,
                  device) -> tuple:
    """(codewords uint8 [batch, n], channel LLRs f32 [batch, n]) of
    harvest's step `step`, drawn from a torch.Generator seeded with
    runner.step_seed(seed, 0, 0, step): the message bits, then the
    channel's draws, in run_sweep's order, so a harvest batch holds the
    frames of run_sweep's step at its first grid point (same seed, batch
    and channel)."""
    from .runner import step_seed

    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, 0, 0, step))
    msg = torch.randint(0, 2, (batch, ecc.k), generator=gen, device=device,
                        dtype=torch.uint8)
    cw = ecc.encode(msg)
    return cw, ecc.transmit(gen, cw, ebn0_db)


def harvest(code: str, decoder: str, *, ebn0_db: float,
            frames: int = 1 << 14, batch: int = 1024, seed: int = 7,
            channel: str = "bpsk", backend: Optional[str] = None,
            max_stored: int = 4096, device="cuda") -> TrapReport:
    """Decode `frames` frames at ebn0_db on `device` (default the card;
    "cpu" the plain path) and classify every failure.

    Runs through the ECC facade, so the production decode path is what
    gets microscoped. Only the failed frames' bits and codewords come to
    the host, where they are classified; `max_stored` caps the
    per-failure detail list (counts stay exact beyond it)."""
    from ..device import resolve_device
    from ..ecc import build_ecc

    dev = resolve_device(device)
    ecc = build_ecc(code, decoder, device=dev, channel=channel,
                    backend=backend)
    adj = _col_rows(ecc.spec)
    failures = []
    set_counts = Counter()
    histogram = Counter()
    done = 0
    step = 0
    while done < frames:
        b = min(batch, frames - done)
        cw, llr = harvest_batch(ecc, seed, step, b, ebn0_db, dev)
        out = ecc.decode(llr)
        bad = torch.nonzero((cw != out.bits).any(1)).squeeze(1)
        cw_h = cw.index_select(0, bad).cpu().numpy()
        bits_h = out.bits.index_select(0, bad).cpu().numpy()
        ok_h = out.ok.index_select(0, bad).cpu().numpy()
        for tx, rx, ok in zip(cw_h, bits_h, ok_h):
            f = classify_failure(ecc.spec, tx, rx, detected=not bool(ok),
                                 col_rows=adj)
            histogram[f.ab] += 1
            set_counts[canonical_set(ecc.spec, f.vn_set)] += 1
            if len(failures) < max_stored:
                failures.append(f)
        done += b
        step += 1
    return TrapReport(code=code, decoder=decoder, ebn0_db=ebn0_db,
                      frames=frames, failures=failures,
                      set_counts=set_counts, histogram=histogram)
