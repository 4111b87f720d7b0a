"""The code reference of a QC configuration whose parity part is a dual
diagonal: H from its frozen table (qc.py), systematic encoding, and the
BPSK/AWGN channel. A configuration names it with "reference":
"qc_dual_diagonal" (the interface: reference/__init__.py).

encode() covers the parity shape both configurations' H has: the first
kb = nb - mb block columns carry the message; parity block column kb is
the special column with blocks (x, y, x) at core rows (0, r, c - 1), block
columns kb + 1 .. kb + c - 1 a shift-0 staircase over the c core rows, and
each later row r >= c has a shift-0 identity block of its own in column
kb + r (the extension rows of 5G NR; DVB-S2's surrogate has none). Summed
over the core rows the staircase and the special pair cancel, which gives
the first parity block; the rest follow by back-substitution. Blocks are
circulants: check z of a block with shift s reads variable (z + s) % Z, so
a check-aligned slab is roll(slab, -s).

llr() is the channel as the sweep defines it: bit b maps to 1 - 2b, noise
sigma = rsqrt(2 R 10^(EbN0/10)) for the rate R over transmitted bits,
LLR = 2 y / sigma^2, and punctured columns read LLR 0. The sigma is worked
out on the host in float32, as the sweep does, then moved.
"""
from __future__ import annotations

import numpy as np
import torch

from .qc import QCTable, check_registered, load  # noqa: F401 (interface)


def _structure(table: QCTable):
    """(kb, core rows c, special (x, y, r)) of the parity part; raises if H
    does not have the shape the module docstring sets out."""
    kb, mb = table.nb - table.mb, table.mb
    cells = {(r, c): s for r, c, s in table.edges}
    column = sorted((r, s) for (r, c), s in cells.items() if c == kb)
    for last in (r for r, _ in column if r >= 2):
        special = [(r, s) for r, s in column if r <= last]
        if (len(special) == 3 and special[0][0] == 0
                and special[0][1] == special[2][1]
                and _parity_fits(cells, kb, mb, last + 1)):
            return kb, last + 1, (special[0][1], special[1][1],
                                  special[1][0])
    raise ValueError("H has no dual-diagonal parity part with a special "
                     "column (x, y, x)")


def _parity_fits(cells: dict, kb: int, mb: int, core: int) -> bool:
    """Whether columns kb + 1 .. kb + core - 1 are a shift-0 staircase over
    the core rows and each later row has its own identity column."""
    for d in range(core - 1):
        rows = {r: s for (r, c), s in cells.items() if c == kb + 1 + d}
        if rows.get(d) != 0 or rows.get(d + 1) != 0 or any(
                r < core and r not in (d, d + 1) for r in rows):
            return False
    for r in range(core, mb):
        if {q: s for (q, c), s in cells.items() if c == kb + r} != {r: 0}:
            return False
    return all(c < kb + core or c == kb + r for (r, c) in cells)


def encode(table: QCTable, msg: torch.Tensor) -> torch.Tensor:
    """Codewords uint8 [B, n] of messages uint8 [B, k]: the message first,
    then the parity blocks in column order."""
    kb, core, (x, y, rmid) = _structure(table)
    Z, B = table.Z, msg.shape[0]
    if msg.shape[1] != kb * Z or table.k != kb * Z:
        raise ValueError("the message fills the first kb block columns")
    u = list(msg.t().contiguous().view(kb, Z, B))
    row_edges = [[] for _ in range(table.mb)]
    for r, c, s in table.edges:
        row_edges[r].append((c, s))

    def syndrome(r, cols):
        acc = torch.zeros((Z, B), dtype=torch.uint8, device=msg.device)
        for c, s in row_edges[r]:
            if c < len(cols):
                acc = acc ^ torch.roll(cols[c], -s, dims=0)
        return acc

    s = [syndrome(r, u) for r in range(core)]
    ssum = s[0]
    for r in range(1, core):
        ssum = ssum ^ s[r]
    p = [torch.roll(ssum, y, dims=0)]
    p.append(s[0] ^ torch.roll(p[0], -x, dims=0))
    for d in range(1, core - 1):
        p.append(p[d] ^ s[d] ^ (ssum if d == rmid else 0))
    cols = u + p
    for r in range(core, table.mb):
        cols.append(syndrome(r, cols[:kb + core]))
    return torch.cat(cols).view(table.n, B).t().contiguous()


def keep_mask(table: QCTable, device) -> torch.Tensor | None:
    """f32 [n]: 0 at punctured columns, 1 elsewhere (None: none punctured)."""
    if not table.punctured:
        return None
    keep = np.ones(table.n, dtype=np.float32)
    for a, b in table.punctured:
        keep[a:b] = 0.0
    return torch.as_tensor(keep, device=device)


def llr(table: QCTable, cw: torch.Tensor, noise: torch.Tensor,
        ebn0_db: float, precision: str = "f32") -> torch.Tensor:
    """Channel LLRs f32 [B, n] of codewords cw with unit normals `noise`
    [B, n]; with precision "bf16" (the control) rounded to bfloat16."""
    ebn0 = 10.0 ** (torch.as_tensor(ebn0_db, dtype=torch.float32) / 10.0)
    sigma = torch.rsqrt(2.0 * table.rate * ebn0).to(cw.device)
    y = (1.0 - 2.0 * cw.to(torch.float32)) + sigma * noise
    out = 2.0 * y / (sigma * sigma)
    keep = keep_mask(table, cw.device)
    if keep is not None:
        out = out * keep + torch.zeros_like(keep)
    if precision == "bf16":
        out = out.to(torch.bfloat16).to(torch.float32)
    return out
