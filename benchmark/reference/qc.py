"""A configuration's parity-check matrix H, from its frozen table alone.

The table (benchmark/configs/<config>.H.json, written by
benchmark/freeze_code.py) lists every nonzero Z x Z block of H as
[block_row, block_column, shift]: check z of the block reads variable
block_column * Z + (z + shift) % Z. The layered schedule visits the block
rows stably sorted by their degree and each row's blocks in table order,
which is the order the decoders under test are defined by.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QCTable:
    Z: int
    mb: int
    nb: int
    k: int
    edges: tuple      # ((block_row, block_column, shift), ...)
    punctured: tuple  # ((start, stop), ...) codeword columns never sent

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def num_edges(self) -> int:
        return len(self.edges) * self.Z

    @property
    def n_sent(self) -> int:
        return self.n - sum(b - a for a, b in self.punctured)

    @property
    def rate(self) -> float:
        """Message bits over transmitted bits."""
        return self.k / self.n_sent

    def rows(self) -> list:
        """Block rows in layer order: [(row, [(edge id, column, shift)])]."""
        rows = [[] for _ in range(self.mb)]
        for e, (r, c, s) in enumerate(self.edges):
            rows[r].append((e, c, s))
        order = sorted(range(self.mb), key=lambda i: len(rows[i]))
        return [(i, rows[i]) for i in order]

    def var_index(self, edges, device) -> torch.Tensor:
        """long [d * Z]: the variable check z of slot j reads, at j * Z + z."""
        z = np.arange(self.Z)
        idx = np.concatenate([c * self.Z + (z + s) % self.Z
                              for _, c, s in edges])
        return torch.as_tensor(idx, dtype=torch.long, device=device)


def load(path) -> QCTable:
    with open(path) as f:
        t = json.load(f)
    return QCTable(Z=t["Z"], mb=t["mb"], nb=t["nb"], k=t["k"],
                   edges=tuple(tuple(e) for e in t["edges"]),
                   punctured=tuple(tuple(p) for p in t["punctured"]))


def syndrome_fail(table: QCTable, cw: torch.Tensor) -> torch.Tensor:
    """bool [B]: some check of the codewords cw uint8 [B, n] fails."""
    B = cw.shape[0]
    fail = torch.zeros(B, dtype=torch.bool, device=cw.device)
    for _, edges in table.rows():
        idx = table.var_index(edges, cw.device)
        par = cw[:, idx].view(B, len(edges), table.Z).sum(1, dtype=torch.int32)
        fail |= (par % 2 != 0).any(1)
    return fail


def check_registered(table: QCTable, spec) -> None:
    """Raise unless the port's code `spec` (a codes.spec.CodeSpec) has
    exactly the frozen H: the same lifting, blocks, shifts, message length
    and punctured columns, and no shortened ones."""
    qc = spec.qc
    br, bc, sh = qc.block_edges()
    edges = tuple((int(r), int(c), int(s)) for r, c, s in zip(br, bc, sh))
    punct = sorted(int(c) for c in spec.punctured_cols)
    want = [c for a, b in table.punctured for c in range(a, b)]
    diffs = [name for name, ok in (
        ("Z", qc.Z == table.Z), ("mb", qc.mb == table.mb),
        ("nb", qc.nb == table.nb), ("k", spec.k == table.k),
        ("edges", edges == table.edges), ("punctured", punct == want),
        ("shortened", not spec.shortened_cols),
        ("perm", getattr(qc, "perm", "roll") == "roll"))
        if not ok]
    if diffs:
        raise ValueError(f"{spec.name}: the registered code differs from the "
                         f"frozen table in {', '.join(diffs)}")
