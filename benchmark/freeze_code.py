"""Write a configuration's frozen parity-check table from the port's code
registry, once, when the configuration is added:

    python3 benchmark/freeze_code.py dvbs2/64800/12 benchmark/configs/dvbs2_64800_r12.H.json

The table holds the lifting size Z, the base-matrix shape (mb, nb), the
message length k, the punctured codeword columns as [start, stop) ranges,
and every nonzero block as [block_row, block_column, shift], in the order
the code lists them. The reference (benchmark/reference/) builds H from this
file alone, and every run checks that the port's registered code still has
exactly this H (benchmark/reference/qc.py, check_registered).
"""
from __future__ import annotations

import json
import pathlib
import sys


def ranges(cols) -> list:
    """[start, stop) runs of a sorted list of column indices."""
    out = []
    for c in cols:
        if out and out[-1][1] == c:
            out[-1][1] = c + 1
        else:
            out.append([c, c + 1])
    return out


def table(code: str) -> dict:
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from ecc_ldpc_tpu_torch.codes.registry import get_code

    spec = get_code(code)
    qc = spec.qc
    br, bc, sh = qc.block_edges()
    if spec.shortened_cols:
        raise ValueError(f"{code}: shortened columns are not in the table")
    return {
        "code": code, "Z": int(qc.Z), "mb": int(qc.mb), "nb": int(qc.nb),
        "k": int(spec.k), "punctured": ranges(int(c) for c in
                                              sorted(spec.punctured_cols)),
        "edges": [[int(r), int(c), int(s)] for r, c, s in zip(br, bc, sh)],
    }


if __name__ == "__main__":
    code, out = sys.argv[1], sys.argv[2]
    with open(out, "w") as f:
        json.dump(table(code), f, separators=(",", ":"))
        f.write("\n")
