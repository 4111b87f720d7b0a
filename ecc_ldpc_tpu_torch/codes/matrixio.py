"""Text parity-check-matrix formats beyond alist (SURVEY.md §2.2 C1).

A verbatim copy of ecc_ldpc_tpu/codes/matrixio.py (the port imports
nothing of the JAX package; NumPy only).

The reference loads G/H matrices from on-disk text listings (SURVEY.md
§2.1 R9: "alist and/or MATLAB-style sparse listings"; the repo ships
matrix data files like jpl.1K4). alist.py is the primary format; this
module adds the two other formats such listings come in, plus a sniffing
loader so file paths work anywhere a code-spec string does:

1. MATLAB sparse triplet text — the `spconvert` convention: one nonzero
   per line as `i j [v]` (1-indexed), optionally ending with an `m n 0`
   line that pins the matrix dimensions, `%` comments allowed. This is
   what `[i,j,v] = find(H)` dumps and what MATLAB LDPC scripts pass
   around.
2. Dense 0/1 text — one matrix row per line, entries separated by
   whitespace (or not separated at all: `0110...`), the textbook-listing
   form.

`load_matrix(path)` sniffs alist / triplet / dense from content and the
code registry accepts `mat:<path>` (triplet), `dense:<path>` and
`file:<path>` (sniffed) prefixes next to the existing `alist:<path>`.

All loaders produce a CodeSpec whose H is exactly the file's matrix
(values are GF(2): odd=1, even nonzero rejected as ambiguous).
Round-trip tested in tests/unit/test_matrixio.py.
"""
from __future__ import annotations

import numpy as np

from .spec import CodeSpec


def _spec_from_triplets(rows, cols, m: int, n: int, name: str) -> CodeSpec:
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size:
        if rows.min() < 0 or cols.min() < 0:
            raise ValueError("negative matrix index")
        if rows.max() >= m or cols.max() >= n:
            raise ValueError(
                f"entry ({rows.max()},{cols.max()}) outside declared "
                f"{m}x{n} matrix"
            )
    row_cols = [np.zeros(0, np.int32)] * m
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    starts = np.searchsorted(rows, np.arange(m))
    ends = np.searchsorted(rows, np.arange(m), side="right")
    for i in range(m):
        rc = cols[starts[i] : ends[i]].astype(np.int32)
        uniq = np.unique(rc)
        if uniq.size != rc.size:
            raise ValueError(f"duplicate entry in row {i}")
        row_cols[i] = uniq
    return CodeSpec(name=name, n=n, m=m, row_cols=tuple(row_cols))


# -- MATLAB sparse triplet text ---------------------------------------------


def loads_matlab_sparse(text: str, name: str = "matlab") -> CodeSpec:
    """Parse `i j [v]` triplet lines (1-indexed, spconvert convention)."""
    rows, cols = [], []
    mn_pin = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("%", 1)[0].split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        if len(toks) not in (2, 3):
            raise ValueError(
                f"line {lineno}: expected 'i j [v]', got {raw!r}"
            )
        i, j = int(toks[0]), int(toks[1])
        v = int(float(toks[2])) if len(toks) == 3 else 1
        if v == 0:
            # spconvert dimension pin: an explicit zero at (m, n)
            mn_pin = (i, j)
            continue
        if v % 2 == 0:
            raise ValueError(
                f"line {lineno}: even value {v} is ambiguous over GF(2)"
            )
        if i < 1 or j < 1:
            raise ValueError(f"line {lineno}: indices are 1-based")
        rows.append(i - 1)
        cols.append(j - 1)
    if not rows and mn_pin is None:
        raise ValueError("no entries")
    m = max((r + 1 for r in rows), default=0)
    n = max((c + 1 for c in cols), default=0)
    if mn_pin is not None:
        if mn_pin[0] < m or mn_pin[1] < n:
            raise ValueError(
                f"size pin {mn_pin} smaller than largest entry ({m},{n})"
            )
        m, n = mn_pin
    return _spec_from_triplets(rows, cols, m, n, name)


def dumps_matlab_sparse(spec: CodeSpec) -> str:
    """Triplet text with a trailing size pin (load + spconvert ready)."""
    out = [f"% {spec.name}: {spec.m} x {spec.n} parity-check matrix"]
    for i in range(spec.m):
        out.extend(f"{i + 1} {int(j) + 1} 1" for j in spec.row_cols[i])
    out.append(f"{spec.m} {spec.n} 0")
    return "\n".join(out) + "\n"


# -- dense 0/1 text -----------------------------------------------------------


def loads_dense(text: str, name: str = "dense") -> CodeSpec:
    """Parse a dense 0/1 listing: one row per line, spaces optional."""
    rows = []
    width = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("%", 1)[0].split("#", 1)[0].strip()
        if not line:
            continue
        digits = line.replace(" ", "").replace("\t", "").replace(",", "")
        if not digits or set(digits) - {"0", "1"}:
            raise ValueError(f"line {lineno}: not a 0/1 row: {raw!r}")
        if width is None:
            width = len(digits)
        elif len(digits) != width:
            raise ValueError(
                f"line {lineno}: row width {len(digits)} != {width}"
            )
        rows.append(np.frombuffer(digits.encode(), np.uint8) - ord("0"))
    if not rows:
        raise ValueError("no rows")
    H = np.stack(rows)
    row_cols = tuple(
        np.flatnonzero(H[i]).astype(np.int32) for i in range(H.shape[0])
    )
    return CodeSpec(name=name, n=H.shape[1], m=H.shape[0], row_cols=row_cols)


def dumps_dense(spec: CodeSpec) -> str:
    lines = []
    for i in range(spec.m):
        row = np.zeros(spec.n, np.uint8)
        row[spec.row_cols[i]] = 1
        lines.append("".join("1" if b else "0" for b in row))
    return "\n".join(lines) + "\n"


# -- sniffing loader ----------------------------------------------------------


def sniff_format(text: str) -> str:
    """'alist' | 'matlab' | 'dense' from content alone."""
    lines = [
        ln.split("%", 1)[0].split("#", 1)[0].strip()
        for ln in text.splitlines()
    ]
    lines = [ln for ln in lines if ln]
    if not lines:
        raise ValueError("empty matrix file")
    first = lines[0].split()
    if len(first) == 2 and len(lines) >= 4 and len(lines[1].split()) == 2:
        # alist: line 1 'n m', line 2 'dv_max dc_max', then degree lists
        # whose lengths match line 1 — triplet files have 2-3 tokens per
        # line throughout, alist's line 3 has n tokens
        n = int(first[0])
        if len(lines[2].split()) == n:
            return "alist"
    # Triplet shape (2-3 tokens/line) beats the 0/1-characters dense test:
    # a MATLAB triplet file whose indices happen to be all-0/1 digits
    # (rows/cols 1, 10, 11, 100, ...) must not silently load as the wrong
    # dense matrix (ADVICE r2 item 4). Dense files with <=3 columns are
    # still recognized when written unspaced ('011' per row) — loads_dense
    # accepts both forms, dumps_dense writes unspaced.
    if all(len(ln.split()) in (2, 3) for ln in lines) and any(
        t not in ("0", "1") for ln in lines for t in ln.split()
    ):
        # The magnitude guard (some token > 1) keeps space-separated narrow
        # dense files ('0 1 1' rows) out of the triplet branch: MATLAB
        # triplets are 1-based, so any real triplet beyond a 1x1 matrix
        # carries an index >= 2 (ADVICE r3 item 3).
        return "matlab"
    if all(set(ln.replace(" ", "").replace("\t", "")) <= {"0", "1"}
           for ln in lines) and any(
        len(ln.replace(" ", "")) > 2 for ln in lines
    ):
        return "dense"
    raise ValueError("unrecognized matrix text format")


def loads_matrix(text: str, name: str = "file") -> CodeSpec:
    fmt = sniff_format(text)
    if fmt == "alist":
        from .alist import loads_alist

        return loads_alist(text, name=name)
    if fmt == "matlab":
        return loads_matlab_sparse(text, name=name)
    return loads_dense(text, name=name)


def load_matrix(path, name: str | None = None) -> CodeSpec:
    with open(path) as f:
        return loads_matrix(f.read(), name=name or str(path))


def load_matlab_sparse(path, name: str | None = None) -> CodeSpec:
    with open(path) as f:
        return loads_matlab_sparse(f.read(), name=name or str(path))


def load_dense(path, name: str | None = None) -> CodeSpec:
    with open(path) as f:
        return loads_dense(f.read(), name=name or str(path))
