"""Structured QC encoders in O(n) (port of ecc_ldpc_tpu/encode/structured.py;
codes with no structured skeleton fall back to encode/dense.py).

For base matrices of the 802.11n/WiMAX shape H = [Hi | Hp], where Hp has a
special first parity column with entries (x, y, x) at rows (0, rx, mb-1)
and a shift-0 double-diagonal staircase, the parity blocks follow from the
info blocks without any generator matrix:

  s_i   = sum_j P^{a_ij} u_j                 (block syndromes of the info part)
  P^y p_0 = sum_i s_i                         (rows telescope)
  p_1   = s_0 + P^{x} p_0
  p_{d+1} = p_d + s_d + [P^{y} p_0 if d == rx]   (back-substitution)

The DVB-S2 surrogate (codes/dvbs2.py), 802.11n and WiMAX have this
dual-diagonal shape; 5G NR's core is its 4-row form with degree-1
extension parities (NRCoreExtensionEncoder). Each
encoder is a chain of torch.roll/XOR on [Z, B] slabs on the device of its
input, with a NumPy twin (`encode_numpy`) that validates it against H.
Both roll, so both refuse codes whose blocks are XOR permutations
(QCXorCode, IEEE 802.3an), which take the dense generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.spec import CodeSpec


def _roll(x: torch.Tensor, s: int) -> torch.Tensor:
    """np.roll semantics along axis 0 (static shift)."""
    return torch.roll(x, s, dims=0) if s % x.shape[0] else x


def _circulant_base(spec: CodeSpec) -> np.ndarray:
    """The base matrix of a QC code with circulant blocks; ValueError
    otherwise (these encoders roll)."""
    qc = spec.qc
    if qc is None:
        raise ValueError(f"{spec.name}: not a QC code")
    if getattr(qc, "perm", "roll") != "roll":
        raise ValueError(f"{spec.name}: {qc.perm!r} blocks are not "
                         f"circulants; the structured encoders roll")
    base = getattr(qc, "base", None)
    if base is None:
        raise ValueError(f"{spec.name}: multi-edge QC, no base matrix")
    return base


@dataclasses.dataclass(frozen=True)
class DualDiagonalPlan:
    """Host-side encode plan extracted from a QC base matrix."""

    Z: int
    mb: int
    kb: int
    special_shift: int  # x in the (x, y, x) special column
    special_mid_row: int  # rx
    info_edges: tuple  # tuple of (block_row, block_col, shift)
    special_mid_shift: int = 0  # y (0 for 802.11n and most WiMAX tables)

    @staticmethod
    def from_spec(spec: CodeSpec) -> "DualDiagonalPlan":
        qc = spec.qc
        base = _circulant_base(spec)
        mb, nb = base.shape
        kb = nb - mb
        pcol = base[:, kb]
        rows = np.flatnonzero(pcol >= 0)
        if len(rows) != 3 or rows[0] != 0 or rows[-1] != mb - 1:
            raise ValueError(f"{spec.name}: no (x,y,x) special parity column")
        x0, xm, x2 = pcol[rows[0]], pcol[rows[1]], pcol[rows[2]]
        if x0 != x2:
            raise ValueError(
                f"{spec.name}: special column is ({x0},{xm},{x2}), not "
                f"(x,y,x) — the paired first/last entries must be equal"
            )
        for d in range(mb - 1):
            col = base[:, kb + 1 + d]
            nz = np.flatnonzero(col >= 0)
            if not (len(nz) == 2 and list(nz) == [d, d + 1]
                    and col[d] == 0 and col[d + 1] == 0):
                raise ValueError(
                    f"{spec.name}: parity column {kb+1+d} is not staircase")
        info_edges = tuple(
            (int(i), int(j), int(base[i, j]))
            for i in range(mb)
            for j in range(kb)
            if base[i, j] >= 0
        )
        return DualDiagonalPlan(
            Z=qc.Z, mb=mb, kb=kb, special_shift=int(x0),
            special_mid_row=int(rows[1]), info_edges=info_edges,
            special_mid_shift=int(xm),
        )


class DualDiagonalEncoder:
    """Batched encoder: msg uint8 [B, kb*Z] -> codeword uint8 [B, nb*Z]."""

    def __init__(self, spec: CodeSpec, validate: bool = True):
        self.plan = DualDiagonalPlan.from_spec(spec)
        self.spec = spec
        self.k = self.plan.kb * self.plan.Z
        self.n = (self.plan.kb + self.plan.mb) * self.plan.Z
        if validate:
            rng = np.random.default_rng(0)
            msg = rng.integers(0, 2, (4, self.k), dtype=np.uint8)
            if not spec.check_syndrome(self.encode_numpy(msg)):
                raise AssertionError(
                    f"{spec.name}: structured encode violates H")

    def extract_message(self, codeword_bits):
        return codeword_bits[..., : self.k]

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        """Host-side NumPy twin of __call__ (validation / tests)."""
        p = self.plan
        B = msg_bits.shape[0]
        u = msg_bits.T.astype(np.uint8).reshape(p.kb, p.Z, B)
        s = np.zeros((p.mb, p.Z, B), np.uint8)
        for i, j, sh in p.info_edges:
            s[i] ^= np.roll(u[j], -sh, axis=0)
        p0 = np.roll(s.sum(axis=0) % 2, p.special_mid_shift, axis=0)
        p0_mid = np.roll(p0, -p.special_mid_shift, axis=0)  # P^y p0
        parity = [p0.astype(np.uint8)]
        prev = s[0] ^ np.roll(p0, -p.special_shift, axis=0)
        parity.append(prev.astype(np.uint8))
        for d in range(1, p.mb - 1):
            nxt = prev ^ s[d]
            if d == p.special_mid_row:
                nxt = nxt ^ p0_mid
            parity.append(nxt.astype(np.uint8))
            prev = nxt
        par = np.stack(parity).reshape(p.mb * p.Z, B)
        return np.concatenate([msg_bits.T.astype(np.uint8), par]).T

    def __call__(self, msg_bits: torch.Tensor) -> torch.Tensor:
        p = self.plan
        B = msg_bits.shape[0]
        msgT = msg_bits.t().to(torch.uint8)
        u = msgT.reshape(p.kb, p.Z, B)
        s = [torch.zeros((p.Z, B), dtype=torch.uint8, device=msg_bits.device)
             for _ in range(p.mb)]
        for i, j, sh in p.info_edges:
            # check r of block-row i sees variable (r + sh) % Z: the check-
            # aligned view of slab u_j is roll(u_j, -sh)
            s[i] = s[i] ^ _roll(u[j], -sh)
        p0 = s[0]
        for i in range(1, p.mb):
            p0 = p0 ^ s[i]
        p0 = _roll(p0, p.special_mid_shift)
        p0_mid = _roll(p0, -p.special_mid_shift)  # P^y p_0
        parity = [p0]
        prev = s[0] ^ _roll(p0, -p.special_shift)
        parity.append(prev)
        for d in range(1, p.mb - 1):
            nxt = prev ^ s[d]
            if d == p.special_mid_row:
                nxt = nxt ^ p0_mid
            parity.append(nxt)
            prev = nxt
        par = torch.stack(parity).reshape(p.mb * p.Z, B)
        return torch.cat([msgT, par]).t().contiguous()


class StaircaseEncoder:
    """IRA/accumulator encoder for QC staircase parity: parity block-col d
    hits block-rows d and d+1 with shift 0 (last col only row mb-1). Then
    p_0 = s_0 and p_d = p_{d-1} ^ s_d."""

    def __init__(self, spec: CodeSpec, validate: bool = True):
        qc = spec.qc
        base = _circulant_base(spec)
        mb, nb = base.shape
        kb = nb - mb
        for d in range(mb):
            col = base[:, kb + d]
            nz = np.flatnonzero(col >= 0)
            want = [d, d + 1] if d < mb - 1 else [mb - 1]
            if list(nz) != want or any(col[nz] != 0):
                raise ValueError(f"{spec.name}: parity col {kb+d} not staircase")
        self.spec = spec
        self.Z, self.mb, self.kb = qc.Z, mb, kb
        self.k = kb * qc.Z
        self.n = nb * qc.Z
        self.info_edges = tuple(
            (int(i), int(j), int(base[i, j]))
            for i in range(mb) for j in range(kb) if base[i, j] >= 0
        )
        if validate:
            rng = np.random.default_rng(0)
            msg = rng.integers(0, 2, (2, self.k), dtype=np.uint8)
            if not spec.check_syndrome(self.encode_numpy(msg)):
                raise AssertionError(
                    f"{spec.name}: staircase encode violates H")

    def extract_message(self, codeword_bits):
        return codeword_bits[..., : self.k]

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        B = msg_bits.shape[0]
        u = msg_bits.T.astype(np.uint8).reshape(self.kb, self.Z, B)
        s = np.zeros((self.mb, self.Z, B), np.uint8)
        for i, j, sh in self.info_edges:
            s[i] ^= np.roll(u[j], -sh, axis=0)
        p = np.zeros_like(s)
        p[0] = s[0]
        for d in range(1, self.mb):
            p[d] = p[d - 1] ^ s[d]
        par = p.reshape(self.mb * self.Z, B)
        return np.concatenate([msg_bits.T.astype(np.uint8), par]).T

    def __call__(self, msg_bits: torch.Tensor) -> torch.Tensor:
        B = msg_bits.shape[0]
        msgT = msg_bits.t().to(torch.uint8)
        u = msgT.reshape(self.kb, self.Z, B)
        s = [torch.zeros((self.Z, B), dtype=torch.uint8,
                         device=msg_bits.device) for _ in range(self.mb)]
        for i, j, sh in self.info_edges:
            s[i] = s[i] ^ _roll(u[j], -sh)
        parity = [s[0]]
        for d in range(1, self.mb):
            parity.append(parity[-1] ^ s[d])
        par = torch.stack(parity).reshape(self.mb * self.Z, B)
        return torch.cat([msgT, par]).t().contiguous()


class NRCoreExtensionEncoder:
    """5G NR encoder (38.212 shape): solve the 4-row dual-diagonal core
    parity, then the extension parities drop out directly (their columns
    are degree-1 identities). O(n), roll/XOR only, on the device of its
    input. Handles filler bits: the message is k bits, the info-section
    tail (shortened_cols) is zero."""

    def __init__(self, spec: CodeSpec, validate: bool = True):
        base = _circulant_base(spec)
        mb, nb = base.shape
        # parity section = 4 core + (mb-4) identity columns
        kb = nb - mb
        if mb < 5:
            raise ValueError(f"{spec.name}: too few rows for NR structure")
        # the core is rows 0..3; extension rows may also touch the
        # core-parity columns, as ordinary row_edges after the core solve
        core = base[:4]
        col = core[:, kb]
        nz = np.flatnonzero(col >= 0)
        # special column at rows (0, rm, 3): BG1 has rm=1, BG2 rm=2. The
        # paired first/last shifts (x, _, x) cancel in the 4-row sum,
        # leaving P^y p0 = sum(s) with y the mid-row shift
        if not (len(nz) == 3 and nz[0] == 0 and nz[2] == 3
                and col[nz[0]] == col[nz[2]]):
            raise ValueError(f"{spec.name}: no NR core special column")
        self._mid_row = int(nz[1])
        self._mid_shift = int(col[nz[1]])
        self._special_shift = int(col[0])
        for d, rows in [(1, [0, 1]), (2, [1, 2]), (3, [2, 3])]:
            c = core[:, kb + d]
            nz = np.flatnonzero(c >= 0)
            if not (list(nz) == rows and not c[nz].any()):
                raise ValueError(f"{spec.name}: core col {d} not staircase")
        for r in range(4, mb):
            c = base[:, kb + 4 + (r - 4)]
            nz = np.flatnonzero(c >= 0)
            if not (list(nz) == [r] and c[r] == 0):
                raise ValueError(
                    f"{spec.name}: extension col for row {r} missing")
        self.spec = spec
        self.Z, self.mb, self.kb = spec.qc.Z, mb, kb
        self.k = spec.k
        self.n = nb * self.Z
        self.k_full = kb * self.Z
        # per-row entries over info + core-parity columns (j < kb+4)
        self.row_edges = tuple(
            tuple((int(j), int(base[i, j])) for j in range(kb + 4)
                  if base[i, j] >= 0 and not (i < 4 and j >= kb))
            for i in range(mb)
        )
        if validate:
            rng = np.random.default_rng(0)
            msg = rng.integers(0, 2, (2, self.k), dtype=np.uint8)
            if not spec.check_syndrome(self.encode_numpy(msg)):
                raise AssertionError(f"{spec.name}: NR encode violates H")

    def extract_message(self, codeword_bits):
        return codeword_bits[..., : self.k]

    def _solve(self, u, roll, zeros, cat):
        """Core then extension parities of the info slabs u ([Z, B] each,
        kb of them) by `roll` (np.roll semantics) and XOR."""
        s = [zeros() for _ in range(4)]
        for i in range(4):
            for j, sh in self.row_edges[i]:
                s[i] = s[i] ^ roll(u[j], -sh)
        # 4-row sum: staircase pairs cancel, the (x,_,x) special pair
        # cancels, leaving P^y p0 = s0+s1+s2+s3
        ssum = s[0] ^ s[1] ^ s[2] ^ s[3]
        p0 = roll(ssum, self._mid_shift)
        p1 = s[0] ^ roll(p0, -self._special_shift)
        p2 = s[1] ^ p1 ^ (ssum if self._mid_row == 1 else zeros())
        p3 = s[2] ^ p2 ^ (ssum if self._mid_row == 2 else zeros())
        core = [p0, p1, p2, p3]
        cols = list(u) + core
        ext = []
        for r in range(4, self.mb):
            sr = zeros()
            for j, sh in self.row_edges[r]:
                sr = sr ^ roll(cols[j], -sh)
            ext.append(sr)
        return cat(core + ext)

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        """Host-side NumPy twin of __call__."""
        B = msg_bits.shape[0]
        full = np.zeros((B, self.k_full), np.uint8)
        full[:, : self.k] = msg_bits
        u = full.T.reshape(self.kb, self.Z, B)
        par = self._solve(u, lambda x, s: np.roll(x, s, axis=0),
                          lambda: np.zeros((self.Z, B), np.uint8),
                          lambda slabs: np.concatenate(slabs, axis=0))
        return np.concatenate([full.T, par]).T

    def __call__(self, msg_bits: torch.Tensor) -> torch.Tensor:
        B, dev = msg_bits.shape[0], msg_bits.device
        full = torch.zeros((self.k_full, B), dtype=torch.uint8, device=dev)
        full[: self.k] = msg_bits.t().to(torch.uint8)
        u = full.reshape(self.kb, self.Z, B)
        par = self._solve(
            u, _roll,
            lambda: torch.zeros((self.Z, B), dtype=torch.uint8, device=dev),
            lambda slabs: torch.cat(slabs, dim=0))
        return torch.cat([full, par]).t().contiguous()


def build_encoder(spec: CodeSpec):
    """The encoder for a code, tried in the JAX package's order: the
    structured ones where the QC skeleton allows (dual-diagonal,
    staircase, NR core+extension), the dense generator otherwise. A
    tail-shortened code (codes/puncture.shorten, NR filler bits) gets its
    mother encoder wrapped with zero-fill (codes/puncture.ShortenedEncoder)."""
    enc = None
    if spec.qc is not None:
        for cls in (DualDiagonalEncoder, StaircaseEncoder,
                    NRCoreExtensionEncoder):
            try:
                enc = cls(spec)
                break
            except ValueError:
                pass
    if enc is None:
        from .dense import DenseEncoder

        enc = DenseEncoder.build(spec)
    if enc.k != spec.k and spec.shortened_cols:
        tail = tuple(range(spec.k, enc.k))
        if tuple(spec.shortened_cols[-len(tail):]) == tail:
            from ..codes.puncture import ShortenedEncoder

            return ShortenedEncoder(enc, spec)
    return enc
