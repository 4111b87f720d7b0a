"""Channel-spec registry and modems (port of ecc_ldpc_tpu/chan/modem.py).

  bpsk            soft-decision BPSK over AWGN (default; chan/awgn.py)
  hard            hard-decision BPSK over AWGN: LLR = sign * log((1-p)/p)
                  at the crossover p = Q(sqrt(2*R*Eb/N0)) of the point
  bsc:P           binary symmetric channel with a fixed crossover P (the
                  sweep's Eb/N0 is ignored)
  bec:EPS         binary erasure channel: LLR 0 with probability EPS, else
                  +-60 (Eb/N0 ignored)
  rayleigh        coherent BPSK over i.i.d. Rayleigh fading, h known
  qpsk            Gray QPSK over complex AWGN (== qam4)
  8psk            Gray 8PSK, exact bit LLRs from the joint 2-D metric
  qam16/64/256    Gray square M-QAM, exact per-dimension bit LLRs
  apsk16[:gG]     DVB-S2 16APSK (4+12 rings, the standard's labels) and
  apsk32[:gG:gG]  32APSK (4+12+16, the JAX package's seeded quasi-Gray
                  surrogate labels), exact joint-2-D bit LLRs; ring ratios
                  by code rate with ':rRATE' (APSK16_GAMMA, APSK32_GAMMA)
  ...:il          any multi-bit/symbol spec: the DVB-S2 block bit
                  interleaver (write column-wise, read row-wise)

Constellations have unit average symbol energy; with b bits a symbol and
code rate R, the per-dimension sigma^2 = 1/(2*b*R*10^(EbN0_dB/10)). Symbol
s carries bits [s*b, s*b + b), MSB first; square QAM puts the first b/2
on I and the rest on Q, each a Gray PAM. The demappers compute the exact
log-sum-exp as the JAX package does: a Python loop over the points with
logaddexp accumulators started at -1e30, in the same point and bit order,
with no [..., M] tensor. They are XLA code there, not Pallas kernels, so
plain PyTorch is their counterpart on either device.

The draws contract. A built channel (`Channel`) declares what it draws
per frame, `draws` "normals" or "uniforms" and `count` of them, and takes
them as its `noise` argument [..., count] in a layout fixed here:
  bpsk, hard       n normals, one a bit
  qam, psk, apsk   2 * n / b normals: I then Q of each symbol, in
                   transmitted symbol order
  rayleigh         3 * n normals: per bit the fade's real part, its
                   imaginary part, then the noise; the fade is
                   |CN(0, 1)| = sqrt((a^2 + b^2) / 2)
  bsc, bec         n uniforms in (0, 1], one a bit: flip or erase where
                   u < p
Given no noise, it draws them from the torch.Generator (Channel.draw).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .awgn import awgn_llr, bpsk, llr_from_channel, make_channel, \
    noise_sigma, q_function

_QAM_NAMES = {"qpsk": 4, "qam4": 4, "qam16": 16, "qam64": 64, "qam256": 256}
# DVB-S2 APSK ring ratios per code rate (ecc_ldpc_tpu/chan/modem.py:293-296)
APSK16_GAMMA = {"23": 3.15, "34": 2.85, "45": 2.75, "56": 2.70,
                "89": 2.60, "910": 2.57}
APSK32_GAMMA = {"34": (2.84, 5.27), "45": (2.72, 4.87), "56": (2.64, 4.64),
                "89": (2.54, 4.33), "910": (2.53, 4.30)}
_NEG_INF = -1e30  # the log-sum-exp accumulators' start
_ERASURE_KNOWN_LLR = 60.0
DRAWS = ("normals", "uniforms")


# ---------------------------------------------------------------------------
# Constellation tables (host-side NumPy, tiny)
# ---------------------------------------------------------------------------


def _gray(i: int) -> int:
    return i ^ (i >> 1)


def _bit_table(labels, bits: int) -> np.ndarray:
    """[M, bits]: bit j (MSB first) of each point's label."""
    table = np.zeros((len(labels), bits), dtype=np.int64)
    for i, lab in enumerate(labels):
        for j in range(bits):
            table[i, j] = (int(lab) >> (bits - 1 - j)) & 1
    return table


def pam_tables(bits_per_dim: int):
    """(levels[L], bit_table[L, bd], level_by_bitint[2**bd]): unscaled odd
    levels (-L+1, ..., L-1), bit j (MSB first) of each level's Gray label,
    and the level whose Gray label has integer value v."""
    L = 1 << bits_per_dim
    levels = np.arange(L, dtype=np.float64) * 2.0 - (L - 1)
    labels = np.asarray([_gray(i) for i in range(L)], dtype=np.int64)
    level_by_bitint = np.zeros(L, dtype=np.float64)
    level_by_bitint[labels] = levels
    return levels, _bit_table(labels, bits_per_dim), level_by_bitint


def qam_unit_scale(M: int) -> float:
    """Per-level scale d giving square M-QAM unit average symbol energy:
    Es = 2 * d^2 * (L^2 - 1) / 3 = 1 for L = sqrt(M)."""
    L = int(round(math.sqrt(M)))
    return math.sqrt(3.0 / (2.0 * (L * L - 1)))


def psk_tables(bits_per_sym: int):
    """(xi[M], xq[M], bit_table[M, b], xi_by_bitint[M], xq_by_bitint[M]):
    point i at angle 2*pi*i/M carries Gray label gray(i), MSB first."""
    M = 1 << bits_per_sym
    ang = 2.0 * np.pi * np.arange(M) / M
    xi, xq = np.cos(ang), np.sin(ang)
    labels = np.asarray([_gray(i) for i in range(M)], dtype=np.int64)
    xi_by_bitint = np.zeros(M)
    xq_by_bitint = np.zeros(M)
    xi_by_bitint[labels] = xi
    xq_by_bitint[labels] = xq
    return xi, xq, _bit_table(labels, bits_per_sym), xi_by_bitint, \
        xq_by_bitint


def _quasi_gray_labels(xi, xq, bits: int, seed: int = 5, restarts: int = 8):
    """Deterministic quasi-Gray labeling: minimize sum over point pairs of
    exp(-d^2) * Hamming(label_i, label_j) by pairwise-swap descent from
    seeded random starts (the JAX package's 32APSK surrogate, the same
    labels from the same seed)."""
    M = len(xi)
    d2 = (xi[:, None] - xi[None, :]) ** 2 + (xq[:, None] - xq[None, :]) ** 2
    w = np.exp(-d2)
    np.fill_diagonal(w, 0.0)
    pop = np.arange(M)
    hamming = np.zeros((M, M))
    for a in range(M):
        for b in range(M):
            hamming[a, b] = bin(a ^ b).count("1")

    def cost(lab):
        return float(np.sum(w * hamming[np.ix_(lab, lab)]))

    rng = np.random.default_rng(seed)
    best_lab, best_c = None, np.inf
    for _ in range(restarts):
        lab = rng.permutation(pop)
        c = cost(lab)
        improved = True
        while improved:
            improved = False
            for i in range(M):
                for j in range(i + 1, M):
                    lab[i], lab[j] = lab[j], lab[i]
                    c2 = cost(lab)
                    if c2 < c - 1e-12:
                        c = c2
                        improved = True
                    else:
                        lab[i], lab[j] = lab[j], lab[i]
        if c < best_c:
            best_c, best_lab = c, lab.copy()
    return best_lab


def apsk_rings(M: int, gamma):
    """[(radius, points, phase)] per ring of unit-mean-energy DVB-S2 APSK."""
    if M == 16:
        g = float(gamma[0]) if isinstance(gamma, (tuple, list)) else float(gamma)
        r1 = math.sqrt(16.0 / (4.0 + 12.0 * g * g))
        return [(r1, 4, math.pi / 4), (g * r1, 12, math.pi / 12)]
    if M == 32:
        g1, g2 = (float(gamma[0]), float(gamma[1]))
        r1 = math.sqrt(32.0 / (4.0 + 12.0 * g1 * g1 + 16.0 * g2 * g2))
        return [(r1, 4, math.pi / 4), (g1 * r1, 12, math.pi / 12),
                (g2 * r1, 16, 0.0)]
    raise ValueError(f"APSK supports M in (16, 32), not {M}")


# EN 302 307 Figure 10's 16APSK mapping (the JAX package's table): points
# 0-3 the inner ring at 45/135/225/315 deg, 4-15 the outer at 15/45/...
_APSK16_STD_LABELS = (12, 14, 15, 13, 4, 0, 8, 10, 2, 6, 7, 3, 11, 9, 1, 5)
_APSK_CACHE = {}


def apsk_tables(M: int, gamma):
    """(xi[M], xq[M], bit_table[M, b], lut_i[M], lut_q[M]): the points and
    the label -> coordinate tables, cached per (M, gamma)."""
    gkey = tuple(gamma) if isinstance(gamma, (tuple, list)) else (float(gamma),)
    key = (M, gkey)
    if key in _APSK_CACHE:
        return _APSK_CACHE[key]
    xs, ys = [], []
    for r, cnt, off in apsk_rings(M, gamma):
        for k in range(cnt):
            ang = off + 2.0 * math.pi * k / cnt
            xs.append(r * math.cos(ang))
            ys.append(r * math.sin(ang))
    xi = np.asarray(xs)
    xq = np.asarray(ys)
    b = int(round(math.log2(M)))
    labels = (np.asarray(_APSK16_STD_LABELS) if M == 16
              else _quasi_gray_labels(xi, xq, b))
    lut_i = np.zeros(M)
    lut_q = np.zeros(M)
    lut_i[labels] = xi
    lut_q[labels] = xq
    out = (xi, xq, _bit_table(labels, b), lut_i, lut_q)
    _APSK_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Mappers and exact demappers
# ---------------------------------------------------------------------------


def _symbols(bits: torch.Tensor, b: int) -> torch.Tensor:
    """bits [..., n] -> each symbol's label as an int64 [..., n/b]."""
    n = bits.shape[-1]
    if n % b:
        raise ValueError(f"codeword length {n} not divisible by {b} "
                         f"bits/symbol")
    sym = bits.reshape(*bits.shape[:-1], n // b, b).to(torch.int64)
    v = torch.zeros(sym.shape[:-1], dtype=torch.int64, device=bits.device)
    for j in range(b):
        v = v + sym[..., j] * (1 << (b - 1 - j))
    return v


def _lookup(table: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """f32 table[v] (the JAX package's compare-mask sum over the labels:
    one nonzero term, so the same float)."""
    return torch.as_tensor(table.astype(np.float32), device=v.device)[v]


def qam_modulate(bits: torch.Tensor, M: int):
    """bits [..., n] in {0,1} -> (xi, xq) f32 [..., n/b]."""
    b = int(round(math.log2(M)))
    bd = b // 2
    if 1 << b != M or b % 2:
        raise ValueError(f"M={M} is not an even power of 2 (square QAM)")
    _, _, lut = pam_tables(bd)
    lut = lut * qam_unit_scale(M)
    v = _symbols(bits, b)
    return _lookup(lut, v >> bd), _lookup(lut, v & ((1 << bd) - 1))


def _accumulate(metrics, bit_table: np.ndarray, shape, device):
    """[..., n_sym, b] exact bit LLRs from the per-point metrics (an
    iterable of f32 tensors in point order): logaddexp accumulators per bit
    value, started at -1e30, then acc0 - acc1."""
    bits = bit_table.shape[1]
    acc0 = [torch.full(shape, _NEG_INF, device=device) for _ in range(bits)]
    acc1 = [torch.full(shape, _NEG_INF, device=device) for _ in range(bits)]
    for i, metric in enumerate(metrics):
        for j in range(bits):
            if bit_table[i, j] == 0:
                acc0[j] = torch.logaddexp(acc0[j], metric)
            else:
                acc1[j] = torch.logaddexp(acc1[j], metric)
    return torch.stack([a0 - a1 for a0, a1 in zip(acc0, acc1)], dim=-1)


def _inv2s2(sigma) -> torch.Tensor:
    return 1.0 / (2.0 * sigma * sigma)


def pam_bit_llrs(y: torch.Tensor, bits_per_dim: int, scale: float, sigma):
    """Exact per-bit LLRs of one Gray-PAM dimension: y [..., n_sym] ->
    [..., n_sym, bits_per_dim], positive LLR => bit 0."""
    levels, bit_table, _ = pam_tables(bits_per_dim)
    inv2s2 = _inv2s2(torch.as_tensor(sigma, dtype=torch.float32,
                                     device=y.device))

    def metrics():
        for lev in levels:
            dist = y - float(np.float32(lev * scale))
            yield -(dist * dist) * inv2s2

    return _accumulate(metrics(), bit_table, y.shape, y.device)


def const_bit_llrs(yi, yq, xi, xq, bit_table, sigma):
    """Exact per-bit LLRs from the joint 2-D metric for any point list
    (xi, xq, bit_table[M, b]): [..., n_sym, b]."""
    inv2s2 = _inv2s2(torch.as_tensor(sigma, dtype=torch.float32,
                                     device=yi.device))

    def metrics():
        for i in range(len(xi)):
            di = yi - float(np.float32(xi[i]))
            dq = yq - float(np.float32(xq[i]))
            yield -(di * di + dq * dq) * inv2s2

    return _accumulate(metrics(), np.asarray(bit_table), yi.shape, yi.device)


def psk_modulate(bits: torch.Tensor, M: int):
    """bits [..., n] -> (xi, xq) f32 [..., n/b] of Gray M-PSK."""
    b = int(round(math.log2(M)))
    if 1 << b != M:
        raise ValueError(f"M={M} is not a power of 2")
    _, _, _, lut_i, lut_q = psk_tables(b)
    v = _symbols(bits, b)
    return _lookup(lut_i, v), _lookup(lut_q, v)


def psk_bit_llrs(yi, yq, bits_per_sym: int, sigma):
    """Exact per-bit LLRs of Gray PSK from the joint 2-D metric."""
    xi, xq, bit_table, _, _ = psk_tables(bits_per_sym)
    return const_bit_llrs(yi, yq, xi, xq, bit_table, sigma)


def apsk_modulate(bits: torch.Tensor, M: int, gamma):
    """bits [..., n] -> (xi, xq) f32 [..., n/b] of DVB-S2 M-APSK."""
    b = int(round(math.log2(M)))
    _, _, _, lut_i, lut_q = apsk_tables(M, gamma)
    v = _symbols(bits, b)
    return _lookup(lut_i, v), _lookup(lut_q, v)


def _symbol_sigma(ebn0_db, rate, b: int, device) -> torch.Tensor:
    """Per-dimension sigma of b bits a unit-energy symbol."""
    ebn0 = 10.0 ** (torch.as_tensor(ebn0_db, dtype=torch.float32) / 10.0)
    return torch.rsqrt(2.0 * b * rate * ebn0).to(device)


def _received(xi, xq, sigma, noise):
    """y = x + sigma * n, with the noise's I then Q of each symbol."""
    pairs = noise.reshape(*xi.shape, 2)
    return xi + sigma * pairs[..., 0], xq + sigma * pairs[..., 1]


def qam_awgn_llr(gen, bits, ebn0_db, rate, M: int, noise=None):
    """Gray M-QAM over complex AWGN: bit LLRs [..., n] (bits' shape); the
    2n/b unit normals from gen, or given as noise (I then Q a symbol)."""
    b = int(round(math.log2(M)))
    bd = b // 2
    xi, xq = qam_modulate(bits, M)
    noise = _normals(gen, noise, (*xi.shape[:-1], 2 * xi.shape[-1]),
                     bits.device)
    sigma = _symbol_sigma(ebn0_db, rate, b, bits.device)
    yi, yq = _received(xi, xq, sigma, noise)
    d = qam_unit_scale(M)
    llr = torch.cat([pam_bit_llrs(yi, bd, d, sigma),
                     pam_bit_llrs(yq, bd, d, sigma)], dim=-1)
    return llr.reshape(bits.shape)


def psk_awgn_llr(gen, bits, ebn0_db, rate, M: int, noise=None):
    """Gray M-PSK over complex AWGN: exact bit LLRs [..., n]."""
    b = int(round(math.log2(M)))
    xi, xq = psk_modulate(bits, M)
    noise = _normals(gen, noise, (*xi.shape[:-1], 2 * xi.shape[-1]),
                     bits.device)
    sigma = _symbol_sigma(ebn0_db, rate, b, bits.device)
    yi, yq = _received(xi, xq, sigma, noise)
    return psk_bit_llrs(yi, yq, b, sigma).reshape(bits.shape)


def apsk_awgn_llr(gen, bits, ebn0_db, rate, M: int, gamma, noise=None):
    """DVB-S2 M-APSK over complex AWGN: exact bit LLRs [..., n]."""
    b = int(round(math.log2(M)))
    xi_t, xq_t, bit_table, _, _ = apsk_tables(M, gamma)
    xi, xq = apsk_modulate(bits, M, gamma)
    noise = _normals(gen, noise, (*xi.shape[:-1], 2 * xi.shape[-1]),
                     bits.device)
    sigma = _symbol_sigma(ebn0_db, rate, b, bits.device)
    yi, yq = _received(xi, xq, sigma, noise)
    return const_bit_llrs(yi, yq, xi_t, xq_t, bit_table,
                          sigma).reshape(bits.shape)


# ---------------------------------------------------------------------------
# DVB-S2 block bit interleaver (EN 302 307 §5.3.3)
# ---------------------------------------------------------------------------


def interleave_tx(cw: torch.Tensor, b: int) -> torch.Tensor:
    """Codeword -> transmitted bit order: written column-wise into b
    columns of n/b rows, read row-wise."""
    n = cw.shape[-1]
    return cw.reshape(*cw.shape[:-1], b, n // b).transpose(-1, -2).reshape(
        *cw.shape[:-1], n)


def deinterleave_llr(llr_tx: torch.Tensor, b: int) -> torch.Tensor:
    """The inverse on received LLRs: transmitted order -> codeword order."""
    n = llr_tx.shape[-1]
    return llr_tx.reshape(*llr_tx.shape[:-1], n // b, b).transpose(
        -1, -2).reshape(*llr_tx.shape[:-1], n)


# ---------------------------------------------------------------------------
# Uncoded anchors and the bit channels
# ---------------------------------------------------------------------------


def uncoded_8psk_ber_approx(ebn0_db) -> torch.Tensor:
    """Gray 8PSK uncoded BER, nearest-neighbour approximation:
    Pb ~ (2/3) Q(sqrt(6 Eb/N0) sin(pi/8)), tight above ~6 dB."""
    g = 10.0 ** (torch.as_tensor(ebn0_db, dtype=torch.float32) / 10.0)
    return (2.0 / 3.0) * q_function(torch.sqrt(6.0 * g)
                                    * math.sin(math.pi / 8.0))


def uncoded_rayleigh_ber(ebn0_db) -> torch.Tensor:
    """Closed-form uncoded coherent-BPSK BER over Rayleigh fading:
    (1 - sqrt(g / (1 + g))) / 2 for g = Eb/N0."""
    g = 10.0 ** (torch.as_tensor(ebn0_db, dtype=torch.float32) / 10.0)
    return 0.5 * (1.0 - torch.sqrt(g / (1.0 + g)))


def _normals(gen, noise, shape, device) -> torch.Tensor:
    if noise is not None:
        return noise
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _uniforms(gen, noise, shape, device) -> torch.Tensor:
    if noise is not None:
        return noise
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def _log_ratio(p) -> torch.Tensor:
    """log((1 - p) / p) as log1p(-p) - log(p), in f32."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return torch.log1p(-p) - torch.log(p)


def bsc_llr(gen, bits, p, noise=None):
    """Binary symmetric channel with crossover p: a bit flips where its
    uniform u < p; LLR = +-log((1-p)/p)."""
    u = _uniforms(gen, noise, bits.shape, bits.device)
    received = bits.to(torch.bool) ^ (u < p)
    mag = _log_ratio(p).to(bits.device)
    return torch.where(received, -mag, mag)


def bec_llr(gen, bits, eps, noise=None):
    """Binary erasure channel: a bit is erased (LLR 0) where its uniform
    u < eps, else known (LLR +-60)."""
    u = _uniforms(gen, noise, bits.shape, bits.device)
    sign = 1.0 - 2.0 * bits.to(torch.float32)
    return torch.where(u < eps, 0.0, sign * _ERASURE_KNOWN_LLR)


def rayleigh_bpsk_llr(gen, bits, ebn0_db, rate, noise=None):
    """Coherent BPSK over i.i.d. Rayleigh fading: y = h*x + n with
    h = |CN(0, 1)| (E[h^2] = 1) known at the receiver; LLR = h * 2y/sigma^2.
    The noise [..., 3n]: per bit the fade's real part, imaginary part, then
    the channel noise."""
    z = _normals(gen, noise, (*bits.shape[:-1], 3 * bits.shape[-1]),
                 bits.device).reshape(*bits.shape, 3)
    sigma = noise_sigma(ebn0_db, rate).to(bits.device)
    a, b = z[..., 0], z[..., 1]
    h = torch.sqrt((a * a + b * b) * 0.5)
    y = h * bpsk(bits) + sigma * z[..., 2]
    return h * llr_from_channel(y, sigma)


def hard_bpsk_awgn_llr(gen, bits, ebn0_db, rate, noise=None):
    """Hard-decision BPSK over AWGN: the sign of the soft LLR times
    log((1-p)/p) at p = Q(sqrt(2*R*Eb/N0))."""
    soft = awgn_llr(gen, bits, ebn0_db, rate, noise)
    ebn0 = 10.0 ** (torch.as_tensor(ebn0_db, dtype=torch.float32) / 10.0)
    p = q_function(torch.sqrt(2.0 * rate * ebn0))
    return torch.sign(soft) * _log_ratio(p).to(bits.device)


# ---------------------------------------------------------------------------
# Channel-spec strings
# ---------------------------------------------------------------------------


def parse_channel_spec(spec: str) -> dict:
    """'bpsk' | 'hard' | 'bsc:P' | 'qpsk' | 'qamM' -> build kwargs."""
    s = spec.strip().lower()
    if s in ("bpsk", "awgn", "bpsk-awgn"):
        return {"kind": "bpsk"}
    if s in ("hard", "bpsk-hard"):
        return {"kind": "hard"}
    if s in ("rayleigh", "bpsk-rayleigh"):
        return {"kind": "rayleigh"}
    if s.startswith("bsc:"):
        p = float(s[4:])
        if not 0.0 < p < 0.5:
            raise ValueError(f"BSC crossover must be in (0, 0.5), got {p}")
        return {"kind": "bsc", "p": p}
    if s.startswith("bec:"):
        eps = float(s[4:])
        if not 0.0 < eps < 1.0:
            raise ValueError(f"BEC erasure prob must be in (0, 1), got {eps}")
        return {"kind": "bec", "eps": eps}
    il = False
    if s.endswith(":il"):
        il, s = True, s[:-3]

    def _with_il(d):  # keep bare specs' dicts unchanged (il only if set)
        if il:
            d["il"] = True
        return d

    if s in _QAM_NAMES:
        return _with_il({"kind": "qam", "M": _QAM_NAMES[s]})
    if s in ("8psk", "psk8"):
        return _with_il({"kind": "psk", "M": 8})
    if s.startswith("apsk16") or s.startswith("apsk32"):
        M = int(s[4:6])
        parts = s[6:].split(":") if len(s) > 6 else []
        gs = []
        for p in parts:
            if not p:
                continue
            if p.startswith("g"):
                gs.append(float(p[1:]))
            elif p.startswith("r"):
                tab = APSK16_GAMMA if M == 16 else APSK32_GAMMA
                if p[1:] not in tab:
                    raise ValueError(
                        f"unknown APSK rate key {p!r}; one of "
                        f"{sorted(tab)}")
                g = tab[p[1:]]
                gs = list(g) if isinstance(g, tuple) else [g]
            else:
                raise ValueError(f"bad APSK option {p!r} in {spec!r}")
        if not gs:
            gs = [APSK16_GAMMA["34"]] if M == 16 else list(APSK32_GAMMA["34"])
        if M == 32 and len(gs) != 2:
            raise ValueError("apsk32 needs two ring ratios (':gG1:gG2')")
        gamma = gs[0] if M == 16 else (gs[0], gs[1])
        return _with_il({"kind": "apsk", "M": M, "gamma": gamma})
    raise ValueError(
        f"unknown channel spec {spec!r} — one of bpsk, hard, rayleigh, "
        f"bsc:P, bec:EPS, qpsk, 8psk, qam16, qam64, qam256, "
        f"apsk16[:rRATE|:gG][:il], apsk32[:rRATE|:gG:gG][:il]"
    )


class Channel:
    """A built channel: channel(gen, cw [..., n], ebn0_db, noise=None) ->
    llr f32 [..., n]. It takes `count` draws of kind `draws` ("normals" or
    "uniforms") a frame as noise [..., count], in the layout of the module
    docstring, or draws them from gen (`draw`)."""

    def __init__(self, fn: Callable, draws: str, count: int):
        if draws not in DRAWS:
            raise ValueError(f"draws must be one of {DRAWS}, got {draws!r}")
        self.fn = fn  # fn(cw, ebn0_db, noise) -> llr
        self.draws = draws
        self.count = count

    def draw(self, gen: torch.Generator, batch: int,
             device) -> torch.Tensor:
        """f32 [batch, count] of the channel's draws from gen."""
        if self.draws == "normals":
            return torch.randn((batch, self.count), generator=gen,
                               dtype=torch.float32, device=device)
        return torch.rand((batch, self.count), generator=gen,
                          dtype=torch.float32, device=device)

    def __call__(self, gen, cw, ebn0_db, noise=None) -> torch.Tensor:
        if noise is None:
            noise = self.draw(gen, math.prod(cw.shape[:-1]), cw.device
                              ).reshape(*cw.shape[:-1], self.count)
        return self.fn(cw, ebn0_db, noise)


def build_channel(code_spec, channel: str = "bpsk") -> Channel:
    """The Channel of a channel spec for a code. 'bpsk' is
    chan.awgn.make_channel (the code's punctured and shortened positions
    masked); 'hard', 'bsc', 'bec' and 'rayleigh' take the same masks. The
    symbol channels refuse a punctured or shortened code
    (NotImplementedError: untransmitted bits inside a symbol would change
    the symbol grid) and an n that b bits a symbol do not divide
    (ValueError)."""
    kw = parse_channel_spec(channel)
    kind = kw["kind"]
    n = code_spec.n
    if kind == "bpsk":
        awgn = make_channel(code_spec)
        return Channel(lambda cw, e, z: awgn(None, cw, e, z), "normals", n)

    punct = np.asarray(code_spec.punctured_cols, dtype=np.int64)
    short = np.asarray(code_spec.shortened_cols, dtype=np.int64)
    masked = bool(len(punct) or len(short))
    rate = code_spec.rate

    if kind in ("qam", "psk", "apsk"):
        M = kw["M"]
        b = int(round(math.log2(M)))
        if masked:
            raise NotImplementedError(
                f"{channel!r} on {code_spec.name!r}: symbol mapping over "
                f"punctured/shortened codes is not supported (the symbol "
                f"grid would straddle untransmitted bits) — use 'bpsk' "
                f"or 'hard'")
        if n % b:
            raise ValueError(
                f"{channel!r} needs n divisible by {b} bits/symbol; "
                f"{code_spec.name!r} has n={n}")
        if kind == "qam":
            def tx(cw, e, z):
                return qam_awgn_llr(None, cw, e, rate, M, z)
        elif kind == "psk":
            def tx(cw, e, z):
                return psk_awgn_llr(None, cw, e, rate, M, z)
        else:
            gamma = kw["gamma"]

            def tx(cw, e, z):
                return apsk_awgn_llr(None, cw, e, rate, M, gamma, z)
        if kw.get("il"):
            def tx_il(cw, e, z, _tx=tx):
                return deinterleave_llr(_tx(interleave_tx(cw, b), e, z), b)
            return Channel(tx_il, "normals", 2 * n // b)
        return Channel(tx, "normals", 2 * n // b)

    keep_np = np.ones(n, dtype=np.float32)
    add_np = np.zeros(n, dtype=np.float32)
    keep_np[punct] = 0.0
    keep_np[short] = 0.0
    add_np[short] = _ERASURE_KNOWN_LLR

    def mask(llr):
        if not masked:
            return llr
        keep = torch.as_tensor(keep_np, device=llr.device)
        add = torch.as_tensor(add_np, device=llr.device)
        return llr * keep + add

    if kind == "bsc":
        p = kw["p"]
        return Channel(lambda cw, e, z: mask(bsc_llr(None, cw, p, z)),
                       "uniforms", n)
    if kind == "bec":
        eps = kw["eps"]
        return Channel(lambda cw, e, z: mask(bec_llr(None, cw, eps, z)),
                       "uniforms", n)
    if kind == "rayleigh":
        return Channel(
            lambda cw, e, z: mask(rayleigh_bpsk_llr(None, cw, e, rate, z)),
            "normals", 3 * n)
    return Channel(
        lambda cw, e, z: mask(hard_bpsk_awgn_llr(None, cw, e, rate, z)),
        "normals", n)
