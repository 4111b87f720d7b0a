"""Density-evolution BP thresholds (protograph Gaussian approximation).

A verbatim copy of ecc_ldpc_tpu/codes/threshold.py (NumPy only; the
port imports nothing of the JAX package).

Analysis tool the reference lacks: computes the asymptotic BP decoding
threshold (the Eb/N0 below which message-passing cannot converge as
n -> infinity) for any registered code, directly from its protograph.
This grounds the framework's Monte-Carlo waterfalls in theory — a
measured waterfall onset should sit a few tenths of a dB above the DE
threshold (finite-length gap), which makes this an automated sanity
check on every shipped/surrogate table (SURVEY.md §7.2 item 4) and a
design tool for new codes.

Method: protograph density evolution under the Gaussian approximation
(one mean per directed edge type; message ~ N(mu, 2mu)), with Chung's
phi(x) = 1 - E[tanh(m/2)] approximation [Chung, Richardson, Urbanke
2001]. For QC codes the edge types are the base-matrix cells (shifts do
not enter DE — only connectivity), so DVB-S2 n=64800 costs the same as
a toy code; unstructured codes use their full graph as a Z=1
protograph (exact connectivity, still an ensemble statement).

Punctured/shortened handling: fully punctured protograph columns get
channel mean 0; partial coverage (possible for 5G NR filler blocks)
uses the transmitted fraction as a mixture weight on the channel mean —
a documented approximation, fine for threshold-level accuracy.

Host-side NumPy throughout (this is setup/analysis, not the hot path).
Known anchors: (3,6)-regular threshold ~1.11 dB Eb/N0 (sigma* ~0.881);
GA-DE is accurate to a few hundredths of a dB for these profiles.
"""
from __future__ import annotations

import math

import numpy as np

# Chung et al.'s phi approximation constants. The branch switch sits at
# the two approximations' crossing (~14.39) rather than the textbook
# x=10: at 10 the branches disagree by ~2% and the jump breaks phi's
# monotonicity (which phi_inv's bisection and threshold bisection rely
# on); at the crossing the seam is exact.
_A, _B, _C = -0.4527, 0.86, 0.0218
_X_SWITCH = 14.394352942168455


def phi(x: np.ndarray) -> np.ndarray:
    """phi(x) = 1 - E[tanh(m/2)], m ~ N(x, 2x); decreasing, phi(0)=1."""
    x = np.asarray(x, dtype=np.float64)
    small = np.exp(_A * np.power(np.maximum(x, 1e-300), _B) + _C)
    # the big branch is discarded by the where() for x < 10 but still
    # evaluated there — clamp its argument so tiny x can't overflow
    xb = np.maximum(x, _X_SWITCH)
    big = np.sqrt(np.pi / xb) * np.exp(-xb / 4.0) * (1.0 - 10.0 / (7.0 * xb))
    out = np.where(x < _X_SWITCH, small, big)
    return np.where(x <= 0.0, 1.0, np.minimum(out, 1.0))


def phi_inv(y: np.ndarray) -> np.ndarray:
    """Inverse of phi by closed form (small x) / vectorized bisection."""
    y = np.asarray(y, dtype=np.float64)
    y = np.clip(y, 1e-300, 1.0)
    # closed-form inverse of the small-x branch
    x_small = np.power(np.maximum(_C - np.log(y), 0.0) / (-_A), 1.0 / _B)
    need_big = x_small >= _X_SWITCH
    if not np.any(need_big):
        return x_small
    lo = np.full(y.shape, _X_SWITCH)
    hi = np.full(y.shape, 4000.0)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_big = phi(mid) > y  # phi decreasing: phi(mid)>y => mid < x
        lo = np.where(too_big, mid, lo)
        hi = np.where(too_big, hi, mid)
    return np.where(need_big, 0.5 * (lo + hi), x_small)


def protograph(spec):
    """(rows, cols, n_rows, n_cols, tx_frac, short_frac) edge arrays.

    QC codes use the base matrix (one edge type per cell, multiplicity
    preserved); unstructured codes use the full H (Z=1 protograph).
    tx_frac[c] is the transmitted fraction of column c's variables,
    short_frac[c] the known-zero (filler) fraction.
    """
    punct = np.zeros(spec.n, dtype=bool)
    short = np.zeros(spec.n, dtype=bool)
    punct[np.asarray(spec.punctured_cols, dtype=np.int64)] = True
    short[np.asarray(spec.shortened_cols, dtype=np.int64)] = True

    if spec.qc is not None:
        Z = spec.qc.Z
        br, bc, _ = spec.qc.block_edges()
        rows, cols = list(br), list(bc)
        n_rows, n_cols = spec.qc.mb, spec.qc.nb
        tx = 1.0 - (punct.reshape(n_cols, Z).mean(axis=1)
                    + short.reshape(n_cols, Z).mean(axis=1))
        sh = short.reshape(n_cols, Z).mean(axis=1)
    else:
        rows, cols = [], []
        for i, rc in enumerate(spec.row_cols):
            for c in rc:
                rows.append(i)
                cols.append(int(c))
        n_rows, n_cols = spec.m, spec.n
        tx = 1.0 - (punct.astype(np.float64) + short.astype(np.float64))
        sh = short.astype(np.float64)
    return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            n_rows, n_cols, tx, sh)


_SHORT_LLR_MEAN = 120.0  # stands in for the +inf mean of known bits
_SUCCESS_MEAN = 500.0  # posterior mean at which DE is declared converged


def de_converges(spec_graph, ebn0_db: float, rate: float,
                 max_iters: int = 2000) -> bool:
    """Run protograph GA-DE at one operating point; True iff means diverge
    to +infinity (decoding succeeds asymptotically)."""
    rows, cols, n_rows, n_cols, tx, sh = spec_graph
    mu_ch_base = 4.0 * rate * 10.0 ** (ebn0_db / 10.0)  # E[2y/sigma^2]
    mu_ch = tx * mu_ch_base + sh * _SHORT_LLR_MEAN  # per-column mixture

    E = len(rows)
    mu_cv = np.zeros(E)  # check -> variable means, per edge type
    for _ in range(max_iters):
        # VN update: mu_vc[e] = mu_ch[c] + sum_{e' at c, e' != e} mu_cv[e']
        colsum = np.zeros(n_cols)
        np.add.at(colsum, cols, mu_cv)
        mu_vc = mu_ch[cols] + colsum[cols] - mu_cv
        post_min = float(np.min(mu_ch + colsum)) if n_cols else np.inf
        if post_min > _SUCCESS_MEAN:
            return True
        # CN update in log(1 - phi) space for a stable leave-one-out
        s = np.log1p(-np.minimum(phi(mu_vc), 1.0 - 1e-15))
        rowsum = np.zeros(n_rows)
        np.add.at(rowsum, rows, s)
        loo = rowsum[rows] - s
        prev = mu_cv
        mu_cv = phi_inv(1.0 - np.exp(np.minimum(loo, 0.0)))
        # fixed-point detection must look at the WHOLE message vector: the
        # min posterior alone can plateau transiently mid-climb (phi_inv's
        # saturation quantizes converged edges while others still move)
        if float(np.max(np.abs(mu_cv - prev))) < 1e-10:
            return post_min > _SUCCESS_MEAN
    return False


def bec_de_converges(spec_graph, eps: float, max_iters: int = 10000) -> bool:
    """Protograph density evolution over the BEC — EXACT, no Gaussian
    approximation: track per-edge erasure probabilities.

      VN: x_e = eps_c * prod_{e' at c, e' != e} y_e'
      CN: y_e = 1 - prod_{e' at r, e' != e} (1 - x_e')

    Punctured columns have eps_c = 1 (never observed), shortened eps_c = 0.

    Success criterion: at the fixed point, the POSTERIOR erasure
    probability of every degree>=2 column vanishes. Degree-1 columns
    (e.g. 5G NR extension parities) are excluded — their outgoing message
    never drops below eps by construction (no second check to resolve
    them), which leaves O(eps^k) floors on every posterior; decodability
    of the code is the systematic/core part's erasure going to ~0, the
    standard convention for such protographs. This exact recursion doubles
    as a validation anchor for the Gaussian-approximate AWGN DE: the
    (3,6) ensemble's BEC threshold is exactly ~0.4294."""
    rows, cols, n_rows, n_cols, tx, sh = spec_graph
    # per-column erasure prob: transmitted fraction sees eps, punctured
    # fraction is always erased, shortened fraction never
    eps_col = tx * eps + (1.0 - tx - sh) * 1.0 + sh * 0.0
    E = len(rows)
    col_deg = np.zeros(n_cols, np.int64)
    np.add.at(col_deg, cols, 1)
    # VN->CN erasure probs; the all-erased start is the monotone-from-above
    # initialization, so the recursion converges to the worst fixed point
    x = np.full(E, 1.0)
    for _ in range(max_iters):
        # CN update in log(1-x) space for stable leave-one-out products
        # (clamp strictly below 1: 1.0 - 1e-300 rounds to exactly 1.0)
        s = np.log1p(-np.minimum(x, 1.0 - 1e-15))
        rowsum = np.zeros(n_rows)
        np.add.at(rowsum, rows, s)
        y = 1.0 - np.exp(rowsum[rows] - s)
        # VN update in log(y) space; posterior = eps_c * prod over ALL edges
        t = np.log(np.maximum(y, 1e-300))
        colsum = np.zeros(n_cols)
        np.add.at(colsum, cols, t)
        x_new = eps_col[cols] * np.exp(colsum[cols] - t)
        post = eps_col * np.exp(colsum)
        if float(np.max(post[col_deg >= 2], initial=0.0)) < 1e-9:
            return True
        if float(np.max(np.abs(x_new - x))) < 1e-14:
            # finite fixed point: decide on the deep columns' posteriors
            return float(np.max(post[col_deg >= 2], initial=0.0)) < 1e-9
        x = x_new
    return False


def bec_threshold(spec, *, tol: float = 1e-4) -> float:
    """Exact BP threshold over the BEC: the largest erasure probability
    the ensemble corrects as n -> infinity. Bisection on eps in (0, 1)."""
    g = protograph(spec)
    lo, hi = 0.0, 1.0  # eps=0 always succeeds, eps=1 never
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if bec_de_converges(g, mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def de_threshold_ebn0(spec, *, lo_db: float = -2.0, hi_db: float = 8.0,
                      tol_db: float = 0.01, max_iters: int = 2000) -> float:
    """BP threshold in Eb/N0 (dB) for BPSK/AWGN by bisection over GA-DE.

    Eb/N0 is referenced to the code's transmitted rate (spec.rate), like
    the simulator's channel. Raises if the code fails even at hi_db."""
    g = protograph(spec)
    rate = spec.rate
    if not de_converges(g, hi_db, rate, max_iters):
        raise RuntimeError(
            f"DE does not converge for {spec.name!r} even at {hi_db} dB — "
            f"the protograph has a structural defect"
        )
    lo, hi = lo_db, hi_db
    if de_converges(g, lo, rate, max_iters):
        return lo  # threshold below the search window
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        if de_converges(g, mid, rate, max_iters):
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)
