"""BPSK over AWGN, and the LLR front-end (port of ecc_ldpc_tpu/chan/awgn.py).

Conventions:
  bit 0 -> +1, bit 1 -> -1          (BPSK map x = 1 - 2b)
  sigma^2 = 1 / (2 * R * 10^(EbN0_dB/10))   noise variance per dimension
  LLR = 2*y / sigma^2               (positive LLR => bit 0 more likely)

Noise comes from an explicit torch.Generator on the bits' device; it cannot
match JAX's threefry stream, so bit-level parity tests feed both packages
the same LLR arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} -> {+1.0, -1.0}."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def noise_sigma(ebn0_db, rate) -> torch.Tensor:
    """AWGN sigma (f32 0-dim tensor) for a given Eb/N0 (dB) and code rate."""
    ebn0 = 10.0 ** (torch.as_tensor(ebn0_db, dtype=torch.float32) / 10.0)
    return torch.rsqrt(2.0 * rate * ebn0)


def llr_from_channel(y: torch.Tensor, sigma) -> torch.Tensor:
    return 2.0 * y / (sigma * sigma)


def awgn_llr(gen: torch.Generator, bits: torch.Tensor, ebn0_db, rate
             ) -> torch.Tensor:
    """Transmit `bits` over BPSK/AWGN; return channel LLRs (same shape)."""
    sigma = noise_sigma(ebn0_db, rate).to(bits.device)
    noise = torch.randn(bits.shape, generator=gen, dtype=torch.float32,
                        device=bits.device)
    return llr_from_channel(bpsk(bits) + sigma * noise, sigma)


def channel_masks(spec):
    """(keep, add) f32 [n] NumPy masks: punctured bits are never
    transmitted (LLR 0 at the receiver), shortened/filler bits are known
    zeros (LLR 60)."""
    keep = np.ones(spec.n, dtype=np.float32)
    add = np.zeros(spec.n, dtype=np.float32)
    punct = np.asarray(spec.punctured_cols, dtype=np.int64)
    short = np.asarray(spec.shortened_cols, dtype=np.int64)
    keep[punct] = 0.0
    keep[short] = 0.0
    add[short] = 60.0
    return keep, add


def make_channel(spec):
    """Channel function honoring a code's punctured/shortened positions.
    Returns f(gen, cw, ebn0_db) -> llr. Eb/N0 is referenced to spec.rate =
    k / transmitted bits."""
    keep_np, add_np = channel_masks(spec)
    rate = spec.rate
    masked = bool(len(spec.punctured_cols) or len(spec.shortened_cols))

    def channel(gen, cw, ebn0_db):
        llr = awgn_llr(gen, cw, ebn0_db, rate)
        if masked:
            keep = torch.as_tensor(keep_np, device=cw.device)
            add = torch.as_tensor(add_np, device=cw.device)
            llr = llr * keep + add
        return llr

    return channel
