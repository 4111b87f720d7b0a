"""General puncturing/shortening combinators (SURVEY.md §2.1 R5).

Port of ecc_ldpc_tpu/codes/puncture.py: the transforms are verbatim;
ShortenedEncoder pads with torch on the device of its input.

The reference's ECC.Puncture drops codeword positions to raise the rate of
any code. Here the same capability is a CodeSpec -> CodeSpec transform:
punctured positions are never transmitted (receiver LLR 0), shortened
positions are known zeros at the transmitter (receiver LLR +inf). The
channel (chan.make_channel) and the sim pipelines honor both; decoders are
untouched (they always see full-length LLR vectors).

Registry syntax: "punct/<inner-spec-with-~-for-/>/<positions>" where
positions is "100:200" (range) or "7,19,23". Example:
  punct/80211n~648~12/600:648   -- puncture the last 48 bits of the code.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .spec import CodeSpec


def puncture(spec: CodeSpec, cols) -> CodeSpec:
    """Mark codeword positions as never-transmitted. Raises the rate to
    k / (n_tx). Positions must not overlap shortened columns."""
    cols = tuple(int(c) for c in cols)
    if any(not 0 <= c < spec.n for c in cols):
        raise ValueError("puncture position out of range")
    if set(cols) & set(spec.shortened_cols):
        raise ValueError("cannot puncture a shortened position")
    merged = tuple(sorted(set(spec.punctured_cols) | set(cols)))
    n_tx = spec.n - len(merged) - len(spec.shortened_cols)
    if n_tx <= spec.k:
        raise ValueError(
            f"puncturing {len(merged)} positions leaves {n_tx} transmitted "
            f"bits for k={spec.k} message bits (rate >= 1)"
        )
    return dataclasses.replace(
        spec, name=f"{spec.name}.p{len(cols)}", punctured_cols=merged
    )


def shorten(spec: CodeSpec, num_bits: int) -> CodeSpec:
    """Shorten the code by `num_bits`: the TAIL of the message section
    becomes known zeros (the 5G NR filler convention, generalized). The
    message length k shrinks accordingly and the rate drops. Encoders for
    shortened codes are built by encode.structured.build_encoder, which
    wraps the mother code's encoder with zero-padding
    (ShortenedEncoder below)."""
    if not 0 < num_bits < spec.k:
        raise ValueError(f"can shorten 1..{spec.k - 1} bits, got {num_bits}")
    k_new = spec.k - num_bits
    cols = tuple(range(k_new, spec.k))
    if set(cols) & set(spec.punctured_cols):
        raise ValueError("cannot shorten a punctured position")
    merged = tuple(sorted(set(spec.shortened_cols) | set(cols)))
    return dataclasses.replace(
        spec, name=f"{spec.name}.s{num_bits}", shortened_cols=merged, k=k_new
    )


class ShortenedEncoder:
    """Wrap a mother-code encoder for a tail-shortened spec: the message is
    k bits; the shortened tail is zero-filled before encoding."""

    def __init__(self, inner, spec: CodeSpec):
        self.inner = inner
        self.k = spec.k
        self.k_full = inner.k
        self.n = inner.n

    def __call__(self, msg_bits):
        import torch

        pad = torch.zeros(msg_bits.shape[:-1] + (self.k_full - self.k,),
                          dtype=msg_bits.dtype, device=msg_bits.device)
        return self.inner(torch.cat([msg_bits, pad], dim=-1))

    def extract_message(self, codeword_bits):
        return codeword_bits[..., : self.k]

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        pad = np.zeros(
            msg_bits.shape[:-1] + (self.k_full - self.k,), msg_bits.dtype
        )
        return self.inner.encode_numpy(np.concatenate([msg_bits, pad], axis=-1))


def parse_positions(text: str, n: int):
    if ":" in text:
        lo, hi = (int(x) for x in text.split(":"))
        return range(lo, min(hi, n))
    return [int(x) for x in text.split(",")]
