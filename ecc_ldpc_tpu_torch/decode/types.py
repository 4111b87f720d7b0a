"""Decoder result container (port of ecc_ldpc_tpu/decode/types.py)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """Batched decode output.

    bits: uint8 [B, n] hard decisions for the full codeword.
    ok: bool [B] — True iff the syndrome of `bits` is zero.
    iterations: int32 [B] — iterations used per codeword (with early
      termination, where the exact stop rule first held; capped at
      max_iters).
    """

    bits: torch.Tensor
    ok: torch.Tensor
    iterations: torch.Tensor
