"""Message precision of the layered decoders: the fixed-point grid of
`layered/q:BITS:STEP` (port of ecc_ldpc_tpu/decode/xla/layered.py::
quantize) and the bf16 round trip of the TPU kernel's message storage
(ecc_ldpc_tpu/decode/pallas/layered_qc.py, msg_dtype = llr_dtype = bf16).

A precision is None (f32), ("bf16",) or ("q", bits, step). Where each
rounding applies in a layered decode is decode/layered_qc.py's contract:
the LLRs loaded into the posteriors, the messages stored, and (by mode and
graph form) the message added to the posteriors. The CUDA kernels do the
same roundings in the same op order (csrc/cluster_tile.cuh, ct::Prec).
"""
from __future__ import annotations

import torch

BF16 = ("bf16",)


def quant_limit(bits: int) -> float:
    """The largest level of a `bits`-bit symmetric grid: 2^(bits-1) - 1."""
    return float((1 << (bits - 1)) - 1)


def quantize(x: torch.Tensor, bits: int, step: float) -> torch.Tensor:
    """Symmetric uniform mid-tread quantizer: round(x / step) (half to
    even) clipped to +-(2^(bits-1) - 1) levels, times step, with x's sign
    bit kept (so -0.4 * step gives -0.0, as the JAX package's quantize
    does). The step is an f32 tensor on x's device, so x / step is a true
    division on the card too (PyTorch turns a division by a host scalar
    into a multiply by its reciprocal on CUDA)."""
    lim = quant_limit(bits)
    s = torch.tensor(step, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / s), -lim, lim) * s
    return torch.copysign(q, x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_precision(precision) -> tuple | None:
    """The precision as a tuple, or None; raises on anything else."""
    if precision is None:
        return None
    precision = tuple(precision)
    if precision == BF16:
        return precision
    if len(precision) == 3 and precision[0] == "q":
        bits, step = int(precision[1]), float(precision[2])
        if not 2 <= bits <= 16:
            raise ValueError(f"quantizer bits {bits} out of range 2-16")
        if not step > 0:
            raise ValueError(f"quantizer step {step} must be positive")
        return ("q", bits, step)
    raise ValueError(f"precision must be None, ('bf16',) or ('q', bits, "
                     f"step), got {precision!r}")


def rounder(precision):
    """The rounding of `precision` as a function of a tensor (None: f32)."""
    if precision is None:
        return None
    if precision == BF16:
        return round_bf16
    _, bits, step = precision
    return lambda x: quantize(x, bits, step)


def describe(precision) -> str:
    """'f32', 'bf16' or 'q:BITS:STEP' (the spec's own form)."""
    if precision is None:
        return "f32"
    if precision == BF16:
        return "bf16"
    return f"q:{precision[1]}:{precision[2]:g}"
