"""Check-node rules of flooding BP over the padded [m, dc, B] message
layout (port of ecc_ldpc_tpu/decode/xla/cn_ops.py:26-98).

Each rule maps variable-to-check messages V to check-to-variable messages
C with the leave-one-out semantics of BP along `dim` (1 for the padded
check view of decode/flooding.py; 0 for the [d, Z, B] rows of
decode/flooding_qc.py, which have no padding). `mask` is bool [m, dc, 1]
or None (every slot real); padded slots produce 0.

Signs come from (v < 0), so -0.0 counts as positive, and a message is
(sign product * own sign) * magnitude in that order. Sums run in slot
order, so the CUDA kernels (csrc/flooding.cu, csrc/flooding_qc.cu) can
repeat them float for float.
"""
from __future__ import annotations

import torch

_MAG_CAP = 1e12           # keeps padded-slot inf out of arithmetic; caps degree 1
_TANH_CLIP = 1.0 - 1e-7   # tanh(x/2) saturates to 1.0 near x=18
_MINSTAR_IDENTITY = 1e9   # box-plus identity (a padded slot's value)
CN_KINDS = ("minsum", "spa", "minstar")


def _slots(x: torch.Tensor, dim: int):
    return [x.select(dim, j) for j in range(x.shape[dim])]


def _signs(V, mask):
    neg = V < 0
    if mask is not None:
        neg = neg & mask
    return torch.where(neg, -1.0, 1.0)


def _magnitudes(V, mask):
    a = V.abs()
    return a if mask is None else torch.where(mask, a, torch.inf)


def _masked(C, mask):
    return C if mask is None else torch.where(mask, C, 0.0)


def cn_minsum(V, mask=None, *, alpha: float = 1.0, beta: float = 0.0,
              dim: int = 1):
    """Two-min + sign-product update; the first minimum's slot gets the
    second minimum, every other slot the minimum (so with a tied minimum
    every slot gets min1); then min(., 1e12) and max(alpha*m - beta, 0)."""
    s = _signs(V, mask)
    a = _magnitudes(V, mask)
    sgn_prod = s.prod(dim, keepdim=True)
    min1 = a.amin(dim, keepdim=True)
    idx = a.argmin(dim, keepdim=True)  # the first minimum
    shape = [1] * V.dim()
    shape[dim] = V.shape[dim]
    onehot = torch.arange(V.shape[dim], device=V.device).view(shape) == idx
    min2 = torch.where(onehot, torch.inf, a).amin(dim, keepdim=True)
    mag = torch.where(onehot, min2, min1)
    mag = torch.clamp_max(mag, _MAG_CAP)
    mag = torch.clamp_min(alpha * mag - beta, 0.0)
    return _masked((sgn_prod * s) * mag, mask)


def cn_spa(V, mask=None, *, dim: int = 1):
    """Exact sum-product (tanh rule): leave-one-out through a log|tanh| sum
    accumulated in slot order, magnitude 2*atanh(min(exp(.), 1 - 1e-7))."""
    s = _signs(V, mask)
    a = _magnitudes(V, mask)
    lt = torch.log(torch.tanh(torch.clamp(a, 1e-10, 40.0) * 0.5))
    lt = _masked(lt, mask)
    slots = _slots(lt, dim)
    acc = slots[0]
    for x in slots[1:]:
        acc = acc + x
    loo = acc.unsqueeze(dim) - lt
    t = torch.clamp_max(torch.exp(loo), _TANH_CLIP)
    mag = 2.0 * torch.atanh(t)
    sgn_prod = s.prod(dim, keepdim=True)
    return _masked((sgn_prod * s) * mag, mask)


def boxplus(x, y):
    """Exact pairwise box-plus: sign(x)sign(y)min(|x|,|y|) +
    (log1p(e^-|x+y|) - log1p(e^-|x-y|)), signs by x < 0."""
    mag = torch.minimum(x.abs(), y.abs())
    sgn = torch.where((x < 0) ^ (y < 0), -1.0, 1.0)
    corr = (torch.log1p(torch.exp(-(x + y).abs()))
            - torch.log1p(torch.exp(-(x - y).abs())))
    return sgn * mag + corr


def cn_minstar(V, mask=None, *, dim: int = 1):
    """Exact sum-product by box-plus forward/backward scans over every
    slot, padded slots holding the identity 1e9: slot j gets fwd[j-1] ⊞
    bwd[j+1]; a degree-1 row sends 1e9; clipped to ±1e12."""
    Vm = V if mask is None else torch.where(mask, V, _MINSTAR_IDENTITY)
    v = _slots(Vm, dim)
    dc = len(v)
    if dc == 1:
        return _masked(torch.full_like(Vm, _MINSTAR_IDENTITY), mask)
    fwd = [v[0]]
    for j in range(1, dc - 1):
        fwd.append(boxplus(fwd[-1], v[j]))
    outs = [None] * dc
    outs[dc - 1] = fwd[dc - 2]
    bwd = v[dc - 1]
    for j in range(dc - 2, 0, -1):
        outs[j] = boxplus(fwd[j - 1], bwd)
        bwd = boxplus(bwd, v[j])
    outs[0] = bwd
    C = torch.clamp(torch.stack(outs, dim), -_MAG_CAP, _MAG_CAP)
    return _masked(C, mask)


def get_rule(kind: str, alpha: float = 1.0, beta: float = 0.0):
    """rule(V, mask, dim) -> C for flooding kind `kind`."""
    if kind == "minsum":
        return lambda V, mask, dim: cn_minsum(V, mask, alpha=alpha, beta=beta,
                                              dim=dim)
    if kind == "spa":
        return lambda V, mask, dim: cn_spa(V, mask, dim=dim)
    if kind == "minstar":
        return lambda V, mask, dim: cn_minstar(V, mask, dim=dim)
    raise KeyError(f"flooding kind must be one of {CN_KINDS}, got {kind!r}")
