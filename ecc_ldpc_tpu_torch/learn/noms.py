"""Learned per-iteration normalized/offset min-sum (port of
ecc_ldpc_tpu/learn/noms.py).

Layered min-sum unrolled in PyTorch is a differentiable computation, so the
per-iteration normalization alpha_t and offset beta_t are parameters:
train them by gradient descent through the decoder (torch.autograd,
torch.optim.Adam on a soft-BER loss). The trained schedule decodes through
the layered kernel (decode/api.make_decoder's per-iteration alpha/beta, K1a
on the card) or as `layered/sched:` for a shipped one.

`unrolled_posteriors` is the training twin of that decoder: the same sweep
order and check rule with count signs (v < 0), but it returns every
iteration's posteriors for the multi-loss. Its gradients follow JAX's:
torch.amin splits a tied minimum's gradient evenly, torch.maximum and
torch.minimum against a tensor give each side half on a tie, and the loss's
softplus is logaddexp(x, 0) (F.softplus turns linear above 20).

The twin is torch tensor ops (the JAX twin is XLA, not Pallas). Each
layer's circulant rolls are one precomputed gather index, a layer's
messages one [d, Z, B] tensor, and each iteration one
torch.utils.checkpoint region, as jax.checkpoint in the reference's
lax.scan: the backward pass keeps the iteration boundaries and recomputes a
layer's internals.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..graph.qc import QCGraph, var_index
from .schedules import NomsParams, load_schedule  # noqa: F401 (re-export)

_MAG_CAP = 1e12
# the decoder region the parameters are clipped to after every step
ALPHA_MIN, ALPHA_MAX = 0.5, 1.25

def _cn_minsum_soft(V, alpha, beta, cap, zero):
    """Leave-one-out two-min check update over axis 0 of V [d, Z, B] with
    count signs, magnitude max(alpha * min(m, cap) - beta, 0); `cap` and
    `zero` are 0-dim tensors on V's device (JAX's tie rules, see the
    module docstring)."""
    neg = V < 0
    flip = (neg.sum(0, keepdim=True) % 2 == 1) ^ neg
    a = V.abs()
    min1 = torch.amin(a, 0, keepdim=True)
    is_min = a == min1
    count_min = is_min.sum(0, keepdim=True)
    min2 = torch.amin(a.masked_fill(is_min, torch.inf), 0, keepdim=True)
    mag = torch.where(is_min & (count_min == 1), min2, min1)
    mag = torch.maximum(alpha * torch.minimum(mag, cap) - beta, zero)
    return torch.where(flip, -mag, mag)


def _twin_layers(graph: QCGraph, device) -> list:
    """Per layer in layer_order: (gather index long [d*Z], d, source rows
    long or None, destination rows long or None). Check z of slot j reads
    variable idx[j*Z + z]. Where a layer repeats a block-column, only the
    last slot of each column writes its posteriors, as the reference's
    edge-by-edge `total.at[col].set` leaves them: the rows of those slots
    (source) and their variables (destination)."""
    Z = graph.Z
    z = np.arange(Z)
    layers = []
    for i in graph.layer_order:
        edges = graph.layer_edges(i)
        idx = np.concatenate([col * Z + var_index(z, s, Z, graph.perm)
                              for _, col, s in edges])
        last = sorted({col: j for j, (_, col, _) in enumerate(edges)}.values())
        src = dst = None
        if len(last) < len(edges):
            rows = np.concatenate([np.arange(j * Z, (j + 1) * Z) for j in last])
            src = torch.as_tensor(rows, device=device)
            dst = torch.as_tensor(idx[rows], device=device)
        layers.append((torch.as_tensor(idx, device=device), len(edges),
                       src, dst))
    return layers


def unrolled_posteriors(graph: QCGraph, llr: torch.Tensor, alphas, betas,
                        *, remat: bool = True) -> torch.Tensor:
    """Differentiable unrolled layered decode: llr f32 [B, n] -> posteriors
    f32 [T, B, n] (iteration t's post-sweep totals), on llr's device; T is
    len(alphas). alphas/betas are f32 tensors [T] (gradients flow to
    them) or arrays. Mirrors the layered decoder's sweep with count signs.

    With remat=True each iteration is one checkpoint region, so the
    backward pass stores the iteration boundaries (posteriors [n, B] and
    messages) and recomputes each layer."""
    if not isinstance(graph, QCGraph):
        raise TypeError("the twin needs the port's QCGraph "
                        "(graph.qc.compile_qc_graph)")
    dev = llr.device
    B, Z = llr.shape[0], graph.Z
    key = ("noms", str(dev))
    if key not in graph.device_cache:
        graph.device_cache[key] = _twin_layers(graph, dev)
    layers = graph.device_cache[key]
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=dev)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    cap = torch.tensor(_MAG_CAP, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def one_iter(total, a_t, b_t, *C):
        total = total.clone()
        C_new = []
        for (idx, d, src, dst), c in zip(layers, C):
            V = total.index_select(0, idx).view(d, Z, B) - c
            Cnew = _cn_minsum_soft(V, a_t, b_t, cap, zero)
            new = (V + Cnew).view(d * Z, B)
            if src is None:
                total.index_copy_(0, idx, new)
            else:
                total.index_copy_(0, dst, new.index_select(0, src))
            C_new.append(Cnew)
        return (total, *C_new)

    total = llr.to(torch.float32).t().contiguous()  # [n, B]
    C = [torch.zeros((d, Z, B), dtype=torch.float32, device=dev)
         for _, d, _, _ in layers]
    outs = []
    for t in range(alphas.shape[0]):
        args = (total, alphas[t], betas[t], *C)
        total, *C = (checkpoint(one_iter, *args, use_reentrant=False)
                     if remat else one_iter(*args))
        outs.append(total.t())
    return torch.stack(outs)


def soft_ber_loss(posteriors: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """Multi-loss over iterations: mean softplus(-(1-2c)·total), the binary
    cross-entropy of P(bit=1) = sigmoid(-total) against the transmitted
    codeword, over every unrolled iteration so early ones get gradient
    too (the NOMS paper's multiloss); softplus as JAX's logaddexp(x, 0)."""
    sgn = 1.0 - 2.0 * cw.to(torch.float32)  # [B, n]
    x = -sgn[None] * posteriors
    return torch.mean(torch.logaddexp(x, torch.zeros_like(x)))


def training_batch(gen: torch.Generator, enc, k: int, rate: float,
                   batch: int, ebn0_range: tuple, device) -> tuple:
    """One training step's (Eb/N0 in dB, codewords uint8 [batch, n], LLRs
    f32 [batch, n]) from gen: a uniform Eb/N0 in the band, then the
    message bits, the encoder and BPSK over AWGN (chan/awgn.awgn_llr)."""
    from ..chan.awgn import awgn_llr

    lo, hi = ebn0_range
    u = torch.rand((), generator=gen, device=device)
    ebn0 = float(lo + (hi - lo) * u.item())
    msg = torch.randint(0, 2, (batch, k), generator=gen, device=device,
                        dtype=torch.uint8)
    cw = enc(msg)
    return ebn0, cw, awgn_llr(gen, cw, ebn0, rate)


def train_noms(
    code: str = "80211n/648/12",
    *,
    iters: int = 10,
    ebn0_range: tuple = (1.0, 3.0),
    steps: int = 200,
    batch: int = 64,
    lr: float = 2e-2,
    seed: int = 0,
    learn_alpha: bool = True,
    learn_beta: bool = True,
    init_alpha: float = 1.0,
    init_beta: float = 0.0,
    device="cuda",
    progress=None,
):
    """Train per-iteration (alpha_t, beta_t) for `code`'s layered min-sum
    on `device` (default the card; device="cpu" runs on the host).

    Returns (NomsParams, losses [steps]). Adam (torch.optim.Adam, the
    defaults of optax.adam); after every step alpha is clipped to
    [0.5, 1.25] and beta to >= 0. A frozen parameter (learn_alpha or
    learn_beta False) gets a zero gradient, as in the reference. The
    batches come from one torch.Generator seeded with `seed`
    (training_batch). progress(step, loss), when given, is called after
    every step."""
    from ..codes.registry import get_code
    from ..device import resolve_device
    from ..encode.structured import build_encoder
    from ..graph.qc import compile_qc_graph

    dev = resolve_device(device)
    spec = get_code(code)
    graph = compile_qc_graph(spec)
    enc = build_encoder(spec)
    alphas = torch.full((iters,), float(init_alpha), dtype=torch.float32,
                        device=dev, requires_grad=True)
    betas = torch.full((iters,), float(init_beta), dtype=torch.float32,
                       device=dev, requires_grad=True)
    opt = torch.optim.Adam([alphas, betas], lr=lr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    losses = []
    for s in range(steps):
        _, cw, llr = training_batch(gen, enc, spec.k, spec.rate, batch,
                                    ebn0_range, dev)
        opt.zero_grad()
        loss = soft_ber_loss(unrolled_posteriors(graph, llr, alphas, betas),
                             cw)
        loss.backward()
        for p, learn in ((alphas, learn_alpha), (betas, learn_beta)):
            if not learn:
                p.grad.zero_()
        opt.step()
        with torch.no_grad():
            alphas.clamp_(ALPHA_MIN, ALPHA_MAX)
            betas.clamp_(min=0.0)
        losses.append(loss.item())
        if progress:
            progress(s, losses[-1])
    params = NomsParams(alphas=alphas.detach().cpu().numpy(),
                        betas=betas.detach().cpu().numpy())
    return params, np.asarray(losses)


def list_schedules() -> list:
    """Names of the shipped schedules (learn/schedules/*.json)."""
    p = pathlib.Path(__file__).parent / "schedules"
    return sorted(f.stem for f in p.glob("*.json"))
