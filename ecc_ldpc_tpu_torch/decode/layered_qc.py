"""Layered decoding on circulant QC graphs: the plain PyTorch version and
the wrappers of its three CUDA kernels (csrc/layered_qc.cu, min-sum;
csrc/layered_exact.cu, exact BP; csrc/layered_classic.cu, every rule on
graphs that repeat a block-column in a layer).

`layered_decode_plain` ports ecc_ldpc_tpu/decode/xla/layered.py::
decode_layered: fixed-iteration mode (`early_term=False`, exactly
max_iters sweeps) and track mode (per-frame freeze on the exact "every
layer parity passed and no posterior changed sign" rule). The check-node
rule `cn` is "minsum" (normalized/offset, scalar or per-iteration
alpha/beta), or one of the exact-BP rules "spa" (tanh rule, running
log|tanh| sum) and "minstar" (box-plus forward/backward scans), which
ignore alpha/beta. On graphs with no duplicate column inside a layer
(every DVB-S2, 802.11n, WiMAX and 5G NR table) signs follow the sign bits
and a layer sets each posterior to V + Cnew; on multi-edge graphs (CCSDS
AR4JA) it takes the oracle's other form: count signs (v < 0) and posterior
updates that accumulate each slot's Cnew - Cold. It is the CPU path and
the card's yardstick.

`layered_decode_cuda` (min-sum), `layered_exact_cuda` (spa, minstar) and
`layered_classic_cuda` (all three, multi-edge graphs) launch the kernels
that replace ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel's
`sweep_delta`, `sweep_exact`, and `sweep_classic` with
`sweep_exact_classic`; `make_layered_decoder` picks one by graph and rule.
Min-sum is bit-identical with the plain version in f32 (same operations in
the same order, no fused multiply-add, no reduction across frames); the
exact rules are too wherever the card's expf, logf, tanhf and log1pf are
the ones PyTorch's CUDA elementwise ops call.

All visit block-rows in QCGraph.layer_order and each row's edges in
layer_edges order, as the JAX package does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..graph.qc import QCGraph
from .types import DecodeResult

_MAG_CAP = 1e12
_SPA_TANH_CLIP = 1.0 - 1e-7  # keeps 2*atanh finite (layered.py:86)
_MINSTAR_IDENTITY = 1e9      # box-plus identity: a degree-1 row's message
_SIGN = -(1 << 31)           # the f32 sign bit as an int32
CN_RULES = ("minsum", "spa", "minstar")
MAX_DEG = 32    # the kernels' largest row degree (csrc/*.cu)
_FT = 8         # frames per CUDA block, the kernels' FT
_THREADS = 512  # threads per CUDA block at most (__launch_bounds__)


def _schedule(alpha, beta, max_iters: int, cn: str = "minsum"):
    """(alphas f32 [T], betas f32 [T], per_iter): alpha_t/beta_t of every
    iteration, and whether either was given per iteration. Raises on an
    unknown rule, and on a schedule for an exact rule (nothing to
    normalize), as the JAX package's Pallas wrapper does."""
    if cn not in CN_RULES:
        raise KeyError(f"layered cn must be minsum/spa/minstar, got {cn!r}")
    per_iter = np.ndim(alpha) != 0 or np.ndim(beta) != 0
    if per_iter and cn != "minsum":
        raise ValueError(
            f"per-iteration alpha/beta schedules apply to minsum only "
            f"(cn={cn!r} is exact BP — nothing to normalize)")
    alphas = np.broadcast_to(np.asarray(alpha, np.float32), (max_iters,))
    betas = np.broadcast_to(np.asarray(beta, np.float32), (max_iters,))
    return alphas, betas, per_iter


def check_graph(graph: QCGraph) -> None:
    """Raise on graphs this module does not decode."""
    if not isinstance(graph, QCGraph):
        raise TypeError("layered decoding needs the port's QCGraph "
                        "(graph.qc.compile_qc_graph)")
    if graph.dcb_max > MAX_DEG:
        raise ValueError(f"{graph.name}: row degree {graph.dcb_max} exceeds "
                         f"the layered kernel's limit {MAX_DEG}")


def _device_tables(graph: QCGraph, device: torch.device, kind: str, build):
    """Tables of `kind` for `device`, built once per graph."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (kind, str(device))
    if key not in graph.device_cache:
        graph.device_cache[key] = build(graph, device)
    return graph.device_cache[key]


def _plain_layers(graph: QCGraph, device):
    """Per layer in layer_order: (var_idx long [d*Z], edge ids long [d], d).
    var_idx[j*Z + z] is the variable that check z of slot j reads."""
    Z = graph.Z
    z = np.arange(Z)
    layers = []
    for i in graph.layer_order:
        edges = graph.layer_edges(i)
        idx = np.concatenate([col * Z + (z + s) % Z for _, col, s in edges])
        eids = np.asarray([e for e, _, _ in edges], np.int64)
        layers.append((torch.as_tensor(idx, dtype=torch.long, device=device),
                       torch.as_tensor(eids, device=device), len(edges)))
    return layers


def _cn_minsum(V: torch.Tensor, a: float, b: float,
               signbit: bool = True) -> torch.Tensor:
    """Leave-one-out two-min check update over axis 0 of V [d, Z, B],
    magnitude max(a*min(m, cap) - b, 0). Signs: sign bits XOR-ed (-0.0 is
    negative), or with signbit=False the count rule (v < 0) of
    layered.py::_cn_minsum_axis0(signbit=False)."""
    negb = torch.signbit(V) if signbit else V < 0
    neg_out = (negb.sum(0, keepdim=True) % 2 == 1) ^ negb
    A = V.abs()
    min1 = A.amin(0, keepdim=True)
    is_min = A == min1
    count_min = is_min.sum(0, keepdim=True)
    min2 = torch.where(is_min, torch.inf, A).amin(0, keepdim=True)
    mag = torch.where(is_min & (count_min == 1), min2, min1)
    mag = torch.clamp_max(mag, _MAG_CAP)
    mag = torch.clamp_min(a * mag - b, 0.0)
    return torch.where(neg_out, -mag, mag)


def _cn_spa(V: torch.Tensor, signbit: bool = True) -> torch.Tensor:
    """Exact sum-product over axis 0 of V [d, Z, B] (layered.py:64-85):
    leave-one-out through a log|tanh| sum accumulated in slot order,
    magnitude 2*atanh(t) = log1p(t) - log1p(-t). With signbit=True the XOR
    of the other slots' sign bits is OR-ed onto it (so a zero magnitude
    keeps its sign bit, as the Pallas kernel's integer form does); with
    signbit=False the sign is the count rule's (v < 0), as
    _cn_spa_seq(signbit=False) and sweep_exact_classic take it."""
    lt = torch.log(torch.tanh(torch.clamp(V.abs(), 1e-10, 40.0) * 0.5))
    acc = lt[0]
    for j in range(1, V.shape[0]):
        acc = acc + lt[j]
    t = torch.clamp_max(torch.exp(acc - lt), _SPA_TANH_CLIP)
    mag = torch.log1p(t) - torch.log1p(-t)
    if not signbit:
        neg = V < 0
        neg_out = (neg.sum(0, keepdim=True) % 2 == 1) ^ neg
        return torch.where(neg_out, -mag, mag)
    sb = V.view(torch.int32)
    sg = sb[0]
    for j in range(1, V.shape[0]):
        sg = sg ^ sb[j]
    flip = (sg ^ sb) & _SIGN
    return (mag.view(torch.int32) | flip).view(torch.float32)


def _boxplus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x ⊞ y = sign(x)sign(y)min(|x|,|y|) + log1p(e^-|x+y|) -
    log1p(e^-|x-y|) (flooding_qc.py:58-64; signs by x < 0)."""
    mag = torch.minimum(x.abs(), y.abs())
    sgn = torch.where((x < 0) ^ (y < 0), -1.0, 1.0)
    corr = (torch.log1p(torch.exp(-(x + y).abs()))
            - torch.log1p(torch.exp(-(x - y).abs())))
    return sgn * mag + corr


def _cn_minstar(V: torch.Tensor) -> torch.Tensor:
    """Exact sum-product over axis 0 of V [d, Z, B] by box-plus
    (flooding_qc.py:67-86): slot j gets fwd[j-1] ⊞ bwd[j+1] from forward
    prefixes and a running backward suffix; a degree-1 row sends 1e9; the
    result is clipped to ±1e12."""
    d = V.shape[0]
    if d == 1:
        return torch.full_like(V, _MINSTAR_IDENTITY)
    fwd = [V[0]]
    for j in range(1, d - 1):
        fwd.append(_boxplus(fwd[-1], V[j]))
    outs = [None] * d
    outs[d - 1] = fwd[d - 2]
    bwd = V[d - 1]
    for j in range(d - 2, 0, -1):
        outs[j] = _boxplus(fwd[j - 1], bwd)
        bwd = _boxplus(bwd, V[j])
    outs[0] = bwd
    return torch.clamp(torch.stack(outs), -_MAG_CAP, _MAG_CAP)


def _check_rule(cn: str, a: float, b: float, signbit: bool = True):
    """Cnew(V [d, Z, B]) for rule `cn` at this iteration's alpha/beta, with
    sign bits (dup-free graphs) or the count rule (signbit=False: graphs
    with a column repeated in a layer, as the JAX oracle forces there)."""
    if cn == "spa":
        return lambda V: _cn_spa(V, signbit)
    if cn == "minstar":
        return _cn_minstar
    return lambda V: _cn_minsum(V, a, b, signbit)


def _syndrome_fail_plain(layers, total: torch.Tensor, Z: int) -> torch.Tensor:
    """bool [B]: some check of the hard decisions (x < 0) fails."""
    B = total.shape[1]
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    for idx, _, d in layers:
        par = (total[idx] < 0).view(d, Z, B).sum(0) % 2
        fail |= (par != 0).any(0)
    return fail


def _sweep_plain(layers, total, C, Z, rule, frozen, accumulate=False,
                 reverse=False):
    """One layered iteration, in place on total [n, B] and C [BE, Z, B],
    with check rule `rule` (V [d, Z, B] -> Cnew). With `frozen` (bool [B],
    track mode) frozen frames keep their state exactly and the on-the-fly
    fail flag (layer parity or a sign flip) is returned.

    Posterior update: the set form total = V + Cnew where a layer touches
    each column once; with `accumulate` (a column repeated in the layer)
    the accumulate form of decode/xla/layered.py:187-234: every slot's
    rolled posterior is read first, then each slot in layer order (reverse
    for minstar: `reverse`) adds Cnew - Cold to its posteriors, and a sign
    flip is checked after each slot's add."""
    B = total.shape[1]
    track = frozen is not None
    fail = torch.zeros(B, dtype=torch.bool, device=total.device)
    if track:
        keep = frozen.view(1, 1, B)
    for idx, eids, d in layers:
        rolled = total[idx].view(d, Z, B)
        if track:
            par = (rolled < 0).sum(0) % 2
            fail |= (par != 0).any(0)
        Cold = C[eids]
        V = rolled - Cold
        Cnew = rule(V)
        if track:
            Cnew = torch.where(keep, Cold, Cnew)
        if accumulate:
            delta = Cnew - Cold
            for j in (range(d - 1, -1, -1) if reverse else range(d)):
                ij = idx[j * Z:(j + 1) * Z]
                old = total[ij]
                new = old + delta[j]
                if track:
                    new = torch.where(keep[0], old, new)
                    fail |= (torch.signbit(new) != torch.signbit(old)).any(0)
                total[ij] = new
        else:
            if track:
                new = torch.where(keep, rolled, V + Cnew)
                fail |= (torch.signbit(new)
                         != torch.signbit(rolled)).any(0).any(0)
            else:
                new = V + Cnew
            total[idx] = new.view(d * Z, B)
        C[eids] = Cnew
    return fail


def plain_with_posteriors(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                          beta=0.0, max_iters: int = 25,
                          early_term: bool = True, cn: str = "minsum"):
    """(DecodeResult, posteriors f32 [B, n]) of the plain layered decode
    of llr f32 [B, n], on llr's device."""
    check_graph(graph)
    B = llr.shape[0]
    Z = graph.Z
    alphas, betas, _ = _schedule(alpha, beta, max_iters, cn)
    layers = _device_tables(graph, llr.device, "plain", _plain_layers)
    total = llr.to(torch.float32).t().contiguous()  # [n, B]
    C = torch.zeros((graph.num_block_edges, Z, B), dtype=torch.float32,
                    device=llr.device)
    # graphs with a column repeated in a layer: count signs, accumulate form
    dup = not graph.intra_layer_dup_free
    form = dict(accumulate=dup, reverse=dup and cn == "minstar")

    def rule(t):
        return _check_rule(cn, float(alphas[t]), float(betas[t]),
                           signbit=not dup)

    if early_term:
        done = ~_syndrome_fail_plain(layers, total, Z)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        for t in range(max_iters):
            if bool(done.all()):
                break
            fail = _sweep_plain(layers, total, C, Z, rule(t), done, **form)
            iters += (~done).to(torch.int32)
            done = done | ~fail
    else:
        for t in range(max_iters):
            _sweep_plain(layers, total, C, Z, rule(t), None, **form)
        iters = torch.full((B,), max_iters, dtype=torch.int32,
                           device=llr.device)
    bits = (total < 0).to(torch.uint8).t().contiguous()
    ok = ~_syndrome_fail_plain(layers, total, Z)
    return DecodeResult(bits=bits, ok=ok, iterations=iters), total.t()


def layered_decode_plain(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                         beta=0.0, max_iters: int = 25,
                         early_term: bool = True,
                         cn: str = "minsum") -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    return plain_with_posteriors(graph, llr, alpha=alpha, beta=beta,
                                 max_iters=max_iters, early_term=early_term,
                                 cn=cn)[0]


def _kernel_table(graph: QCGraph, device):
    """int32 [mb+1 + 2*BE]: layer_ptr, then the column and shift of every
    sweep slot (layer_order, then layer_edges order)."""
    ptr, col, shift = [0], [], []
    for i in graph.layer_order:
        for _, c, s in graph.layer_edges(i):
            col.append(c)
            shift.append(s)
        ptr.append(len(col))
    tab = np.asarray(ptr + col + shift, np.int32)
    return torch.as_tensor(tab, device=device)


def threads_z(Z: int) -> int:
    """Threads along z per block: all Z checks when they fit, else the
    largest divisor of Z that fits the block (no idle z-round), unless
    that wastes over half the block."""
    cap = _THREADS // _FT
    if Z <= cap:
        return Z
    best = max(d for d in range(1, cap + 1) if Z % d == 0)
    return best if 2 * best > cap else cap


def _lib(name: str, entry: str, argtypes):
    """The built library for csrc/<name>.cu with `entry`'s signature set."""
    from .. import _build

    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


_QC_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_EXACT_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_CLASSIC_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check_llr(llr: torch.Tensor, n: int, max_iters: int, who: str,
               plain: str) -> None:
    """Raise on LLRs and iteration counts the decoders' kernels do not
    take (`who` names the wrapper, `plain` its plain version)."""
    if llr.device.type != "cuda":
        raise ValueError(
            f"{who} needs a CUDA tensor, got {llr.device}; "
            f"the plain version is {plain}")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != n or llr.shape[0] < 1:
        raise ValueError(f"llr must be [B, {n}], got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")


def _check_cuda_input(graph: QCGraph, llr: torch.Tensor, max_iters: int,
                      who: str, classic: bool = False) -> None:
    """Raise on anything the layered kernel of `who` does not take: the
    classic kernel decodes graphs that repeat a block-column in a layer,
    the other two only graphs that do not."""
    _check_llr(llr, graph.n, max_iters, who, "layered_decode_plain")
    check_graph(graph)
    if classic and graph.intra_layer_dup_free:
        raise ValueError(
            f"{graph.name}: no layer repeats a block-column; its kernels are "
            f"layered_decode_cuda's (minsum) and layered_exact_cuda's")
    if not classic and not graph.intra_layer_dup_free:
        raise ValueError(
            f"{graph.name}: a layer repeats a block-column; its kernel is "
            f"layered_classic_cuda's")


def _to_tiles(llr: torch.Tensor) -> torch.Tensor:
    """llr [B, n] -> f32 [tiles, n, FT], frames innermost, the last tile
    padded with zero LLRs (its extra lanes are never written back)."""
    B, n = llr.shape
    tiles = -(-B // _FT)
    x = llr if tiles * _FT == B else torch.cat(
        [llr, llr.new_zeros((tiles * _FT - B, n))])
    return x.view(tiles, _FT, n).transpose(1, 2).contiguous()


def _from_tiles(x: torch.Tensor, B: int) -> torch.Tensor:
    """[tiles, n, FT] -> [B, n], the inverse of _to_tiles."""
    tiles, n, _ = x.shape
    return x.transpose(1, 2).reshape(tiles * _FT, n)[:B].contiguous()


def _raise_launch(lib, name: str, rc: int) -> None:
    err = getattr(lib, f"{name}_error_string")(rc).decode()
    raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} ({err})")


def layered_decode_cuda(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                        beta=0.0, max_iters: int = 25,
                        early_term: bool = True,
                        cn: str = "minsum") -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the layered min-sum kernel on the current stream (the exact rules are
    layered_exact_cuda's). Raises on anything the kernel does not take;
    never falls back to the plain version."""
    if cn != "minsum":
        raise ValueError(f"the min-sum kernel runs minsum, not {cn!r}; "
                         f"spa and minstar are layered_exact_cuda's")
    alphas, betas, per_iter = _schedule(alpha, beta, max_iters, cn)
    _check_cuda_input(graph, llr, max_iters, "layered_decode_cuda")
    dev = llr.device
    B, Z, n = llr.shape[0], graph.Z, graph.n
    tiles = -(-B // _FT)
    min_deg = min(d for d, _ in graph.layer_groups)
    fast_mag = not per_iter and float(betas[0]) == 0.0 and not early_term \
        and min_deg >= 2
    tab = _device_tables(graph, dev, "kernel", _kernel_table)
    ab = (torch.as_tensor(np.stack([alphas, betas]), device=dev)
          if per_iter else None)
    total = _to_tiles(llr)  # in: LLRs; out: posteriors
    # per check: mag1, mag2, sign bits, min slot (csrc/layered_qc.cu)
    cs = torch.empty((tiles, graph.m * 4, _FT), dtype=torch.int32,
                     device=dev)
    bits = torch.empty((tiles, n, _FT), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib("layered_qc", "layered_qc_decode", _QC_ARGS)
    with torch.cuda.device(dev):
        rc = lib.layered_qc_decode(
            total.data_ptr(), cs.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            iters.data_ptr(), tab.data_ptr(),
            None if ab is None else ab.data_ptr(),
            Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, float(alphas[0]), float(betas[0]),
            int(early_term), int(fast_mag), threads_z(Z),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, "layered_qc", rc)
    layered_decode_cuda.launches += 1
    return DecodeResult(bits=_from_tiles(bits, B), ok=ok.bool(),
                        iterations=iters)


layered_decode_cuda.launches = 0


def _message_buffers(graph: QCGraph, llr: torch.Tensor):
    """Tile buffers of the kernels that keep every message:
    (slot table, total, C, bits, ok, iters); total holds the LLRs in and
    the posteriors out, C one row per sweep slot and check."""
    dev = llr.device
    B, tiles = llr.shape[0], -(-llr.shape[0] // _FT)
    tab = _device_tables(graph, dev, "kernel", _kernel_table)
    C = torch.empty((tiles, graph.num_block_edges * graph.Z, _FT),
                    dtype=torch.float32, device=dev)
    bits = torch.empty((tiles, graph.n, _FT), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    return tab, _to_tiles(llr), C, bits, ok, iters


def _launch_exact(graph: QCGraph, llr: torch.Tensor, max_iters: int,
                  early_term: bool, cn: str):
    """(DecodeResult, posteriors f32 [tiles, n, FT]) of one launch of the
    exact-BP layered kernel on the current stream."""
    if cn not in ("spa", "minstar"):
        raise ValueError(f"the exact-BP kernel runs spa or minstar, not {cn!r}")
    _check_cuda_input(graph, llr, max_iters, "layered_exact_cuda")
    dev, B, Z = llr.device, llr.shape[0], graph.Z
    tab, total, C, bits, ok, iters = _message_buffers(graph, llr)
    lib = _lib("layered_exact", "layered_exact_decode", _EXACT_ARGS)
    with torch.cuda.device(dev):
        rc = lib.layered_exact_decode(
            total.data_ptr(), C.data_ptr(), bits.data_ptr(), ok.data_ptr(),
            iters.data_ptr(), tab.data_ptr(),
            Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, int(cn == "minstar"), int(early_term),
            threads_z(Z), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, "layered_exact", rc)
    layered_exact_cuda.launches += 1
    layered_exact_cuda.frames += B
    res = DecodeResult(bits=_from_tiles(bits, B), ok=ok.bool(),
                       iterations=iters)
    return res, total


def layered_exact_cuda(graph: QCGraph, llr: torch.Tensor, *,
                       max_iters: int = 25, early_term: bool = True,
                       cn: str = "spa") -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the exact-BP layered kernel (csrc/layered_exact.cu) on the current
    stream. Raises on anything the kernel does not take; never falls back
    to the plain version."""
    return _launch_exact(graph, llr, max_iters, early_term, cn)[0]


def exact_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                               max_iters: int = 25, early_term: bool = True,
                               cn: str = "spa"):
    """(DecodeResult, posteriors f32 [B, n]) of one launch of the
    exact-BP layered kernel: layered_exact_cuda plus the posteriors it
    leaves, for holding the kernel against plain_with_posteriors."""
    res, total = _launch_exact(graph, llr, max_iters, early_term, cn)
    return res, _from_tiles(total, llr.shape[0])


layered_exact_cuda.launches = 0
layered_exact_cuda.frames = 0  # frames decoded: the retry fallback's load


def _launch_classic(graph: QCGraph, llr: torch.Tensor, alpha, beta,
                    max_iters: int, early_term: bool, cn: str):
    """(DecodeResult, posteriors f32 [tiles, n, FT]) of one launch of the
    layered kernel for graphs that repeat a block-column in a layer."""
    alphas, betas, per_iter = _schedule(alpha, beta, max_iters, cn)
    _check_cuda_input(graph, llr, max_iters, "layered_classic_cuda",
                      classic=True)
    dev, B, Z = llr.device, llr.shape[0], graph.Z
    tab, total, C, bits, ok, iters = _message_buffers(graph, llr)
    ab = (torch.as_tensor(np.stack([alphas, betas]), device=dev)
          if per_iter else None)
    # one layer's message changes Cnew - Cold (csrc/layered_classic.cu)
    D = torch.empty((C.shape[0], graph.dcb_max * Z, _FT),
                    dtype=torch.float32, device=dev)
    lib = _lib("layered_classic", "layered_classic_decode", _CLASSIC_ARGS)
    with torch.cuda.device(dev):
        rc = lib.layered_classic_decode(
            total.data_ptr(), C.data_ptr(), D.data_ptr(), bits.data_ptr(),
            ok.data_ptr(), iters.data_ptr(), tab.data_ptr(),
            None if ab is None else ab.data_ptr(),
            Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, float(alphas[0]), float(betas[0]),
            CN_RULES.index(cn), int(early_term), threads_z(Z),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, "layered_classic", rc)
    layered_classic_cuda.launches += 1
    layered_classic_cuda.frames += B
    layered_classic_cuda.by_rule[cn] += 1
    layered_classic_cuda.frames_by_rule[cn] += B
    res = DecodeResult(bits=_from_tiles(bits, B), ok=ok.bool(),
                       iterations=iters)
    return res, total


def layered_classic_cuda(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                         beta=0.0, max_iters: int = 25,
                         early_term: bool = True,
                         cn: str = "minsum") -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the layered kernel for graphs that repeat a block-column in a layer
    (csrc/layered_classic.cu: min-sum, spa and minstar in the accumulate
    form with count signs) on the current stream. Raises on anything the
    kernel does not take, dup-free graphs included; never falls back to
    the plain version."""
    return _launch_classic(graph, llr, alpha, beta, max_iters, early_term,
                           cn)[0]


def classic_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                                 alpha=1.0, beta=0.0, max_iters: int = 25,
                                 early_term: bool = True, cn: str = "minsum"):
    """(DecodeResult, posteriors f32 [B, n]) of one launch of the classic
    layered kernel, for holding it against plain_with_posteriors."""
    res, total = _launch_classic(graph, llr, alpha, beta, max_iters,
                                 early_term, cn)
    return res, _from_tiles(total, llr.shape[0])


layered_classic_cuda.launches = 0
layered_classic_cuda.frames = 0
# per rule: one kernel serves a retry decoder's primary and its fallback
layered_classic_cuda.by_rule = dict.fromkeys(CN_RULES, 0)         # launches
layered_classic_cuda.frames_by_rule = dict.fromkeys(CN_RULES, 0)  # frames


def make_layered_decoder(graph: QCGraph, *, alpha=1.0, beta=0.0,
                         max_iters: int = 25, early_term: bool = True,
                         cn: str = "minsum", device="cuda"):
    """decode(llr [B, n]) -> DecodeResult. The decoder runs the plain
    version on CPU tensors and a CUDA kernel on CUDA tensors: on graphs
    that repeat a block-column in a layer the classic kernel for every
    rule, otherwise the min-sum or the exact-BP kernel by rule `cn`.
    `device` (default "cuda", which raises when CUDA is absent) is where
    its tables are built up front. Exact rules ignore alpha/beta."""
    check_graph(graph)
    _schedule(alpha, beta, max_iters, cn)
    dev = resolve_device(device)
    kw = dict(alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term, cn=cn)
    if dev.type == "cuda":
        _device_tables(graph, dev, "kernel", _kernel_table)
    else:
        _device_tables(graph, dev, "plain", _plain_layers)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return layered_decode_plain(graph, llr, **kw)
        if not graph.intra_layer_dup_free:
            return layered_classic_cuda(graph, llr, **kw)
        if cn == "minsum":
            return layered_decode_cuda(graph, llr, **kw)
        return layered_exact_cuda(graph, llr, max_iters=max_iters,
                                  early_term=early_term, cn=cn)

    return decode
