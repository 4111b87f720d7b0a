"""The small-code dc-major flooding min-sum and its two ablations (E4;
port of experiments/smallcode_opt2.py): the kernel csrc/dcmajor.cu, its
wrapper, its plain version and the experiment.

The function is smallcode_opt2.py::_kernel_dcmajor's: `max_iters` fixed
iterations of flooding min-sum, magnitude max(alpha * m - beta, 0), on an
unstructured graph, the edges in the dc-major order e = j * m + i (slot j
of check i), the variable sums and the next extrinsic messages formed as
the TPU's 0/1 incidence products in bf16 with f32 accumulation (C and
total rounded to bf16 on their way into a product; each variable's sum in
ascending e), and ok the final syndrome. VARIANTS: "full"; "mm_only" (the
check rule passes V through); "cn_only" (no products; the dependency kept
alive by 1e-9 terms). The cn_only of the TPU script broadcasts C's first
slab ([m_pad, Bt]) onto total ([n_pad, Bt]) and so runs only where
m_pad == n_pad (not on mackay1008); the port adds it to rows i < min(m, n)
(csrc/dcmajor.cu's header).

The kernel runs in K2's frame: two phases an iteration (the TPU's V
phase recomputed in the check phase), two frames an item where the plan's
F is even, K2's tables (cn and the padded vmat).

The experiment prints the kernel's plan (dcmajor_plan: frames a tile and
an item, the tables' form), then times, at B = 2048 on mackay1008 at 2.0
dB: K2, the production flooding kernel (decode/flooding.py) in f32 and
with the TPU kernel's bf16 matmul inputs (/pallas), then the three
dc-major variants, and prints Mbit/s, ms and FER as the TPU script did.

Run:  python -m ecc_ldpc_tpu_torch.experiments.smallcode_opt2 [CODE]
      [--device cpu]
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..bench.throughput import decode_bound, make_inputs
from ..decode.layered_qc import H100_SMS, _check_llr, _lib, _raise_launch
from ..decode.quant import round_bf16
from ..decode.types import DecodeResult
from . import common

VARIANTS = ("full", "mm_only", "cn_only")
ALPHA, BETA = 0.8125, 0.0
ITERS = 25
BATCH = 2048
EBN0 = 2.0
CODE = "mackay1008"
_BIG = 1e12
_SIGN = -(1 << 31)
_SMEM_ROOM = 232_448 - 1024  # a block's shared memory, less the static
_MAX_FRAMES = 64


def tables(graph) -> dict:
    """The dc-major tables of a CompiledGraph (numpy int32): cn [dc * m],
    the variable of slot j of check i at j * m + i or -1; vmat [n, dv],
    each variable's edges in ascending e, -1 padded. Cached on the graph.
    Raises on a check that reads a variable twice."""
    key = ("dcmajor", "tables")
    if key in graph.device_cache:
        return graph.device_cache[key]
    m, n, dc = graph.m, graph.n, graph.dc_max
    cn_vn = np.asarray(graph.cn_vn)
    mask = np.asarray(graph.cn_mask, bool)
    for i in range(m):
        row = cn_vn[i][mask[i]]
        if len(set(row.tolist())) != len(row):
            raise ValueError(f"{graph.name}: check {i} reads a variable "
                             f"twice; the dc-major kernel takes H's 0/1 "
                             f"rows only")
    cn = np.where(mask.T, cn_vn.T, -1).reshape(-1).astype(np.int32)
    edges = [[] for _ in range(n)]
    for e in np.flatnonzero(cn >= 0):
        edges[cn[e]].append(int(e))  # ascending e, as flatnonzero gives
    dv = max(1, max(len(x) for x in edges))
    vmat = np.full((n, dv), -1, np.int32)
    for v, x in enumerate(edges):
        vmat[v, :len(x)] = x
    out = dict(cn=cn, vmat=vmat)
    graph.device_cache[key] = out
    return out


def _tables_on(graph, dev) -> dict:
    key = ("dcmajor", str(dev))
    if key not in graph.device_cache:
        graph.device_cache[key] = {
            k: torch.as_tensor(v, device=dev)
            for k, v in tables(graph).items()}
    return graph.device_cache[key]


def _tournament(X: torch.Tensor, real: torch.Tensor, m: int, dc: int,
                alpha: float, beta: float) -> torch.Tensor:
    """The check rule on V [B, dc * m]: tournament two-min and sign-bit
    XOR across the dc slabs (smallcode_opt2.py:96-127)."""
    B = X.shape[0]
    V = X.view(B, dc, m)
    big = torch.tensor(_BIG, dtype=torch.float32, device=X.device)
    sgn = torch.tensor(_SIGN, dtype=torch.int32, device=X.device)
    zero = torch.zeros((), dtype=torch.int32, device=X.device)
    m1 = big.expand(B, m)
    m2 = m1
    sx = torch.zeros((B, m), dtype=torch.int32, device=X.device)
    av, sb = [], []
    for j in range(dc):
        v = V[:, j]
        a = torch.where(real[j], v.abs(), big)
        s = torch.where(v < 0, sgn, zero)
        av.append(a)
        sb.append(s)
        nm1 = torch.minimum(m1, a)
        m2 = torch.minimum(torch.maximum(m1, a), m2)
        m1 = nm1
        sx = sx ^ s
    outs = []
    for j in range(dc):
        mag = torch.where(av[j] == m1, m2, m1)
        mag = torch.clamp_min(alpha * mag - beta, 0.0)
        c = (mag.view(torch.int32) ^ (sx ^ sb[j])).view(torch.float32)
        outs.append(torch.where(real[j], c, 0.0))
    return torch.stack(outs, 1).reshape(B, dc * m)


def dcmajor_plain(graph, llr: torch.Tensor, variant: str = "full",
                  max_iters: int = ITERS, alpha: float = ALPHA,
                  beta: float = BETA):
    """The plain PyTorch version: llr f32 [B, n] -> (DecodeResult, final
    posteriors f32 [B, n]), as dcmajor_cuda returns them."""
    if variant not in VARIANTS:
        raise KeyError(f"variant must be one of {VARIANTS}, got {variant!r}")
    t = _tables_on(graph, llr.device)
    m, n, dc = graph.m, graph.n, graph.dc_max
    cn = t["cn"].long()
    real_e = cn >= 0
    cn0 = cn.clamp(min=0)
    real = real_e.view(dc, m)
    vmat = t["vmat"].long()
    total = llr.clone()

    def v_phase(X):  # V = St (total) - C: bf16(total[var]) - C, 0 - C padded
        return torch.where(real_e, round_bf16(total[:, cn0]), 0.0) - X

    X = v_phase(torch.zeros((llr.shape[0], dc * m), device=llr.device))
    k = min(m, n)
    for _ in range(max_iters):
        if variant != "mm_only":
            X = _tournament(X, real, m, dc, alpha, beta)
        if variant != "cn_only":
            s = torch.zeros_like(llr)
            for j in range(vmat.shape[1]):
                e = vmat[:, j]
                s = torch.where(e >= 0, s + round_bf16(X[:, e.clamp(min=0)]),
                                s)
            total = llr + s
            X = v_phase(X)
        else:
            total = total.clone()
            total[:, :k] = total[:, :k] + X[:, :k] * 1e-9
            X = X + total[:, :1] * 1e-9
    hard = (total < 0)[:, cn0] & real_e
    fail = (hard.view(-1, dc, m).sum(1) % 2).bool().any(1)
    return DecodeResult(
        bits=(total < 0).to(torch.uint8), ok=~fail,
        iterations=torch.full((llr.shape[0],), max_iters, dtype=torch.int32,
                              device=llr.device)), total


def dcmajor_plan(graph, batch: int, sms: int) -> dict:
    """F frames a tile (the most that fit a block, then the fewest that
    keep the waves of tiles over `sms` blocks), tiles, blocks, threads,
    tables ("smem": cn and vmat staged once a block into shared memory as
    int16, where n and dc * m fit int16 and the tables cost the plan no
    frame a tile; else "ldg": read through the read-only path), lanes
    (frames a thread's item: 2 where F is even, a check has at most 16
    slots and the tables are in shared memory, else 1), dynamic shared
    bytes."""
    n, m, dc = graph.n, graph.m, graph.dc_max
    per = 4 * (2 * n + dc * m)

    def frames(room: int) -> int:
        fmax = min(_MAX_FRAMES, room // per)
        if fmax < 1:
            return 0
        waves = -(-batch // (sms * fmax))
        return -(-batch // (sms * waves))

    F = frames(_SMEM_ROOM)
    if F < 1:
        raise ValueError(f"{graph.name}: a frame's state ({per} B) does not "
                         f"fit a block's shared memory")
    dv = max(1, graph.dv_max)  # vmat's width at most
    tab = -(-2 * (dc * m + n * dv) // 16) * 16
    smem = max(n, dc * m) <= 32767 and frames(_SMEM_ROOM - tab) == F
    tiles = -(-batch // F)
    return dict(frames=F, tiles=tiles, blocks=min(tiles, sms), threads=512,
                lanes=2 if smem and F % 2 == 0 and dc <= 16 else 1,
                tables="smem" if smem else "ldg",
                smem=per * F + (tab if smem else 0))


_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_float] * 2
         + [ctypes.c_void_p])
_SMS = {}


def dcmajor_cuda(graph, llr: torch.Tensor, variant: str = "full",
                 max_iters: int = ITERS, alpha: float = ALPHA,
                 beta: float = BETA, with_posteriors: bool = False):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch of the
    dc-major kernel on llr f32 [B, n] on the card, its tables as
    dcmajor_plan says. Raises on anything the kernel does not take; no
    fallback."""
    _check_llr(llr, graph.n, max(max_iters, 1), "dcmajor_cuda",
               "dcmajor_plain")
    if variant not in VARIANTS:
        raise KeyError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if graph.dc_max > 32:
        raise ValueError(f"{graph.name}: checks of {graph.dc_max} slots; the "
                         f"dc-major kernel takes 32 at most")
    dev, B = llr.device, llr.shape[0]
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dcmajor_plan(graph, B, _SMS[dev])
    t = _tables_on(graph, dev)
    bits = torch.empty((B, graph.n), dtype=torch.uint8, device=dev)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    post = (torch.empty((B, graph.n), dtype=torch.float32, device=dev)
            if with_posteriors else None)
    lib = _lib("dcmajor", "dcmajor_decode", _ARGS)
    with torch.cuda.device(dev):
        rc = lib.dcmajor_decode(
            llr.data_ptr(), bits.data_ptr(), ok.data_ptr(), iters.data_ptr(),
            None if post is None else post.data_ptr(), t["cn"].data_ptr(),
            t["vmat"].data_ptr(), graph.n, graph.m, graph.dc_max,
            t["vmat"].shape[1], B, max_iters, VARIANTS.index(variant),
            plan["frames"], plan["tiles"], plan["lanes"],
            int(plan["tables"] == "smem"), plan["blocks"], plan["threads"],
            plan["smem"], alpha, beta,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise_launch(lib, "dcmajor", rc)
    dcmajor_cuda.launches += 1
    dcmajor_cuda.launches_by_variant[variant] = \
        dcmajor_cuda.launches_by_variant.get(variant, 0) + 1
    dcmajor_cuda.last_plan = plan
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters), post


dcmajor_cuda.launches = 0
dcmajor_cuda.launches_by_variant = {}
dcmajor_cuda.last_plan = None


def dcmajor(graph, llr, variant="full", max_iters=ITERS, alpha=ALPHA,
            beta=BETA) -> DecodeResult:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if llr.device.type == "cuda":
        return dcmajor_cuda(graph, llr, variant, max_iters, alpha, beta)[0]
    return dcmajor_plain(graph, llr, variant, max_iters, alpha, beta)[0]


def main(argv=None) -> int:
    p = common.parser(__doc__)
    p.add_argument("code", nargs="?", default=CODE)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    dev, card = common.start(args)
    spec = f"minsum/norm:{ALPHA}/{args.iters}/noet"
    x = make_inputs(args.code, spec, args.batch, EBN0, dev, seed=0)
    graph = x.graph
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    plan = dcmajor_plan(graph, args.batch, sms)
    print(f"plan: F={plan['frames']} ({plan['lanes']} an item), "
          f"{plan['tiles']} tiles on {plan['blocks']} blocks, tables "
          f"{plan['tables']}", flush=True)
    common.record(experiment="smallcode_opt2", code=args.code,
                  batch=args.batch, plan=plan, **card)
    kbits = args.batch * x.spec.k
    bound, by = decode_bound(x.spec.n, x.spec.num_edges, args.batch,
                             args.batch * args.iters, "minsum", x.spec.m,
                             "flooding")

    def bench(name, fn, ref_fer=None):
        res = fn()
        fer = x.frame_errors(res.bits)[0] / args.batch
        dt = common.seconds(fn, dev, args.tries)
        note = "" if ref_fer is None else f" (ref {ref_fer:.4f})"
        print(f"{name:28s}: {kbits / dt / 1e6:7.1f} Mbit/s  {dt * 1e3:7.3f} "
              f"ms  FER={fer:.4f}{note}", flush=True)
        common.record(experiment="smallcode_opt2", variant=name,
                      code=args.code, batch=args.batch, ms=dt * 1e3,
                      mbps=kbits / dt / 1e6, fer=fer, bound_ms=bound * 1e3,
                      bound_by=by, **card)
        return fer, dt

    from ..decode.api import get_decoder

    ref_fer = None
    out = {}
    for name, suffix in (("prod f32", ""), ("prod bf16 (/pallas)", "/pallas")):
        dec = get_decoder(graph, spec + suffix, device=dev)
        f, out[name] = bench(name, lambda dec=dec: dec(x.llr))
        ref_fer = ref_fer if ref_fer is not None else f
    for v in VARIANTS:
        _, out[v] = bench(
            f"dcmajor/{v}/bf16",
            lambda v=v: dcmajor(graph, x.llr, v, args.iters),
            ref_fer if v == "full" else None)
    for v in VARIANTS[1:]:
        print(f"{v}{common.saves(out['full'], out[v])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
