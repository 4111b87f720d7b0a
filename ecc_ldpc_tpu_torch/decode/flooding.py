"""Flooding BP on unstructured graphs: the plain PyTorch version and the
wrapper of its CUDA kernel (csrc/flooding.cu, K2).

`flooding_decode_plain` ports ecc_ldpc_tpu/decode/xla/flooding.py::
decode_flooding: messages in the padded check view [m, dc, B]; per
iteration every check fires (decode/cn_ops.py), then every variable sums
its check messages in slot order. Track mode (`early_term=True`) takes the
syndrome of the post-sweep posteriors, keeps the state of a frame that was
done before the sweep, and counts the sweeps of frames not yet done;
fixed mode runs exactly max_iters sweeps. It is the CPU path and the
card's yardstick.

Precision: ("bf16",) (decode/quant.py) is the TPU kernel's min-sum under
`/pallas` (ecc_ldpc_tpu/decode/pallas/fused_mm.py:289-295, mxu_dtype
bf16; tpu_flooding_precision): every matmul input rounded to bf16, so the
check rule reads bf16(posterior) - C (:165-170, :219-220), and each
variable adds bf16(C) of its slots in f32 (:196-197) to its f32 LLR; the
messages, the sums and the syndrome's hard decisions stay f32.

`flooding_decode_cuda` launches the kernel that replaces
ecc_ldpc_tpu/decode/pallas/fused_mm.py::_kernel (and serves minstar too),
the same operations in the same order: bit-identical with the plain
version on the card. A tile of F frames keeps its whole decoder state
(posteriors, messages and, where they fit, LLRs) in one block's shared
memory for the whole decode, by the plan `flooding_plan` gives (form
"chip"); a graph whose frame does not fit a block takes the form "global",
the same state in a device-memory scratch. The kernel reads llr [B, n] and
writes [B, n] directly; `flooding_decode_cuda.last_plan` is its last
launch's plan and the blocks resident.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..graph.compile import CompiledGraph
from .cn_ops import CN_KINDS, get_rule
from .layered_qc import (
    _MAX_FRAMES,
    _SMEM_BLOCK,
    _SMEM_STATIC,
    H100_SMS,
    _SMS,
    _check_llr,
    _device_tables,
    _lib,
    _ptr,
    _raise_launch,
    _round4,
    wide_scratch,
)
from .quant import BF16, check_precision, describe, round_bf16
from .types import DecodeResult

# the kernel's widest register build (csrc/flooding.cu: 6-, 8-, 32- and
# 64-wide instances); a wider row takes its wide build (plan width = the
# row's degree), as the plain version takes any degree
MAX_DC = 64
# rows up to this degree take two frames a thread's item where F is even;
# the 64-wide and wide builds take one (one frame's row a thread)
MAX_DC_PAIRS = 32
WIDTHS = (6, 8, 32, MAX_DC)  # the register builds' row widths (pick_width)
_RULE_IDS = {k: i for i, k in enumerate(CN_KINDS)}  # csrc/bp_rules.cuh
_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
         + [ctypes.c_int] * 8 + [ctypes.c_void_p])
FLOODING_FORMS = ("chip", "global")
# form "global": frames a tile at most (the earlier design's tile), each
# resident block's slab of the scratch holding that many frames' state
GLOBAL_FRAMES = 8
# form "chip": frames a tile at most. More shared memory leaves less L1
# for the index tables, which the kernel reads through it: on mackay1008
# tiles of 11 or 12 frames decode 4096 frames slower than tiles of 8
# (bench/flooding_probe.py on an H100)
CHIP_FRAMES = 8
# track mode: frames a tile at most. A tile runs until its slowest frame
# stops, so small tiles spread the slow frames: on mackay1008 tiles of 2
# decode spa/50 at B = 4096 faster than tiles of 1, 4 or 8
TRACK_FRAMES = 2


def check_args(graph: CompiledGraph, kind: str, alpha, beta,
               precision=None) -> None:
    """Raise on what the flooding decoders do not take (bf16 matmul inputs
    are min-sum's alone, as in the JAX package)."""
    if not isinstance(graph, CompiledGraph):
        raise TypeError("flooding decoding of an unstructured code needs the "
                        "port's CompiledGraph (graph.compile.compile_graph)")
    if kind not in CN_KINDS:
        raise KeyError(f"flooding kind must be one of {CN_KINDS}, got {kind!r}")
    if np.ndim(alpha) != 0 or np.ndim(beta) != 0:
        raise ValueError("flooding decoders take scalar alpha/beta only")
    if check_precision(precision) not in (None, BF16):
        raise ValueError(f"K2 takes f32 or the TPU's bf16 matmul inputs, "
                         f"not {precision!r}")
    if precision is not None and kind != "minsum":
        raise ValueError(f"bf16 matmul inputs are the TPU's min-sum "
                         f"(fused_mm.py:289-295), not {kind!r}")


def supports_tpu(graph: CompiledGraph) -> bool:
    """The JAX package's ecc_ldpc_tpu/decode/pallas/fused_mm.py `supports`:
    both incidence operators, double-buffered, within 100 MiB of VMEM."""
    n_pad = -(-graph.n // 128) * 128
    e_pad = -(-graph.m // 128) * 128 * graph.dc_max
    return 2 * 2 * 4 * n_pad * e_pad <= 100 * 1024 * 1024


def tpu_flooding_precision(graph: CompiledGraph, kind: str = "minsum"):
    """The precision of the JAX package's fused kernel on the TPU
    (`/pallas`, mxu_dtype "auto"): bf16 matmul inputs for min-sum where
    the kernel fits (supports_tpu), else f32 (spa; minstar, which it
    refuses; graphs past its VMEM, which the port decodes in f32)."""
    return BF16 if kind == "minsum" and supports_tpu(graph) else None


def _plain_tables(graph: CompiledGraph, device):
    t = graph.to(device)
    return (t.cn_vn.long(), t.cn_mask.unsqueeze(-1), t.vn_edge.long(),
            t.vn_mask.unsqueeze(-1))


def _syndrome_fail(cn_vn, mask3, total: torch.Tensor) -> torch.Tensor:
    """bool [B]: some check of the hard decisions (total < 0) fails."""
    at_checks = (total < 0).to(torch.int32)[cn_vn]  # [m, dc, B]
    par = torch.where(mask3, at_checks, 0).sum(1) & 1
    return (par != 0).any(0)


def flooding_with_posteriors_plain(graph: CompiledGraph, llr: torch.Tensor, *,
                                   kind: str = "minsum", alpha=1.0, beta=0.0,
                                   max_iters: int = 25,
                                   early_term: bool = True, precision=None):
    """(DecodeResult, posteriors f32 [B, n]) of the plain flooding decode of
    llr f32 [B, n], on llr's device; `precision` None or ("bf16",), the
    TPU's bf16 matmul inputs (the module docstring)."""
    precision = check_precision(precision)
    check_args(graph, kind, alpha, beta, precision)
    rule = get_rule(kind, float(alpha), float(beta))
    cn_vn, mask3, vn_edge, vn_mask = _device_tables(graph, llr.device, "plain",
                                                    _plain_tables)
    B = llr.shape[0]
    rd = round_bf16 if precision is not None else (lambda x: x)
    llr_t = llr.to(torch.float32).t().contiguous()  # [n, B]
    V = torch.where(mask3, rd(llr_t)[cn_vn], 0.0)
    total = llr_t

    def sweep(V):
        C = rule(V, mask3, 1)
        Cv = rd(C.reshape(graph.m * graph.dc_max, B)[vn_edge])  # [n, dv, B]
        s = torch.zeros_like(llr_t)
        for j in range(graph.dv_max):  # the oracle's masked sum, in order
            s = s + torch.where(vn_mask[:, j], Cv[:, j], 0.0)
        new_total = llr_t + s
        return torch.where(mask3, rd(new_total)[cn_vn] - C, 0.0), new_total

    if early_term:
        done = ~_syndrome_fail(cn_vn, mask3, total)
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        for _ in range(max_iters):
            if bool(done.all()):
                break
            newV, new_total = sweep(V)
            fail = _syndrome_fail(cn_vn, mask3, new_total)
            V = torch.where(done.view(1, 1, B), V, newV)
            total = torch.where(done.view(1, B), total, new_total)
            iters += (~done).to(torch.int32)
            done = done | ~fail
        ok = done
    else:
        for _ in range(max_iters):
            V, total = sweep(V)
        ok = ~_syndrome_fail(cn_vn, mask3, total)
        iters = torch.full((B,), max_iters, dtype=torch.int32,
                           device=llr.device)
    bits = (total < 0).to(torch.uint8).t().contiguous()
    return DecodeResult(bits=bits, ok=ok, iterations=iters), total.t()


def flooding_decode_plain(graph: CompiledGraph, llr: torch.Tensor, *,
                          kind: str = "minsum", alpha=1.0, beta=0.0,
                          max_iters: int = 25, early_term: bool = True,
                          precision=None) -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    return flooding_with_posteriors_plain(
        graph, llr, kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
        early_term=early_term, precision=precision)[0]


def _kernel_tables(graph: CompiledGraph, device):
    """(cn int32 [dc][m], vn int32 [n][dv]): each check slot's variable,
    slot-major (slot j of check i at j * m + i), and each variable slot's
    message row in the kernel's slot-major message layout (edge i*dc + j at
    row j * m + i); -1 where padded."""
    cn = np.where(graph.cn_mask, graph.cn_vn, -1).astype(np.int32)
    e = graph.vn_edge.astype(np.int64)
    row = (e % graph.dc_max) * graph.m + e // graph.dc_max
    vn = np.where(graph.vn_mask, row, -1).astype(np.int32)
    return (torch.as_tensor(cn.T.copy().ravel(), device=device),
            torch.as_tensor(vn.ravel(), device=device))


@dataclasses.dataclass(frozen=True)
class FloodingPlan:
    """How K2 cuts a batch: tiles of `frames` frames, each held by one
    block of `threads` threads for the whole decode, `blocks` blocks
    expected resident (one an SM) taking tiles from a counter. Form "chip":
    a tile's state (`words` f32 a frame: posteriors and messages, and the
    LLRs where `llr_chip`) in `smem` bytes of dynamic shared memory; form
    "global": a frame's state does not fit a block, so each resident block
    holds its tile in a slab of a device-memory scratch (smem 0)."""

    frames: int     # F: frames per tile
    threads: int    # threads per block
    smem: int       # dynamic shared bytes per block
    tiles: int      # ceil(B / F)
    blocks: int     # blocks the plan expects resident
    form: str       # "chip" or "global"
    llr_chip: bool  # the LLRs held on chip too
    words: int      # f32 words of one frame's state in the tile
    # the kernel build's row width (csrc/flooding.cu); above MAX_DC the
    # wide build, given as the row's degree
    width: int = 8

    @property
    def lanes(self) -> int:
        """Frames a thread's item: 2 (8-byte shared-memory accesses) in the
        form "chip" with F even, up to MAX_DC_PAIRS wide, else 1."""
        return 2 if (self.form == "chip" and self.frames % 2 == 0
                     and self.width <= MAX_DC_PAIRS) else 1

    def as_dict(self) -> dict:
        return dict(dataclasses.asdict(self), lanes=self.lanes)


def _frame_words(graph: CompiledGraph, llr: bool) -> int:
    """f32 words of one frame's state: posteriors and every message slot of
    the padded check view, and the LLRs when held."""
    return graph.n * (2 if llr else 1) + graph.m * graph.dc_max


@functools.lru_cache(maxsize=256)
def flooding_plan(graph: CompiledGraph, batch: int, kind: str = "minsum",
                  sms: int = H100_SMS, track: bool = False,
                  frames: int = 0) -> FloodingPlan:
    """K2's plan for `batch` frames of `graph` on a card of `sms` SMs, one
    block an SM: the form "chip" where one frame's posteriors and messages
    fit a block's shared memory beside the static arrays, else "global".
    The waves of tiles are the fewest that the largest F allows (form
    "chip": what fits, at most CHIP_FRAMES; "global": GLOBAL_FRAMES; in
    track mode, where a tile runs until its slowest frame stops, at most
    TRACK_FRAMES), and F the smallest that fills them, so the tiles spread
    evenly over the SMs (B = 2048 at mackay1008: F = 8, 256 tiles, two
    waves on 132 SMs), rounded up to even in the form "chip", whose
    threads then take two frames an item. The LLRs go on chip where they
    fit beside the state at that F. `frames` > 0 sets F (a probe's
    override). Pure arithmetic; cached, since the wrapper asks on every
    launch."""
    if kind not in CN_KINDS:
        raise KeyError(f"flooding kind must be one of {CN_KINDS}, got {kind!r}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    room = _SMEM_BLOCK - _SMEM_STATIC

    def smem(F: int, llr: bool) -> int:
        return 4 * _round4(_frame_words(graph, llr) * F)

    fits = [F for F in range(1, _MAX_FRAMES + 1) if smem(F, False) <= room]
    form = "chip" if fits else "global"
    most = min(max(fits), CHIP_FRAMES) if fits else GLOBAL_FRAMES
    if track:
        most = min(most, TRACK_FRAMES)
    waves = -(-batch // (sms * most))
    F = -(-batch // (sms * waves))
    if form == "chip" and F > 1 and F % 2 and F < most:
        F += 1
    F = frames or F
    if form == "chip" and smem(F, False) > room:
        raise ValueError(f"{graph.name}: {F} frames do not fit a block")
    llr_chip = form == "chip" and smem(F, True) <= room
    cap = 1024 if graph.dc_max <= 8 else 512  # csrc st::max_threads
    width = next((w for w in WIDTHS if graph.dc_max <= w), graph.dc_max)
    plan = FloodingPlan(F, 0, smem(F, llr_chip) if form == "chip" else 0,
                        -(-batch // F), sms, form, llr_chip,
                        _frame_words(graph, llr_chip), width)
    items = max(graph.m, graph.n) * F // plan.lanes
    threads = min(cap, max(32, -(-items // 32) * 32))
    return dataclasses.replace(plan, threads=threads)


_RESIDENT = {}  # (library, kernel instance, plan shape, card) -> blocks


def resident_blocks(inst: tuple, plan: FloodingPlan, device: torch.device,
                    name: str = "flooding") -> int:
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs for the kernel
    instance `inst` of the library `name` launched by `plan` on `device`
    (queried once). Raises when no block of the plan fits."""
    key = (name, inst, plan.threads, plan.smem, str(device))
    if key not in _RESIDENT:
        lib = _lib(name, "flooding_blocks",
                   [ctypes.c_int] * (len(inst) + 2) + [ctypes.c_void_p])
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.flooding_blocks(*inst, plan.threads, plan.smem,
                                     ctypes.addressof(out))
        if rc != 0:
            _raise_launch(lib, name, rc)
        if out.value < 1:
            raise ValueError(f"flooding: no block of the plan {plan} fits "
                             f"the card")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _prepared(graph: CompiledGraph, dev: torch.device, B: int, kind: str,
              track: bool, frames: int = 0, name: str = "flooding"):
    """(plan, blocks to launch, instance, cn, vn) of a launch of the
    library `name`, kept per (graph, card, batch, kind, mode, library):
    the host work before a launch is time the card waits."""
    def build(g, d):
        if d not in _SMS:
            _SMS[d] = torch.cuda.get_device_properties(d).multi_processor_count
        plan = flooding_plan(g, B, kind, _SMS[d], track, frames)
        inst = (g.dc_max, _RULE_IDS[kind], int(track),
                int(plan.form == "global"), plan.lanes)
        blocks = min(plan.tiles, resident_blocks(inst, plan, d, name))
        return (plan, blocks, inst,
                *_device_tables(g, d, "kernel", _kernel_tables))

    return _device_tables(graph, dev,
                          ("launch", B, kind, track, frames, name), build)


def _launch(graph: CompiledGraph, llr: torch.Tensor, kind: str, alpha, beta,
            max_iters: int, early_term: bool, with_posteriors: bool = False,
            frames: int = 0, precision=None):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch; `frames`
    > 0 overrides the plan's F (bench/flooding_probe.py)."""
    precision = check_precision(precision)
    check_args(graph, kind, alpha, beta, precision)
    _check_llr(llr, graph.n, max_iters, "flooding_decode_cuda",
               "flooding_decode_plain")
    dev = llr.device
    B, n = llr.shape
    name = "flooding" if precision is None else "flooding_prec"
    plan, blocks, inst, cn, vn = _prepared(graph, dev, B, kind,
                                           bool(early_term), frames, name)
    # the tile counter, then (form "global") each block's slab of state
    slab = blocks * plan.words * plan.frames if plan.form == "global" else 0
    scratch = torch.empty(4 + slab, dtype=torch.int32, device=dev)
    at = scratch.data_ptr()
    wide = wide_scratch(graph.dc_max, kind, blocks * plan.threads, dev)
    bits = torch.empty((B, n), dtype=torch.uint8, device=dev)
    post = (torch.empty((B, n), dtype=torch.float32, device=dev)
            if with_posteriors else None)
    ok = torch.empty(B, dtype=torch.bool, device=dev)  # written as 0/1 bytes
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib(name, "flooding_decode", _ARGS)
    with torch.cuda.device(dev):
        rc = lib.flooding_decode(
            llr.data_ptr(), bits.data_ptr(), _ptr(post), ok.data_ptr(),
            iters.data_ptr(), at, cn.data_ptr(), vn.data_ptr(),
            at + 16 if slab else None, _ptr(wide), n, graph.m, graph.dc_max,
            graph.dv_max, B, max_iters, inst[1], float(alpha), float(beta),
            inst[2], plan.lanes, plan.frames, plan.tiles, int(plan.llr_chip),
            plan.threads, plan.smem, blocks,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, name, rc)
    flooding_decode_cuda.launches += 1
    flooding_decode_cuda.frames += B
    flooding_decode_cuda.launches_by_precision[describe(precision)] += 1
    flooding_decode_cuda.last_plan = plan, blocks
    return DecodeResult(bits=bits, ok=ok, iterations=iters), post


def flooding_decode_cuda(graph: CompiledGraph, llr: torch.Tensor, *,
                         kind: str = "minsum", alpha=1.0, beta=0.0,
                         max_iters: int = 25, early_term: bool = True,
                         precision=None) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the flooding kernel on the current stream (the f32 library, or for
    `precision` ("bf16",) the precision library, csrc/flooding.cu built
    with -DLAYERED_PREC=1). Raises on anything the kernel does not take;
    never falls back to the plain version."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term,
                   precision=precision)[0]


def flooding_with_posteriors_cuda(graph: CompiledGraph, llr: torch.Tensor, *,
                                  kind: str = "minsum", alpha=1.0, beta=0.0,
                                  max_iters: int = 25,
                                  early_term: bool = True, precision=None):
    """(DecodeResult, posteriors f32 [B, n]) of one launch: for holding the
    kernel against flooding_with_posteriors_plain."""
    return _launch(graph, llr, kind, alpha, beta, max_iters, early_term,
                   with_posteriors=True, precision=precision)


flooding_decode_cuda.launches = 0
flooding_decode_cuda.frames = 0
# per precision ("f32", "bf16"): the libraries are apart
flooding_decode_cuda.launches_by_precision = collections.Counter()
# the last launch's (FloodingPlan, blocks launched), for printing
flooding_decode_cuda.last_plan = None


def make_flooding_decoder(graph: CompiledGraph, *, kind: str = "minsum",
                          alpha=1.0, beta=0.0, max_iters: int = 25,
                          early_term: bool = True, device="cuda",
                          precision=None):
    """decode(llr [B, n]) -> DecodeResult: the plain version on CPU
    tensors, the CUDA kernel on CUDA tensors; `device` (default "cuda",
    which raises when CUDA is absent) is where its tables are built.
    `precision`: None or ("bf16",) (tpu_flooding_precision)."""
    precision = check_precision(precision)
    check_args(graph, kind, alpha, beta, precision)
    dev = resolve_device(device)
    kw = dict(kind=kind, alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term, precision=precision)
    if dev.type == "cuda":
        _device_tables(graph, dev, "kernel", _kernel_tables)
    else:
        _device_tables(graph, dev, "plain", _plain_tables)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return flooding_decode_plain(graph, llr, **kw)
        return flooding_decode_cuda(graph, llr, **kw)

    return decode
