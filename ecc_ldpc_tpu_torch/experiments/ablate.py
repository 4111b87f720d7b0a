"""K1a's layered min-sum with its costs removed one at a time: the kernels
of csrc/ablate_layered.cu (E1 with runtime row tables; E2 and E3 with the
rows compiled in), their wrapper and their plain version.

The function is experiments/ablate_layered.py::_kernel's (E1),
ablate_layered2.py::_kernel's (E2) and static_unroll.py::_kernel_static's
(E3): `iters` fixed sweeps of layered normalised min-sum (alpha 0.8125,
sign-bit XOR signs) on a dup-free circulant graph, the messages stored in
bf16, no early stop, bits out. A variant is a set of flags
(experiments/variants.py); an ablated variant decodes wrongly on purpose
and keeps the dependency chain whole. On the card the kernels work on
variables, [B, n]; the TPU scripts skipped the decode's entry and exit
rotations and so read LLRs, and wrote bits, in the delta-shift storage
[nb, Z, B]: column c's row z holds variable (z + a0[c]) mod Z, a0[c] the
shift of the last block-edge of c in the sweep (sweep_layout's steady
state). `to_var` and `from_var` map the two (with the roll ablated no
rotation ever happens and the two are one layout), and `decode3` is the
TPU scripts' function on [nb, Z, B].

E1's kernel reads one word a slot from `e1_table`, which sorts every slot
by `slot_kinds` (early: read during the layer before; forwarded: that
layer's result in the same thread; late: read after its barrier);
`ablate_scheduled` runs the plain arithmetic in that schedule on the
host, so a CPU test shows the schedule legal where no card is.

Run `python -m ecc_ldpc_tpu_torch.experiments.ablate --write-header` to
regenerate csrc/ablate_static_dvbs2_64800_12.cuh, the static sweep's
tables (tests/test_torch_experiments_layered.py checks that it is current);
`static_rows` is the table the kernel builds from it.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import re
import sys

import numpy as np
import torch

from .. import _build
from ..codes.registry import get_code
from ..decode.layered_qc import (
    H100_SMS,
    _check_llr,
    _device_tables,
    _kernel_table,
    _lib,
    _raise_launch,
    candidate_plans,
)
from ..decode.quant import round_bf16
from ..graph.qc import QCGraph, compile_qc_graph
from .variants import (
    CAP,
    CASTQ,
    E1_VARIANTS,
    MIN2,
    ROLL,
    SIGN,
    SUB,
    VROW,
)

ITERS = 25
ALPHA = 0.8125
TILE = 128          # the TPU scripts' Bt: one tile, the latency regime
THROUGHPUT_B = 4096  # the headline's batch: the throughput regime
STATIC_CODE = "dvbs2/64800/12"
STATIC_HEADER = _build.CSRC / "ablate_static_dvbs2_64800_12.cuh"
_MAG_CAP = 1e12
_SIGN = -(1 << 31)
# E1's slots (slot_kinds, e1_table): rows of up to E1_DEG slots, each of
# one kind (0 in the table past a row's degree); E1_ROW table words a row
E1_DEG, E1_ROW = 8, 12
EARLY, FORWARDED, LATE = 1, 2, 3


def check_graph(graph: QCGraph) -> None:
    if not isinstance(graph, QCGraph) or graph.perm != "roll" \
            or not graph.intra_layer_dup_free:
        raise ValueError("the ablation kernels decode dup-free circulant "
                         "QC graphs (experiments/ablate_layered.py asserts "
                         "dup_free)")


def last_touch(graph: QCGraph) -> np.ndarray:
    """a0 [nb]: the shift of each block-column's last block-edge in the
    sweep (layer_order, then layer_edges order)."""
    a0 = np.zeros(graph.nb, np.int64)
    for i in graph.layer_order:
        for _, c, s in graph.layer_edges(i):
            a0[c] = s
    return a0


def _rows(graph: QCGraph, roll: bool, shift: int, device) -> torch.Tensor:
    """[nb, Z] long: for column c, the row (z + shift * a0[c]) mod Z."""
    a0 = last_touch(graph) if roll else np.zeros(graph.nb, np.int64)
    z = np.arange(graph.Z)
    idx = (z[None, :] + shift * a0[:, None]) % graph.Z
    return torch.as_tensor(idx, device=device)


def to_var(graph: QCGraph, llr3: torch.Tensor, roll: bool) -> torch.Tensor:
    """[nb, Z, B] in the delta-shift storage -> [B, n] on the variables:
    variable (c, w) is storage row (w - a0[c]) mod Z."""
    nb, Z, B = llr3.shape
    idx = _rows(graph, roll, -1, llr3.device)
    x = torch.gather(llr3, 1, idx[:, :, None].expand(nb, Z, B))
    return x.permute(2, 0, 1).reshape(B, nb * Z).contiguous()


def from_var(graph: QCGraph, x: torch.Tensor, roll: bool) -> torch.Tensor:
    """[B, n] on the variables -> [nb, Z, B] in the storage: storage row z
    of column c is variable (z + a0[c]) mod Z."""
    B = x.shape[0]
    nb, Z = graph.nb, graph.Z
    x3 = x.reshape(B, nb, Z).permute(1, 2, 0)
    idx = _rows(graph, roll, 1, x.device)
    return torch.gather(x3, 1, idx[:, :, None].expand(nb, Z, B)).contiguous()


def _layers(graph: QCGraph, flags: int, device) -> list:
    """Per layer in sweep order, per slot: (block-edge, the [Z] variables
    its checks read)."""
    z = torch.arange(graph.Z, device=device)
    return [[(e, c * graph.Z + ((z + s) % graph.Z if flags & ROLL else z))
             for e, c, s in graph.layer_edges(i)]
            for i in graph.layer_order]


def _row_rule(xs: list, olds: list, flags: int, alpha: float) -> tuple:
    """One layer's checks in the TPU kernels' operation order: xs the
    posteriors its slots read, olds their messages [B, Z]; returns (the
    slots' new posteriors, their new bf16 messages)."""
    dev = xs[0].device
    cap = torch.tensor(_MAG_CAP, dtype=torch.float32, device=dev)
    mask = torch.tensor(_SIGN, dtype=torch.int32, device=dev)
    min1 = min2 = torch.full_like(xs[0], float("inf"))
    sg = torch.zeros(xs[0].shape, dtype=torch.int32, device=dev)
    vals = []
    for x, old in zip(xs, olds):
        if flags & SUB:
            x = x - old
        vals.append(x)
        a = x.abs()
        if flags & MIN2:
            min2 = torch.minimum(min2, torch.maximum(min1, a))
        min1 = torch.minimum(min1, a)
        if flags & SIGN:
            sg = sg ^ x.view(torch.int32)
    mag1 = alpha * (torch.minimum(min1, cap) if flags & CAP else min1)
    mag2 = (alpha * (torch.minimum(min2, cap) if flags & CAP else min2)
            if flags & MIN2 else mag1)
    posts, msgs = [], []
    for x in vals:
        v = x if flags & VROW else min1
        mag = (torch.where(v.abs() == min1, mag2, mag1)
               if flags & MIN2 else mag1)
        if flags & SIGN:
            flip = (sg ^ v.view(torch.int32)) & mask
            cnew = (mag.view(torch.int32) | flip).view(torch.float32)
        else:
            cnew = mag
        cb = round_bf16(cnew)
        posts.append(v + (cb if flags & CASTQ else cnew))
        msgs.append(cb)
    return posts, msgs


def ablate_plain(graph: QCGraph, llr: torch.Tensor, flags: int,
                 iters: int = ITERS, alpha: float = ALPHA):
    """(bits uint8 [B, n], posteriors f32 [B, n]) of the variant `flags`
    on llr f32 [B, n], in the TPU kernels' operation order."""
    check_graph(graph)
    layers = _layers(graph, flags, llr.device)
    total = llr.clone()
    C = torch.zeros((graph.num_block_edges, llr.shape[0], graph.Z),
                    device=llr.device)
    for _ in range(iters):
        for edges in layers:
            posts, msgs = _row_rule([total[:, idx] for _, idx in edges],
                                    [C[e] for e, _ in edges], flags, alpha)
            for (e, idx), p, cb in zip(edges, posts, msgs):
                total[:, idx] = p
                C[e] = cb
    return (total < 0).to(torch.uint8), total


def slot_kinds(graph: QCGraph) -> list:
    """Per layer in sweep order, per slot: (kind, source), the sweep taken
    as cyclic (layer mb - 1 before layer 0 of the next sweep). EARLY: the
    layer before does not touch the slot's block-column, so its posterior
    can be read during that layer; FORWARDED from slot `source` of the
    layer before, which has the same block-column and shift, so the thread
    that wrote that row holds it; LATE: read after the layer before's
    barrier."""
    rows = [[(c, s) for _, c, s in graph.layer_edges(i)]
            for i in graph.layer_order]
    out = []
    for L, row in enumerate(rows):
        prev = {c: (k, s) for k, (c, s) in enumerate(rows[L - 1])}
        out.append([(EARLY, 0) if c not in prev else
                    (FORWARDED, prev[c][0]) if prev[c][1] == s else
                    (LATE, 0) for c, s in row])
    return out


def e1_table(graph: QCGraph, home, frames: int) -> np.ndarray:
    """E1's row table, int32 [mb * E1_ROW] (csrc/ablate_layered.cu): for
    layer L in sweep order, E1_ROW words from L * E1_ROW. Words 0..7 are
    its slots (zero past the degree), one word a slot: the shift times
    `frames` (bits 0-10), the block-column's slot on chip or in the L2
    scratch (11-21), the space (22: the L2 scratch, home < 0) and the kind
    of slot_kinds (23-24). Word 8 is the degree (bits 0-3) and the early,
    forwarded and late slots as masks (8-15, 16-23, 24-31; bit j is slot
    j), word 9 the slots in the L2 scratch as a mask."""
    rf = graph.Z * frames
    if graph.dcb_max > E1_DEG or rf > 2048 or graph.nb > 2048:
        raise ValueError(f"{graph.name}: rows of {graph.dcb_max} slots, "
                         f"{rf} rows a block-column, {graph.nb} columns; "
                         f"E1's table takes {E1_DEG}, 2048 and 2048")
    words = np.zeros((graph.mb, E1_ROW), np.int64)
    shift = {EARLY: 8, FORWARDED: 16, LATE: 24}
    for L, (i, kinds) in enumerate(zip(graph.layer_order,
                                       slot_kinds(graph))):
        edges = graph.layer_edges(i)
        words[L, E1_DEG] = len(edges)
        for j, ((_, c, s), (kind, _)) in enumerate(zip(edges, kinds)):
            h = home[c]
            words[L, j] = (s * frames | (h if h >= 0 else -1 - h) << 11
                           | (h < 0) << 22 | kind << 23)
            words[L, E1_DEG] |= 1 << (shift[kind] + j)
            words[L, E1_DEG + 1] |= (h < 0) << j
    return words.astype(np.uint32).view(np.int32).reshape(-1)


def ablate_scheduled(graph: QCGraph, llr: torch.Tensor, flags: int,
                     iters: int = ITERS, alpha: float = ALPHA):
    """ablate_plain's result in E1's schedule (slot_kinds): in each layer
    step an EARLY slot takes the posterior read during the step before,
    ahead of that step's writes, a FORWARDED slot the step before's new
    value of its source slot, a LATE slot the posterior after the step
    before's writes; the first step reads every slot late. Equal to
    ablate_plain bit for bit where the schedule is legal."""
    check_graph(graph)
    kinds = slot_kinds(graph)
    layers = _layers(graph, flags, llr.device)
    total = llr.clone()
    C = torch.zeros((graph.num_block_edges, llr.shape[0], graph.Z),
                    device=llr.device)
    steps = iters * graph.mb
    early, prev = {}, []
    for g in range(steps):
        L = g % graph.mb
        edges = layers[L]
        xs = []
        for j, ((_, idx), (kind, k)) in enumerate(zip(edges, kinds[L])):
            kind = LATE if g == 0 else kind
            xs.append(early[j] if kind == EARLY else
                      prev[k] if kind == FORWARDED else total[:, idx])
        nxt = (L + 1) % graph.mb
        early = {j: total[:, idx] for j, (_, idx) in enumerate(layers[nxt])
                 if kinds[nxt][j][0] == EARLY}
        prev, msgs = _row_rule(xs, [C[e] for e, _ in edges], flags, alpha)
        for (e, idx), p, cb in zip(edges, prev, msgs):
            C[e] = cb
            total[:, idx] = p
    return (total < 0).to(torch.uint8), total


@functools.lru_cache(maxsize=64)
def ablate_plan(graph: QCGraph, batch: int, sms: int = H100_SMS):
    """The plan the ablation kernels run: K1a's plan with a cluster of one
    (decode/layered_qc.candidate_plans), the one K1a's tile_plan picks on
    a dvbs2/64800 batch of 119 frames or more. Cached: working it out
    takes milliseconds of host time, which a timed launch would wait for."""
    for _, _, plan in candidate_plans(graph, batch, "minsum", sms):
        if plan.cluster == 1:
            return plan
    raise ValueError(f"{graph.name}: no plan of a cluster of one fits")


def static_header(graph: QCGraph, plan) -> str:
    """The text of csrc/ablate_static_dvbs2_64800_12.cuh for `graph` and
    its plan: the shapes, and one ROW(layer, degree, home, shift, ...) a
    layer in sweep order, each slot's column home (plan.home) and
    shift."""
    rows = []
    for L, i in enumerate(graph.layer_order):
        edges = graph.layer_edges(i)
        hs = ", ".join(f"{plan.home[c]}, {s}" for _, c, s in edges)
        rows.append(f"  ROW({L}, {len(edges)}, {hs})")
    return "\n".join([
        f"// {graph.name}'s static sweep for csrc/ablate_layered.cu, made by",
        "// python -m ecc_ldpc_tpu_torch.experiments.ablate --write-header",
        "// from the port's tables and the cluster-of-one plan (one frame a",
        "// block; home >= 0 an on-chip slot, -1 - j the L2 scratch's j-th).",
        "#pragma once",
        f"constexpr int kStaticZ = {graph.Z};",
        f"constexpr int kStaticMb = {graph.mb};",
        f"constexpr int kStaticNb = {graph.nb};",
        f"constexpr int kStaticBE = {graph.num_block_edges};",
        f"constexpr int kStaticDeg = {graph.dcb_max};",
        f"constexpr int kStaticChip = {plan.chip};",
        f"constexpr int kStaticStride = {plan.stride};",
        "#define ABLATE_STATIC_ROWS(ROW) \\",
        " \\\n".join(rows),
        "",
    ])


def static_rows(header: str) -> dict:
    """The table csrc/ablate_layered.cu's static form builds from the
    header text at compile time, as its constexpr code does: "shapes", the
    distinct row shapes in sweep order of first use (degree | the slots in
    the L2 scratch << 4 | the slots of shift 0 << 12), and "rows", one
    (layer, shape index, each slot's column byte offset, each slot's shift)
    a ROW line in the header's order."""
    z = int(re.search(r"kStaticZ = (\d+);", header).group(1))
    lines = re.findall(r"ROW\(([-\d, ]+)\)", header)
    shapes, rows = [], []
    for ln in lines:
        layer, d, *hs = map(int, ln.split(","))
        homes, shifts = hs[0::2], hs[1::2]
        key = d
        for j in range(d):
            key |= (homes[j] < 0) << (4 + j) | (shifts[j] == 0) << (12 + j)
        if key not in shapes:
            shapes.append(key)
        offs = [(h if h >= 0 else -1 - h) * z * 4 for h in homes]
        rows.append((layer, shapes.index(key), offs, shifts))
    return {"shapes": shapes, "rows": rows}


@functools.cache
def static_graph() -> QCGraph:
    return compile_qc_graph(get_code(STATIC_CODE))


def _check_static(graph: QCGraph, plan) -> None:
    """Raise unless the static libraries' tables are this graph's and
    plan's (the header is current and the plan one frame a block)."""
    key = ("ablate_static", plan.home, plan.chip, plan.frames, plan.stride)
    if key in graph.device_cache:
        return
    if plan.frames != 1 or STATIC_HEADER.read_text() != static_header(
            graph, plan):
        raise ValueError(
            f"{graph.name} (plan F={plan.frames}, {plan.chip} columns on "
            f"chip) is not the static sweep's {STATIC_CODE} at one frame a "
            f"block; the static libraries take only that")
    graph.device_cache[key] = True


_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [ctypes.c_float]
         + [ctypes.c_void_p])
_SMS = {}


def library_of(flags: int, static: bool) -> str:
    """The library that holds the variant: ablate_layered (E1's dynamic
    instances) or the static library of those flags."""
    if not static:
        if flags not in E1_VARIANTS.values():
            raise ValueError(f"flags {flags} are not one of E1's variants "
                             f"{E1_VARIANTS}")
        return "ablate_layered"
    if flags not in _build.ABLATE_STATIC_FLAGS:
        raise ValueError(f"no static library holds flags {flags} "
                         f"({_build.ABLATE_STATIC_FLAGS})")
    return f"ablate_static_{flags}"


def e1_smem(graph: QCGraph, plan) -> int:
    """E1's dynamic shared bytes: the on-chip posteriors, the two check-
    state slabs, the row table and the homes (K1a's tables in the plan's
    bytes stay unused)."""
    rf = graph.Z * plan.frames
    return 4 * (-(-plan.chip * rf // 4) * 4 + 2 * plan.stride
                + graph.mb * E1_ROW + graph.nb)


def ablate_cuda(graph: QCGraph, llr: torch.Tensor, flags: int,
                iters: int = ITERS, alpha: float = ALPHA,
                static: bool = False, with_posteriors: bool = False):
    """(bits uint8 [B, n], posteriors f32 [B, n] or None) of one launch of
    the variant `flags` on llr f32 [B, n] on the card: E1's dynamic
    kernel (its table: e1_table), or with `static` the static sweep
    (dvbs2/64800/12 only). Raises on anything the kernels do not take; no
    fallback."""
    _check_llr(llr, graph.n, max(iters, 1), "ablate_cuda", "ablate_plain")
    check_graph(graph)
    name = library_of(flags, static)
    dev, B = llr.device, llr.shape[0]
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ablate_plan(graph, B, _SMS[dev])
    if static:
        _check_static(graph, plan)
        smem = plan.smem
        tab = _device_tables(graph, dev, "kernel", _kernel_table)
    else:
        if graph.dcb_max > E1_DEG or -(-graph.Z * plan.frames
                                       // plan.threads) > 2:
            raise ValueError(
                f"{graph.name}: rows of {graph.dcb_max} slots, "
                f"{graph.Z * plan.frames} checks a tile on {plan.threads} "
                f"threads; E1's kernel takes {E1_DEG} and two a thread")
        smem = e1_smem(graph, plan)
        tab = _device_tables(
            graph, dev, ("e1", plan.home, plan.frames),
            lambda g, d: torch.as_tensor(
                e1_table(g, plan.home, plan.frames), device=d))
    blocks = min(plan.tiles, _SMS[dev])
    words = blocks * graph.mb * plan.stride
    spilled = blocks * plan.spill * graph.Z * plan.frames
    scratch = torch.empty(words + spilled, dtype=torch.int32, device=dev)
    home = _device_tables(graph, dev, ("home", plan.home),
                          lambda g, d: torch.as_tensor(
                              plan.home, dtype=torch.int32, device=d))
    bits = torch.empty((B, graph.n), dtype=torch.uint8, device=dev)
    post = (torch.empty((B, graph.n), dtype=torch.float32, device=dev)
            if with_posteriors else None)
    lib = _lib(name, "ablate_layered_decode", _ARGS)
    with torch.cuda.device(dev):
        rc = lib.ablate_layered_decode(
            llr.data_ptr(), bits.data_ptr(),
            None if post is None else post.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * words, home.data_ptr(), tab.data_ptr(),
            graph.Z, graph.mb, graph.nb, graph.num_block_edges, B, iters,
            graph.dcb_max, flags, plan.frames, plan.tiles, plan.stride,
            plan.chip, plan.threads, smem, blocks, alpha,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise_launch(lib, name, rc)
    ablate_cuda.launches += 1
    ablate_cuda.launches_by_library[name] += 1
    ablate_cuda.last_plan = plan, blocks
    return bits, post


ablate_cuda.launches = 0
ablate_cuda.launches_by_library = collections.Counter()
ablate_cuda.last_plan = None


def ablate(graph, llr, flags, iters=ITERS, alpha=ALPHA, static=False):
    """bits uint8 [B, n]: the kernel on a CUDA tensor, the plain version on
    a CPU one."""
    if llr.device.type == "cuda":
        return ablate_cuda(graph, llr, flags, iters, alpha, static)[0]
    return ablate_plain(graph, llr, flags, iters, alpha)[0]


def decode3(graph: QCGraph, llr3: torch.Tensor, flags: int,
            iters: int = ITERS, alpha: float = ALPHA,
            static: bool = False) -> torch.Tensor:
    """The TPU scripts' function: llr3 f32 [nb, Z, B] in the delta-shift
    storage -> bits int8 [nb, Z, B] in the storage of each column's last
    touch."""
    roll = bool(flags & ROLL)
    bits = ablate(graph, to_var(graph, llr3, roll), flags, iters, alpha,
                  static)
    return from_var(graph, bits, roll).to(torch.int8)


def inputs3(graph: QCGraph, batch: int, device, seed: int = 0,
            mean: float = 2.0):
    """The TPU scripts' LLRs, standard normals + 2 (ablate_layered.py:139),
    [nb, Z, batch] f32, drawn on `device` from a torch generator seeded
    with `seed` (a full batch is 265M values; `mean` lower for a noisier
    decode)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((graph.nb, graph.Z, batch), generator=gen,
                       device=device) + mean


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv != ["--write-header"]:
        print("usage: python -m ecc_ldpc_tpu_torch.experiments.ablate "
              "--write-header")
        return 2
    graph = static_graph()
    STATIC_HEADER.write_text(static_header(graph, ablate_plan(graph,
                                                              THROUGHPUT_B)))
    print(STATIC_HEADER)
    return 0


if __name__ == "__main__":
    sys.exit(main())
