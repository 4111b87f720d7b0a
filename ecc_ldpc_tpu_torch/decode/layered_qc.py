"""Layered decoding on QC graphs: the plain PyTorch version and the
wrappers of its three CUDA kernels (csrc/layered_qc.cu, min-sum;
csrc/layered_exact.cu, exact BP; csrc/layered_classic.cu, every rule on
graphs that repeat a block-column in a layer). Check z of a block reads
variable graph/qc.var_index(z, s, Z, perm): (z + s) % Z on circulant graphs,
z ^ s on XOR-permutation graphs (IEEE 802.3an), which every kernel takes
as its XOR instantiation.

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
AR4JA, and any circulant or xor graph qc_graph_from_block_edges builds
with a block-column twice in a layer) it takes the oracle's other form:
count signs (v < 0) and posterior updates that accumulate each slot's
Cnew - Cold. It is the CPU path and the card's yardstick.

`layered_decode_cuda` (min-sum), `layered_exact_cuda` (spa, minstar) and
`layered_classic_cuda` (all three, multi-edge graphs) launch the kernels
that replace ecc_ldpc_tpu/decode/pallas/layered_qc.py::_kernel's
`sweep_delta`, `sweep_exact`, and `sweep_classic` with
`sweep_exact_classic`; on XOR graphs the min-sum kernel replaces
ecc_ldpc_tpu/decode/pallas/layered_xor.py::_kernel's layered `sweep` (K4),
scalar or per-iteration alpha/beta. `make_layered_decoder` picks one by
graph and rule. The min-sum and exact-BP kernels hold a tile of frames'
posteriors on chip (csrc/cluster_tile.cuh), the classic kernel and the QC
flooding kernel (decode/flooding_qc.py) a tile's whole decoder state,
posteriors and messages (csrc/state_tile.cuh), each by the plan
`tile_plan` gives for its form, and all read llr [B, n] directly.
Min-sum is bit-identical with the plain version in f32 (same operations in
the same order, no fused multiply-add, no reduction across frames); the
exact rules are too wherever the card's expf, logf, tanhf and log1pf are
the ones PyTorch's CUDA elementwise ops call.

All visit block-rows in QCGraph.layer_order and each row's edges in
layer_edges order, as the JAX package does.

Message precision (decode/quant.py): every decoder here also stores its
messages and LLRs in bf16 (`msg_dtype`, the Pallas kernel's storage,
which `tpu_msg_dtype` picks as the TPU did) or on the q:BITS:STEP grid
(`quant`), and the min-sum decoder on a xor graph rounds the operands of
its permutations to bf16 (`perm_dtype`, the TPU's XOR kernel, which
`tpu_precision` picks), the plain version by `precision`
(plain_with_posteriors), the kernels from their precision libraries
(_build.LIBRARIES: the sources built with -DLAYERED_PREC=1), so the f32
libraries stay as they were.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..graph.qc import PERMS, QCGraph, var_index
from .quant import (
    BF16,
    PERM,
    check_precision,
    describe,
    quant_limit,
    round_bf16,
    rounder,
)
from .types import DecodeResult

_MAG_CAP = 1e12
_SPA_TANH_CLIP = 1.0 - 1e-7  # keeps 2*atanh finite (layered.py:86)
_MINSTAR_IDENTITY = 1e9      # box-plus identity: a degree-1 row's message
_SIGN = -(1 << 31)           # the f32 sign bit as an int32
CN_RULES = ("minsum", "spa", "minstar")
# the cards' row widths: every tile kernel (the min-sum and exact-BP
# kernels of form "set", csrc/layered_qc.cu and csrc/layered_exact.cu; the
# classic kernel, csrc/layered_classic.cu; the QC flooding kernel,
# csrc/flooding_qc.cu, its MAX_DEG) holds a row in registers in 8- to
# 64-wide builds and takes any wider row in its wide build (the row walked
# in memory), as the plain versions take any degree.
MAX_DEG = 64
FLOODING_MAX_DEG = 64
_THREADS = 512  # threads per CUDA block at most (__launch_bounds__)
# csrc/cluster_tile.cuh, csrc/state_tile.cuh: shared memory a block may use
# on an H100, the kernels' static shared arrays (rounded up), frames per
# tile at most; the
# posteriors of block-columns a cluster of one cannot hold on chip that may
# be in flight in the L2 scratch (of its 50 MB, beside the check state)
_SMEM_BLOCK = 232_448
_SMEM_STATIC = 2304
_MAX_FRAMES = 64
SPILL_BUDGET = 24 << 20
# track mode: tiles for at least this many waves, where the batch allows,
# so clusters whose frames stop early take more tiles from the counter
TRACK_WAVES = 4
CLUSTER_SIZES = (1, 2, 4, 8, 16)
H100_SMS = 132


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
    """Raise on graphs this module does not decode: anything but a
    QCGraph (every QCGraph decodes, on either device)."""
    if not isinstance(graph, QCGraph):
        raise TypeError("layered decoding needs the port's QCGraph "
                        "(graph.qc.compile_qc_graph)")


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
        idx = np.concatenate([col * Z + var_index(z, s, Z, graph.perm)
                              for _, col, s in edges])
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
                 reverse=False, store=None, post_rounded=False,
                 post_store=None):
    """One layered iteration, in place on total [n, B] and C [BE, Z, B],
    with check rule `rule` (V [d, Z, B] -> Cnew). With `frozen` (bool [B],
    track mode) frozen frames keep their state exactly and the on-the-fly
    fail flag (layer parity or a sign flip) is returned.

    Posterior update: the set form total = V + Cnew where a layer touches
    each column once; with `accumulate` (a column repeated in the layer)
    the accumulate form of decode/xla/layered.py:187-234: every slot's
    rolled posterior is read first, then each slot in layer order (reverse
    for minstar: `reverse`) adds Cnew - Cold to its posteriors, and a sign
    flip is checked after each slot's add.

    `store` (decode/quant.rounder of a precision, or None for f32) rounds
    each message before it is stored, Q(Cnew), after track mode's freeze
    (Q(Cold) is Cold). The accumulate form then adds Q(Cnew) - Cold; the
    set form adds Q(Cnew) where `post_rounded` (q:, and bf16 in track
    mode), else the unrounded Cnew (the TPU kernel's bf16 fixed mode).
    `post_store` (("bf16-perm",): round_bf16) rounds each set-form
    posterior as it is written, V + Cnew passing the permutation back to
    the variables (layered_xor.py:175-178); its sign bit, which track mode
    compares, is the unrounded sum's."""
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
        Cq = Cnew if store is None else store(Cnew)
        if post_rounded:
            Cnew = Cq
        if accumulate:
            delta = Cq - Cold
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
            if post_store is not None:
                new = post_store(new)
            total[idx] = new.view(d * Z, B)
        C[eids] = Cq
    return fail


def plain_with_posteriors(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                          beta=0.0, max_iters: int = 25,
                          early_term: bool = True, cn: str = "minsum",
                          precision=None, sign_mode: str = "bitxor"):
    """(DecodeResult, posteriors f32 [B, n]) of the plain layered decode
    of llr f32 [B, n], on llr's device.

    `sign_mode` (the JAX package's decode_layered argument): "bitxor"
    takes signs from the sign bits on dup-free graphs, "count" from
    (v < 0) everywhere, as the training twin (learn/noms.py) does. Graphs
    that repeat a block-column in a layer count signs in either mode.

    `precision` (decode/quant.py): None (f32), ("bf16",) the TPU kernel's
    bf16 message and LLR storage, or ("q", bits, step) the fixed-point
    emulation of `layered/q:BITS:STEP`. Both round the LLRs loaded into
    the posteriors (the start-of-decode syndrome and the hard decisions
    read them) and every stored message; the set form's posterior takes
    the rounded message under q: and in bf16 track mode, the unrounded one
    in bf16 fixed mode (ecc_ldpc_tpu/decode/pallas/layered_qc.py:394,
    :376-380), and the accumulate form adds Q(Cnew) - Cold in every mode.
    ("bf16-perm",), the TPU's XOR kernel on a dup-free graph
    (layered_xor.py:74-85: a permutation is one bf16 matmul pass): every
    posterior a check reads, and every one a layer writes, is rounded to
    bf16, so the LLRs are rounded as they load (a frame done before its
    first sweep reports them so), the messages stay f32."""
    check_graph(graph)
    if sign_mode not in ("bitxor", "count"):
        raise KeyError(f"sign_mode must be bitxor/count, got {sign_mode!r}")
    B = llr.shape[0]
    Z = graph.Z
    alphas, betas, _ = _schedule(alpha, beta, max_iters, cn)
    precision = check_precision(precision)
    # graphs with a column repeated in a layer: count signs, accumulate form
    dup = not graph.intra_layer_dup_free
    if precision == PERM and (graph.perm != "xor" or dup or cn != "minsum"):
        raise ValueError(
            f"{graph.name}: ('bf16-perm',) is the TPU's XOR min-sum kernel "
            f"on a graph that repeats no block-column in a layer")
    store = rounder(precision)
    layers = _device_tables(graph, llr.device, "plain", _plain_layers)
    total = llr.to(torch.float32).t().contiguous()  # [n, B]
    if store is not None:
        total = store(total)
    C = torch.zeros((graph.num_block_edges, Z, B), dtype=torch.float32,
                    device=llr.device)
    form = dict(accumulate=dup, reverse=dup and cn == "minstar")
    if precision == PERM:
        form.update(post_store=round_bf16)
    elif precision is not None:
        form.update(store=store,
                    post_rounded=post_rounded(precision, early_term))

    def rule(t):
        return _check_rule(cn, float(alphas[t]), float(betas[t]),
                           signbit=not dup and sign_mode == "bitxor")

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
                         early_term: bool = True, cn: str = "minsum",
                         precision=None,
                         sign_mode: str = "bitxor") -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult, in plain PyTorch on llr's device."""
    return plain_with_posteriors(graph, llr, alpha=alpha, beta=beta,
                                 max_iters=max_iters, early_term=early_term,
                                 cn=cn, precision=precision,
                                 sign_mode=sign_mode)[0]


def post_rounded(precision, track: bool) -> bool:
    """Whether a set-form layer adds the rounded message Q(Cnew) to the
    posteriors: under q: always; under bf16 in track mode only, since the
    TPU kernel's fixed mode adds the unrounded one and stores the rounded
    (ecc_ldpc_tpu/decode/pallas/layered_qc.py:394 against :376-380)."""
    return precision is not None and (precision != BF16 or track)


def _kernel_table(graph: QCGraph, device):
    """int32 [mb+1 + 2*BE]: layer_ptr, then the column and shift of every
    sweep slot (layer_order, then layer_edges order). The kernels read a
    shift by the graph's perm: add mod Z (roll) or xor (xor)."""
    ptr, col, shift = [0], [], []
    for i in graph.layer_order:
        for _, c, s in graph.layer_edges(i):
            col.append(c)
            shift.append(s)
        ptr.append(len(col))
    tab = np.asarray(ptr + col + shift, np.int32)
    return torch.as_tensor(tab, device=device)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the tile kernels cut a batch: tiles of `frames` frames, each held
    for the whole decode by a cluster of `cluster` blocks. Rank r of a
    cluster owns rows z = r (mod cluster) of every block-column (`rows` of
    each) and the checks of the same rows. `form` "set" (the min-sum and
    exact-BP kernels, csrc/cluster_tile.cuh): `chip` block-columns live in
    the ranks' shared memory, the rest (a cluster of one only) in the tile's
    L2 scratch, as `home` says (column_homes), and the check state in HBM
    slabs of `stride` words. Forms "classic" (csrc/layered_classic.cu) and
    "flooding" (csrc/flooding_qc.cu), csrc/state_tile.cuh: every
    block-column and every message on chip (chip = nb, stride 0), and in
    flooding the LLRs too where `llr_chip`. `slot` and `message_slot` are
    the index maps."""

    cluster: int    # CS: blocks per cluster, a power of two dividing Z
    frames: int     # F: frames per tile
    rows: int       # R = Z / CS: rows of every block-column a rank owns
    tiles: int      # ceil(B / F)
    stride: int     # words of one layer's check-state slab per rank
    threads: int    # threads per block
    smem: int       # dynamic shared bytes per block
    clusters: int   # clusters the plan expects resident (sms // CS)
    chip: int       # block-columns held in shared memory
    home: tuple = dataclasses.field(repr=False)  # [nb] column -> k or -1-j
    form: str = "set"
    llr_chip: bool = False  # flooding: the LLRs held in shared memory

    @property
    def lg_cluster(self) -> int:
        return self.cluster.bit_length() - 1

    @property
    def spill(self) -> int:
        """Block-columns in the L2 scratch."""
        return len(self.home) - self.chip

    def slot(self, col, z, f):
        """(rank, f32 word in that rank's posterior buffer) of row z of
        block-column col, frame f of the tile; rank -1 for the tile's L2
        scratch, [spill, Z, F] (numpy arrays welcome)."""
        h = np.asarray(self.home)[col]
        Z = self.rows * self.cluster
        on = h >= 0
        rank = np.where(on, z % self.cluster, -1)
        word = np.where(on, (h * self.rows + z // self.cluster) * self.frames,
                        ((-1 - h) * Z + z) * self.frames) + f
        return rank, word

    def message_slot(self, s, z, f):
        """(rank, f32 word in that rank's message buffer) of sweep slot s's
        message to check z, frame f of the tile (forms "classic" and
        "flooding"; numpy arrays welcome): the rank that owns the check."""
        rank = np.asarray(z) % self.cluster
        word = (np.asarray(s) * self.rows
                + np.asarray(z) // self.cluster) * self.frames + f
        return rank, word

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        del d["home"]
        return dict(d, spill=self.spill)


def column_homes(graph: QCGraph, chip: int) -> tuple:
    """[nb]: the on-chip slot k of each block-column, or -1 - j for the
    j-th one left in the L2 scratch. A layer step waits for its slowest
    check, so a layer that reads a spilled column pays the L2 latency: the
    nb - chip spilled columns are picked one at a time, each the one that
    brings the fewest new layers into that set, then the lowest degree,
    then the lowest index (on a DVB-S2 table, a run of adjacent degree-2
    parity columns)."""
    layers = [set() for _ in range(graph.nb)]
    for r, c in zip(graph.be_row, graph.be_col):
        layers[c].add(int(r))
    spilled, tainted = [], set()
    left = set(range(graph.nb))
    for _ in range(graph.nb - chip):
        c = min(left, key=lambda c: (len(layers[c] - tainted),
                                     len(layers[c]), c))
        spilled.append(c)
        tainted |= layers[c]
        left.remove(c)
    home = [0] * graph.nb
    for k, c in enumerate(sorted(left)):
        home[c] = k
    for j, c in enumerate(spilled):
        home[c] = -1 - j
    return tuple(home)


FORMS = ("set", "classic", "flooding")


def min_sum_words(d: int) -> int:
    """Words of the min-sum kernel's state a check of degree d
    (csrc/layered_qc.cu: Minsum::NW, mag1, mag2, then the signs and the
    slot of mag2 in one word to degree 16, two to 32, three to 64; the wide
    build's MinsumWide, mag1, mag2, the slot, and ceil(d/32) words of
    signs)."""
    if d <= MAX_DEG:
        return 3 if d <= 16 else 4 if d <= 32 else 5
    return 3 + -(-d // 32)


def wide_scratch(degree: int, cn: str, threads: int, device):
    """The wide minstar builds' per-thread scratch (`degree` floats, the
    graph's widest row, for each of `threads` threads of the grid: the
    forward box-plus prefixes), or None where the launch needs none."""
    if cn != "minstar" or degree <= MAX_DEG:
        return None
    return torch.empty(degree * threads, dtype=torch.float32, device=device)


def _state_words(graph: QCGraph, form: str, llr: bool) -> int:
    """f32 words of a form "classic" or "flooding" block per (row, frame):
    posteriors and messages, and the layered deltas (one layer's
    Cnew - Cold, dcb_max a check) or the flooding LLRs."""
    own = graph.dcb_max if form == "classic" else (graph.nb if llr else 0)
    return graph.nb + graph.num_block_edges + own


def _state_tables(graph: QCGraph, form: str) -> int:
    """Dynamic shared bytes of a form "classic" or "flooding" block's
    tables: per sweep slot a pointer and an offset (and flooding's per
    column edge the same), the row pointers, and the classic accumulate's
    barrier masks or flooding's column pointers."""
    BE, mb = graph.num_block_edges, graph.mb
    if form == "classic":
        return 12 * BE + 4 * (mb + 1) + 4 * mb * mask_words(graph.dcb_max)
    return 24 * BE + 4 * (mb + 1) + 4 * (graph.nb + 1)


def _threads_cap(graph: QCGraph, form: str) -> int:
    """Threads per block at most: the state forms' kernels take 1024 where
    the row degree is at most 8 (their __launch_bounds__; 64 registers a
    thread hold a check of 8 without spilling), else 512."""
    return 2 * _THREADS if form != "set" and graph.dcb_max <= 8 else _THREADS


def candidate_plans(graph: QCGraph, batch: int, cn: str = "minsum",
                    sms: int = H100_SMS, track: bool = False,
                    form: str = "set") -> list:
    """[(waves, SMs busy, TilePlan)] for each cluster size that fits
    `batch` frames of `graph` on a card of `sms` SMs, for the kernels of
    `form`. "set", the min-sum (cn="minsum") or exact-BP kernel: per block
    the posteriors held on chip (F x R f32 a block-column), two layers of
    check state (NW = 3-4 words a check for min-sum, d for exact BP) and the
    tables fit _SMEM_BLOCK; a cluster of several blocks holds every
    block-column; a cluster of one whose single frame does not fit leaves
    some in the L2 scratch (column_homes), up to SPILL_BUDGET bytes in
    flight. "classic" and "flooding": per block the whole state of its rows
    (_state_words, the flooding LLRs where they fit) and the tables. The
    waves of tiles at sms // CS clusters resident are the fewest the largest
    F that fits allows (in track mode, where a tile runs until its slowest
    frame stops, at least TRACK_WAVES where the batch allows), and F the
    smallest that fills them, so a small batch spreads over the card and
    waves end even."""
    if form not in FORMS:
        raise KeyError(f"form must be one of {FORMS}, got {form!r}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if graph.mb < 2 and form == "set":
        raise ValueError(f"{graph.name}: the tile kernels need >= 2 layers")
    Z, nb = graph.Z, graph.nb
    # words a check (min_sum_words; exact BP: every message)
    d = graph.dcb_max
    words = min_sum_words(d) if cn == "minsum" else d
    tab = (12 * graph.num_block_edges + 4 * (graph.mb + 1) + 4 * nb)
    room = _SMEM_BLOCK - _SMEM_STATIC
    plans = []
    for cs in CLUSTER_SIZES:
        clusters = sms // cs
        if Z % cs or clusters < 1:
            continue
        R = Z // cs

        def fit_set(F):
            """(block-columns on chip, dynamic shared bytes, False), or
            None."""
            rest = 8 * _round4(words * R * F) + tab
            left = room - rest
            if left < 0:
                return None
            chip = min(nb, left // (4 * R * F))
            while chip and 4 * _round4(chip * R * F) > left:
                chip -= 1
            spilled = (nb - chip) * Z * F * 4 * clusters
            if chip < nb and (cs > 1 or F > 1 or spilled > SPILL_BUDGET):
                return None
            return chip, 4 * _round4(chip * R * F) + rest, False

        def fit_state(F):
            """(nb, dynamic shared bytes, LLRs on chip), or None: the
            flooding LLRs on chip where they fit."""
            for llr in (True, False) if form == "flooding" else (False,):
                smem = (4 * _round4(_state_words(graph, form, llr) * R * F)
                        + _state_tables(graph, form))
                if smem <= room:
                    return nb, smem, llr
            return None

        fit = fit_set if form == "set" else fit_state
        fits = [F for F in range(1, _MAX_FRAMES + 1) if fit(F)]
        if not fits:
            continue
        waves = -(-batch // (clusters * max(fits)))
        if track:
            waves = max(waves, min(TRACK_WAVES, -(-batch // clusters)))
        F = -(-batch // (clusters * waves))
        chip, smem, llr = fit(F)
        tiles = -(-batch // F)
        items = R * F * (1 if form != "flooding" else max(graph.mb, nb))
        threads = min(_threads_cap(graph, form),
                      max(32, -(-items // 32) * 32))
        stride = _round4(words * R * F) if form == "set" else 0
        plans.append((-(-tiles // clusters), min(tiles, clusters) * cs,
                      TilePlan(cs, F, R, tiles, stride, threads, smem,
                               clusters, chip, column_homes(graph, chip),
                               form, llr)))
    return plans


@functools.lru_cache(maxsize=256)
def tile_plan(graph: QCGraph, batch: int, cn: str = "minsum",
              sms: int = H100_SMS, track: bool = False,
              form: str = "set") -> TilePlan:
    """The tile plan of the kernels of `form`, of candidate_plans: form
    "set", the smallest cluster among those with the fewest waves that
    keep at least 90% as many SMs busy as the busiest of them; forms
    "classic" and "flooding", whose barriers a cluster makes dearer (the
    layered accumulate form takes several a layer), the smallest cluster
    that keeps at least 90% as many SMs busy as the busiest plan, so a
    cluster holds a tile only where its frame fits no smaller one or a
    small batch would leave SMs idle. Raises ValueError when no plan fits.
    Cached: the wrappers ask for it on every launch, and working it out
    takes milliseconds of host time."""
    plans = candidate_plans(graph, batch, cn, sms, track, form)
    if not plans:
        what = (f"{graph.n} posteriors a frame" if form == "set" else
                f"{graph.n} posteriors and "
                f"{graph.num_block_edges * graph.Z} messages a frame")
        raise ValueError(
            f"{graph.name}: no tile plan fits: {what} on at most "
            f"{max(c for c in CLUSTER_SIZES if graph.Z % c == 0)}"
            f" blocks of {_SMEM_BLOCK} B")
    if form == "set":
        waves = min(w for w, _, _ in plans)
        plans = [q for q in plans if q[0] == waves]
    busy = max(u for _, u, _ in plans)
    return next(p for _, u, p in plans if 10 * u >= 9 * busy)


def classic_barriers(graph: QCGraph, cn: str) -> list:
    """Per layer in layer_order, the mask of visit positions q (bit q)
    before which the classic kernel's accumulate step takes a barrier:
    slots are visited in layer order (reversed for minstar), and a slot
    whose block-column an earlier slot wrote since the last barrier must
    wait for it (csrc/layered_classic.cu)."""
    masks = []
    for i in graph.layer_order:
        cols = [c for _, c, _ in graph.layer_edges(i)]
        order = range(len(cols) - 1, -1, -1) if cn == "minstar" \
            else range(len(cols))
        mask, since = 0, set()
        for q, j in enumerate(order):
            if cols[j] in since:
                mask |= 1 << q
                since = set()
            since.add(cols[j])
        masks.append(mask)
    return masks


def _source(name: str) -> str:
    """The source (csrc/<source>.cu, the prefix of its C symbols) of the
    library `name`: itself, or the layered source a _prec library builds."""
    from .. import _build

    return _build.LIBRARIES[name][0]


def _lib(name: str, entry: str, argtypes):
    """The built library `name` (_build.LIBRARIES) with `entry`'s
    signature set."""
    from .. import _build

    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{_source(name)}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _library(source: str, precision, perm: str = "roll") -> str:
    """The library of a layered source for a precision: its f32 build, or
    (bf16, q:, the xor kernel's bf16 permutations) its precision build,
    the xor half where it has one."""
    from .. import _build

    name = source if precision is None else f"{source}_prec"
    xor = f"{name}_xor"
    return xor if perm == "xor" and xor in _build.LIBRARIES else name


# each entry ends in the message precision (prec, post_round, step, lim;
# the classic kernel's without post_round) and the stream
_PREC_ARGS = [ctypes.c_int] * 2 + [ctypes.c_float] * 2
_QC_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 12 + _PREC_ARGS
            + [ctypes.c_void_p])
_EXACT_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 19 + _PREC_ARGS
               + [ctypes.c_void_p])
_CLASSIC_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 11
                 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_RESIDENT = {}  # (library, kernel instance, plan shape, card) -> clusters
_SMS = {}       # card -> its SM count


def resident_clusters(name: str, inst: tuple, plan: TilePlan,
                      device: torch.device) -> int:
    """cudaOccupancyMaxActiveClusters for the kernel instance `inst` of
    the library `name` launched by `plan` on `device` (queried once).
    Raises when no cluster of the plan fits."""
    key = (name, inst, plan.cluster, plan.threads, plan.smem, str(device))
    if key not in _RESIDENT:
        # the instance's ints, then cs, threads and smem, then the result
        entry = f"{_source(name)}_clusters"
        lib = _lib(name, entry,
                   [ctypes.c_int] * (len(inst) + 3) + [ctypes.c_void_p])
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(lib, entry)(
                *inst, plan.cluster, plan.threads, plan.smem,
                ctypes.addressof(out))
        if rc != 0:
            _raise_launch(lib, name, rc)
        if out.value < 1:
            raise ValueError(f"{name}: no cluster of the plan {plan} fits "
                             f"the card")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _plan_launch(name: str, inst: tuple, graph: QCGraph, llr: torch.Tensor,
                 cn: str, track: bool, with_posteriors: bool,
                 form: str = "set"):
    """(plan, resident clusters, scratch, the addresses the kernel takes
    for it, then bits, posteriors or None, ok, iters) of one tile-kernel
    launch. Form "set": the check state, the L2 scratch, the column homes
    and the tile counter, the three scratch buffers one allocation (the
    host work before a launch is time the card waits); forms "classic" and
    "flooding" keep their state on chip and take the tile counter alone."""
    dev, B, n = llr.device, llr.shape[0], graph.n
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tile_plan(graph, B, cn, _SMS[dev], track, form)
    clusters = min(plan.tiles, resident_clusters(name, inst, plan, dev))
    words = clusters * plan.cluster * graph.mb * plan.stride  # a multiple of 4
    spilled = clusters * plan.spill * graph.Z * plan.frames
    scratch = torch.empty(words + spilled + 1, dtype=torch.int32, device=dev)
    at = scratch.data_ptr()
    if form == "set":
        home = _device_tables(graph, dev, ("home", plan.home),
                              lambda g, d: torch.as_tensor(
                                  plan.home, dtype=torch.int32, device=d))
        ptrs = (at, at + 4 * words, home.data_ptr(),
                at + 4 * (words + spilled))
    else:
        ptrs = (at,)
    bits = torch.empty((B, n), dtype=torch.uint8, device=dev)
    post = (torch.empty((B, n), dtype=torch.float32, device=dev)
            if with_posteriors else None)
    ok = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    return plan, clusters, scratch, ptrs, bits, post, ok, iters


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _raise_launch(lib, name: str, rc: int) -> None:
    err = getattr(lib, f"{_source(name)}_error_string")(rc).decode()
    raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} ({err})")


def kernel_precision(msg_dtype=torch.float32, quant=None,
                     perm_dtype=torch.float32):
    """The precision (decode/quant.py) of a kernel wrapper's `msg_dtype`
    (torch.float32 or torch.bfloat16, as the JAX package's
    make_layered_pallas_decoder takes it, LLRs stored alike), `quant`
    (bits, step) or `perm_dtype` (torch.bfloat16: the operands of the
    permutations rounded, as the TPU's XOR kernel's one-pass matmuls
    round them): None, ("bf16",), ("q", bits, step) or ("bf16-perm",).
    Raises on two at once: they are different roundings."""
    for name, dt in (("msg_dtype", msg_dtype), ("perm_dtype", perm_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be torch.float32 or "
                            f"torch.bfloat16, got {dt}")
    bf16, perm = msg_dtype == torch.bfloat16, perm_dtype == torch.bfloat16
    if bf16 + (quant is not None) + perm > 1:
        raise ValueError(
            "msg_dtype=torch.bfloat16, quant=(bits, step) and "
            "perm_dtype=torch.bfloat16 are different roundings: pass one, "
            "not both of any two")
    if quant is not None:
        return check_precision(("q", *quant))
    return BF16 if bf16 else PERM if perm else None


def _prec_args(precision, track: bool) -> tuple:
    """(prec, post_round, step, lim) of csrc/cluster_tile.cuh's ct::Prec."""
    if precision is None:
        return 0, 0, 1.0, 0.0
    if precision == PERM:
        return 3, 0, 1.0, 0.0
    post = int(post_rounded(precision, track))
    if precision == BF16:
        return 1, post, 1.0, 0.0
    _, bits, step = precision
    return 2, post, step, quant_limit(bits)


def _minsum_args(graph: QCGraph, alpha, beta, max_iters: int,
                 early_term: bool, dev):
    """(alpha_t/beta_t table [2, T] on dev or None, alpha, beta, fast_mag)
    of the min-sum kernel; kept per graph for scalar alpha and beta, the
    host work before a launch being time the card waits."""
    scalar = np.ndim(alpha) == 0 and np.ndim(beta) == 0
    key = (("minsum", float(alpha), float(beta), max_iters, early_term),
           str(dev)) if scalar else None
    if key in graph.device_cache:
        return graph.device_cache[key]
    alphas, betas, per_iter = _schedule(alpha, beta, max_iters, "minsum")
    # beta == 0 and alpha >= 0, no schedule, every row degree >= 2
    fast_mag = not per_iter and float(betas[0]) == 0.0 and not early_term \
        and min(d for d, _ in graph.layer_groups) >= 2 \
        and float(alphas[0]) >= 0.0
    ab = (torch.as_tensor(np.stack([alphas, betas]), device=dev)
          if per_iter else None)
    out = ab, float(alphas[0]), float(betas[0]), fast_mag
    if scalar:
        graph.device_cache[key] = out
    return out


def _check_perm(graph: QCGraph, precision, cn: str) -> None:
    """Raise where ("bf16-perm",) is asked of what the TPU's XOR min-sum
    kernel did not decode (plain_with_posteriors's rule)."""
    if precision == PERM and (graph.perm != "xor" or cn != "minsum"
                              or not graph.intra_layer_dup_free):
        raise ValueError(
            f"{graph.name}: perm_dtype=torch.bfloat16 is the TPU's XOR "
            f"min-sum kernel's rounding, on xor graphs that repeat no "
            f"block-column in a layer")


def _launch_minsum(graph: QCGraph, llr: torch.Tensor, alpha, beta,
                   max_iters: int, early_term: bool, cn: str,
                   with_posteriors: bool = False, msg_dtype=torch.float32,
                   quant=None, perm_dtype=torch.float32):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch of the
    layered min-sum kernel on the current stream."""
    with trace.span("decode.prepare"):
        precision = kernel_precision(msg_dtype, quant, perm_dtype)
        if cn != "minsum":
            raise ValueError(f"the min-sum kernel runs minsum, not {cn!r}; "
                             f"spa and minstar are layered_exact_cuda's")
        _check_cuda_input(graph, llr, max_iters, "layered_decode_cuda")
        _check_perm(graph, precision, cn)
        dev, B, Z = llr.device, llr.shape[0], graph.Z
        ab, a0, b0, fast_mag = _minsum_args(graph, alpha, beta, max_iters,
                                            early_term, dev)
        tab = _device_tables(graph, dev, "kernel", _kernel_table)
        inst = (graph.dcb_max, int(early_term), int(fast_mag),
                int(graph.perm == "xor"))
        name = _library("layered_qc", precision)
        plan, clusters, scratch, ptrs, bits, post, ok, iters = _plan_launch(
            name, inst, graph, llr, cn, early_term, with_posteriors)
        lib = _lib(name, "layered_qc_decode", _QC_ARGS)
    with trace.launch(layered_decode_cuda, dev), torch.cuda.device(dev):
        rc = lib.layered_qc_decode(
            llr.data_ptr(), bits.data_ptr(), _ptr(post), ok.data_ptr(),
            iters.data_ptr(), *ptrs, tab.data_ptr(), _ptr(ab),
            Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, a0, b0,
            *inst[1:], plan.cluster, plan.lg_cluster, plan.frames,
            plan.tiles, plan.stride, plan.chip, plan.threads, plan.smem,
            clusters, *_prec_args(precision, early_term),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, name, rc)
    layered_decode_cuda.launches += 1
    layered_decode_cuda.launches_by_perm[graph.perm] += 1
    layered_decode_cuda.launches_by_precision[describe(precision)] += 1
    layered_decode_cuda.last_plan = plan, clusters, describe(precision)
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters), post


def layered_decode_cuda(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                        beta=0.0, max_iters: int = 25,
                        early_term: bool = True, cn: str = "minsum",
                        msg_dtype=torch.float32, quant=None,
                        perm_dtype=torch.float32) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the layered min-sum kernel on the current stream (the exact rules are
    layered_exact_cuda's), its roll or xor instantiation by graph.perm,
    with messages (and LLRs) stored in f32, in bf16 (`msg_dtype`) or on
    the q: grid (`quant` = (bits, step)), or on a xor graph with the
    permutations' operands rounded to bf16 (`perm_dtype`;
    kernel_precision). Raises on anything the kernel does not take; never
    falls back to the plain version."""
    return _launch_minsum(graph, llr, alpha, beta, max_iters, early_term,
                          cn, msg_dtype=msg_dtype, quant=quant,
                          perm_dtype=perm_dtype)[0]


def minsum_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                                alpha=1.0, beta=0.0, max_iters: int = 25,
                                early_term: bool = True, cn: str = "minsum",
                                msg_dtype=torch.float32, quant=None,
                                perm_dtype=torch.float32):
    """(DecodeResult, posteriors f32 [B, n]) of one launch of the layered
    min-sum kernel, for holding it against plain_with_posteriors."""
    return _launch_minsum(graph, llr, alpha, beta, max_iters, early_term, cn,
                          with_posteriors=True, msg_dtype=msg_dtype,
                          quant=quant, perm_dtype=perm_dtype)


layered_decode_cuda.launches = 0
# per block permutation: the roll and xor instantiations are kernels apart
layered_decode_cuda.launches_by_perm = dict.fromkeys(PERMS, 0)
# per message precision ("f32", "bf16", "q:BITS:STEP")
layered_decode_cuda.launches_by_precision = collections.Counter()
# the last launch's (TilePlan, clusters resident, precision), for printing
layered_decode_cuda.last_plan = None
# device time of the launches timed while a profiler window recorded
# (trace.launch): whole microseconds, and the launches resolved
layered_decode_cuda.device_us = 0
layered_decode_cuda.device_timed = 0


def _launch_exact(graph: QCGraph, llr: torch.Tensor, max_iters: int,
                  early_term: bool, cn: str, with_posteriors: bool = False,
                  msg_dtype=torch.float32, quant=None):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch of the
    exact-BP layered kernel on the current stream."""
    with trace.span("decode.prepare"):
        precision = kernel_precision(msg_dtype, quant)
        if cn not in ("spa", "minstar"):
            raise ValueError(
                f"the exact-BP kernel runs spa or minstar, not {cn!r}")
        _check_cuda_input(graph, llr, max_iters, "layered_exact_cuda")
        dev, B, Z = llr.device, llr.shape[0], graph.Z
        tab = _device_tables(graph, dev, "kernel", _kernel_table)
        inst = (graph.dcb_max, int(cn == "minstar"), int(early_term),
                int(graph.perm == "xor"))
        name = _library("layered_exact", precision, graph.perm)
        plan, clusters, scratch, ptrs, bits, post, ok, iters = _plan_launch(
            name, inst, graph, llr, cn, early_term, with_posteriors)
        wide = wide_scratch(graph.dcb_max, cn,
                            clusters * plan.cluster * plan.threads, dev)
        lib = _lib(name, "layered_exact_decode", _EXACT_ARGS)
    with trace.launch(layered_exact_cuda, dev), torch.cuda.device(dev):
        rc = lib.layered_exact_decode(
            llr.data_ptr(), bits.data_ptr(), _ptr(post), ok.data_ptr(),
            iters.data_ptr(), *ptrs, tab.data_ptr(), _ptr(wide),
            Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            *inst, plan.cluster, plan.lg_cluster, plan.frames, plan.tiles,
            plan.stride, plan.chip, plan.threads, plan.smem, clusters,
            *_prec_args(precision, early_term),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, name, rc)
    layered_exact_cuda.launches += 1
    layered_exact_cuda.frames += B
    layered_exact_cuda.launches_by_perm[graph.perm] += 1
    layered_exact_cuda.frames_by_perm[graph.perm] += B
    layered_exact_cuda.launches_by_precision[describe(precision)] += 1
    layered_exact_cuda.last_plan = plan, clusters, describe(precision)
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters), post


def layered_exact_cuda(graph: QCGraph, llr: torch.Tensor, *,
                       max_iters: int = 25, early_term: bool = True,
                       cn: str = "spa", msg_dtype=torch.float32,
                       quant=None) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the exact-BP layered kernel (csrc/layered_exact.cu) on the current
    stream, messages stored as layered_decode_cuda's. Raises on anything
    the kernel does not take; never falls back to the plain version."""
    return _launch_exact(graph, llr, max_iters, early_term, cn,
                         msg_dtype=msg_dtype, quant=quant)[0]


def exact_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                               max_iters: int = 25, early_term: bool = True,
                               cn: str = "spa", msg_dtype=torch.float32,
                               quant=None):
    """(DecodeResult, posteriors f32 [B, n]) of one launch of the
    exact-BP layered kernel: layered_exact_cuda plus the posteriors it
    leaves, for holding the kernel against plain_with_posteriors."""
    return _launch_exact(graph, llr, max_iters, early_term, cn,
                         with_posteriors=True, msg_dtype=msg_dtype,
                         quant=quant)


layered_exact_cuda.launches = 0
layered_exact_cuda.frames = 0  # frames decoded: the retry fallback's load
layered_exact_cuda.launches_by_perm = dict.fromkeys(PERMS, 0)
layered_exact_cuda.frames_by_perm = dict.fromkeys(PERMS, 0)
layered_exact_cuda.launches_by_precision = collections.Counter()
layered_exact_cuda.last_plan = None
layered_exact_cuda.device_us = 0  # as layered_decode_cuda's
layered_exact_cuda.device_timed = 0


def mask_words(degree: int) -> int:
    """32-bit words of a layer's barrier mask in the classic kernel's
    table: one to 32 slots, ceil(degree / 32) above."""
    return max(1, -(-degree // 32))


def _classic_table(graph: QCGraph, device, cn: str):
    """int32: _kernel_table, then the accumulate step's barrier masks
    (classic_barriers: minstar visits a layer's slots backward), each
    mask_words(dcb_max) words, the low word first."""
    W = mask_words(graph.dcb_max)
    masks = np.asarray([(m >> (32 * k)) & 0xFFFFFFFF
                        for m in classic_barriers(graph, cn)
                        for k in range(W)], np.uint32).view(np.int32)
    tab = np.concatenate([_kernel_table(graph, "cpu").numpy(), masks])
    return torch.as_tensor(tab, device=device)


def _launch_classic(graph: QCGraph, llr: torch.Tensor, alpha, beta,
                    max_iters: int, early_term: bool, cn: str,
                    with_posteriors: bool = False, msg_dtype=torch.float32,
                    quant=None):
    """(DecodeResult, posteriors f32 [B, n] or None) of one launch of the
    layered kernel for graphs that repeat a block-column in a layer."""
    alphas, betas, per_iter = _schedule(alpha, beta, max_iters, cn)
    precision = kernel_precision(msg_dtype, quant)
    _check_cuda_input(graph, llr, max_iters, "layered_classic_cuda",
                      classic=True)
    dev, B = llr.device, llr.shape[0]
    tab = _device_tables(graph, dev, ("classic", cn == "minstar"),
                         lambda g, d: _classic_table(g, d, cn))
    ab = (torch.as_tensor(np.stack([alphas, betas]), device=dev)
          if per_iter else None)
    inst = (graph.dcb_max, CN_RULES.index(cn), int(early_term),
            int(graph.perm == "xor"))
    name = _library("layered_classic", precision, graph.perm)
    plan, clusters, scratch, ptrs, bits, post, ok, iters = _plan_launch(
        name, inst, graph, llr, cn, early_term, with_posteriors, "classic")
    wide = wide_scratch(graph.dcb_max, cn,
                        clusters * plan.cluster * plan.threads, dev)
    lib = _lib(name, "layered_classic_decode", _CLASSIC_ARGS)
    prec, _, step, lim = _prec_args(precision, early_term)
    with torch.cuda.device(dev):
        rc = lib.layered_classic_decode(
            llr.data_ptr(), bits.data_ptr(), _ptr(post), ok.data_ptr(),
            iters.data_ptr(), *ptrs, tab.data_ptr(), _ptr(ab), _ptr(wide),
            graph.Z, graph.mb, graph.nb, graph.num_block_edges, B, max_iters,
            graph.dcb_max, float(alphas[0]), float(betas[0]), *inst[1:],
            plan.cluster, plan.lg_cluster, plan.frames, plan.tiles,
            plan.threads, plan.smem, clusters, prec,
            step, lim, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        _raise_launch(lib, name, rc)
    layered_classic_cuda.launches += 1
    layered_classic_cuda.frames += B
    layered_classic_cuda.launches_by_perm[graph.perm] += 1
    layered_classic_cuda.by_rule[cn] += 1
    layered_classic_cuda.frames_by_rule[cn] += B
    layered_classic_cuda.launches_by_precision[describe(precision)] += 1
    layered_classic_cuda.last_plan = plan, clusters, describe(precision)
    return DecodeResult(bits=bits, ok=ok.bool(), iterations=iters), post


def layered_classic_cuda(graph: QCGraph, llr: torch.Tensor, *, alpha=1.0,
                         beta=0.0, max_iters: int = 25,
                         early_term: bool = True, cn: str = "minsum",
                         msg_dtype=torch.float32, quant=None) -> DecodeResult:
    """llr f32 [B, n] on a CUDA device -> DecodeResult, by one launch of
    the layered kernel for graphs that repeat a block-column in a layer
    (csrc/layered_classic.cu: min-sum, spa and minstar in the accumulate
    form with count signs; its roll or xor instantiation by graph.perm,
    rows of any degree) on the current stream, messages stored as
    layered_decode_cuda's. Raises on anything the kernel does not take,
    dup-free graphs included; never falls back to the plain version."""
    return _launch_classic(graph, llr, alpha, beta, max_iters, early_term,
                           cn, msg_dtype=msg_dtype, quant=quant)[0]


def classic_with_posteriors_cuda(graph: QCGraph, llr: torch.Tensor, *,
                                 alpha=1.0, beta=0.0, max_iters: int = 25,
                                 early_term: bool = True, cn: str = "minsum",
                                 msg_dtype=torch.float32, quant=None):
    """(DecodeResult, posteriors f32 [B, n]) of one launch of the classic
    layered kernel, for holding it against plain_with_posteriors."""
    return _launch_classic(graph, llr, alpha, beta, max_iters, early_term,
                           cn, with_posteriors=True, msg_dtype=msg_dtype,
                           quant=quant)


layered_classic_cuda.launches = 0
layered_classic_cuda.frames = 0
layered_classic_cuda.launches_by_perm = dict.fromkeys(PERMS, 0)
layered_classic_cuda.launches_by_precision = collections.Counter()
# per rule: one kernel serves a retry decoder's primary and its fallback
layered_classic_cuda.by_rule = dict.fromkeys(CN_RULES, 0)         # launches
layered_classic_cuda.frames_by_rule = dict.fromkeys(CN_RULES, 0)  # frames
layered_classic_cuda.last_plan = None


def make_layered_decoder(graph: QCGraph, *, alpha=1.0, beta=0.0,
                         max_iters: int = 25, early_term: bool = True,
                         cn: str = "minsum", device="cuda",
                         msg_dtype=torch.float32, quant=None,
                         perm_dtype=torch.float32):
    """decode(llr [B, n]) -> DecodeResult. The decoder runs the plain
    version on CPU tensors and a CUDA kernel on CUDA tensors: on graphs
    that repeat a block-column in a layer the classic kernel for every
    rule, otherwise the min-sum or the exact-BP kernel by rule `cn`, each
    in its roll or xor instantiation by graph.perm. `device` (default
    "cuda", which raises when CUDA is absent) is where its tables are
    built up front. Exact rules ignore alpha/beta. Messages and LLRs are
    stored in f32, in bf16 (`msg_dtype`, the TPU kernel's storage:
    tpu_msg_dtype) or on the q: grid (`quant` = (bits, step)), or a xor
    graph's permutations round their operands to bf16 (`perm_dtype`, the
    TPU's XOR kernel: tpu_precision), on either device
    (kernel_precision)."""
    check_graph(graph)
    _schedule(alpha, beta, max_iters, cn)
    prec = dict(msg_dtype=msg_dtype, quant=quant)
    precision = kernel_precision(msg_dtype, quant, perm_dtype)
    _check_perm(graph, precision, cn)
    if precision == PERM:
        prec = dict(perm_dtype=perm_dtype)
    dev = resolve_device(device)
    kw = dict(alpha=alpha, beta=beta, max_iters=max_iters,
              early_term=early_term, cn=cn)
    if dev.type == "cuda":
        _device_tables(graph, dev, "kernel", _kernel_table)
    else:
        _device_tables(graph, dev, "plain", _plain_layers)

    def decode(llr: torch.Tensor) -> DecodeResult:
        if llr.device.type == "cpu":
            return layered_decode_plain(graph, llr, precision=precision, **kw)
        if not graph.intra_layer_dup_free:
            return layered_classic_cuda(graph, llr, **kw, **prec)
        if cn == "minsum":
            return layered_decode_cuda(graph, llr, **kw, **prec)
        return layered_exact_cuda(graph, llr, max_iters=max_iters,
                                  early_term=early_term, cn=cn, **prec)

    return decode


# The JAX package's Pallas layered kernel holds one tile of 128 frames in
# VMEM (ecc_ldpc_tpu/decode/pallas/layered_qc.py:70-99, `supports`): a
# sublane dim Z * R of at most 1024, R = 8 / gcd(Z, 8) packed replicas,
# and at most 118 MiB of state.
_TPU_TILE = 128
_TPU_SUBLANES = 1024
_TPU_STATE_BYTES = 118 * 1024 * 1024


def _tpu_fits(graph: QCGraph, msg_bytes: int, cn: str) -> bool:
    """The JAX kernel's `supports(graph, batch_tile=128, msg_bytes, kind=cn)`
    with its LLRs stored as its messages (llr_bytes = msg_bytes)."""
    if graph.perm != "roll":
        return False
    R = 8 // int(np.gcd(graph.Z, 8))
    if graph.Z * R > _TPU_SUBLANES:
        return False
    vrow = graph.dcb_max
    if cn == "minstar" and not graph.intra_layer_dup_free:
        vrow *= 2
    state = graph.Z * R * _TPU_TILE * (
        msg_bytes * graph.num_block_edges + 4 * graph.nb
        + msg_bytes * graph.nb + graph.nb + 4 * vrow)
    return state <= _TPU_STATE_BYTES


def tpu_msg_dtype(graph: QCGraph, cn: str = "minsum") -> torch.dtype:
    """The message (and LLR) storage the JAX package's Pallas layered
    kernel took for `graph` and rule `cn` on the TPU (decode/api.py:141-145
    there): torch.bfloat16 where the kernel fits its VMEM with 2-byte
    storage and not with 4-byte, else torch.float32. So f32 covers the
    graphs it fits at f32, xor graphs (its xor kernel stores f32) and the
    graphs it refuses at either width (ccsds/*, Z * R > 1024), on which
    the JAX package raises for `/pallas`; the port carries no VMEM
    envelope, so it decodes them, in f32."""
    if cn not in CN_RULES:
        raise KeyError(f"layered cn must be minsum/spa/minstar, got {cn!r}")
    if _tpu_fits(graph, 2, cn) and not _tpu_fits(graph, 4, cn):
        return torch.bfloat16
    return torch.float32


def xor_kernel_fits(graph: QCGraph, kind: str = "minsum",
                    schedule: str = "layered") -> bool:
    """The JAX package's ecc_ldpc_tpu/decode/pallas/layered_xor.py
    `supports(graph, batch_tile=256, msg_bytes=4, kind, schedule)`: a xor
    graph that repeats no block-column in a layer, min-sum, Z % 8 == 0,
    Z <= 1024, and its state with the one-hot permutation tables within
    100 MiB of VMEM."""
    if graph.perm != "xor" or kind != "minsum":
        return False
    if not graph.intra_layer_dup_free:
        return False
    Z, nb, BE = graph.Z, graph.nb, graph.num_block_edges
    if Z % 8 or Z > 1024:
        return False
    state = Z * 256 * (4 * BE + 12 * nb + 4 * graph.dcb_max
                       + (4 * nb if schedule == "flooding" else 0)) \
        + 2 * 4 * BE * Z * Z
    return state <= 100 * 1024 * 1024


def tpu_precision(graph: QCGraph, cn: str = "minsum"):
    """The precision (decode/quant.py) of the JAX package's Pallas layered
    decoder for `graph` and rule `cn` on the TPU (`/pallas`;
    ecc_ldpc_tpu/decode/api.py:107-149 there): on a xor graph its XOR
    kernel's bf16 permutations, ("bf16-perm",), where that kernel takes
    the graph (minsum, xor_kernel_fits); else the storage tpu_msg_dtype
    gives, ("bf16",) or None (f32). The JAX package refuses the rest of
    the xor graphs; the port decodes them in f32."""
    if graph.perm == "xor":
        return PERM if xor_kernel_fits(graph, cn) else None
    return BF16 if tpu_msg_dtype(graph, cn) == torch.bfloat16 else None
