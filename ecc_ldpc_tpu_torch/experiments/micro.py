"""The per-op micro-benchmarks' kernels (csrc/micro_ops.cu), their
wrappers and their plain versions.

  ew    experiments/micro_vpu.py::_ew_kernel (E5): x read as f32, cast to
        the dtype, inner * reps steps x <- min(x, |x - 1|) + 1, cast back.
  roll  experiments/micro_vpu.py::_roll_kernel (E6): inner * reps steps
        x <- roll(x, s[i % 8], axis 0) with s = 1..8, each warp of the
        kernel owning strips of whole word-columns (roll_plan; the
        register route's source map in Python is roll_source).
  op    experiments/micro_vpu2.py::make_kernel (E7): four chains x_i <-
        op(x_i, b), x_i = a + i, summed in the dtype, cast to f32.

`ew`, `roll` and `op` run the kernel on a CUDA tensor (counting its
launches) and the plain version on a CPU one. Every op is rounded to its
dtype (bf16 and f16 after every op, as the card's packed instructions and
PyTorch's elementwise ops do) and integer overflow wraps.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..bench.throughput import H100_HBM_BYTES_PER_S
from ..decode.layered_qc import _lib, _raise_launch

DTYPES = {"float32": 0, "bfloat16": 1, "int32": 2, "int16": 3, "int8": 4,
          "float16": 5}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32, "int16": torch.int16,
                "int8": torch.int8, "float16": torch.float16}
LANES = {"float32": 1, "int32": 1, "bfloat16": 2, "float16": 2, "int16": 2,
         "int8": 4}
EW_DTYPES = ("float32", "bfloat16", "int32", "int16", "int8", "float16")
ROLL_DTYPES = ("float32", "bfloat16", "int16")
OP_DTYPES = ("float32", "int32", "bfloat16")
OPS = ("add", "min", "min_lax", "abs", "mul", "cmpsel")
NOPS = {"add": 1, "min": 1, "min_lax": 1, "abs": 2, "mul": 1, "cmpsel": 3}
SHIFTS = tuple(range(1, 9))

# The TPU scripts' shapes and counts (micro_vpu.py:25-27,
# micro_vpu2.py:20-23), and the shape that fills the card: 132 of the
# TPU's [368, 128] tiles side by side.
Z, L = 368, 128
FULL_L = 132 * 128
EW_INNER, EW_REPS = 400, 64
OP_INNER, OP_REPS, ILP = 200, 32, 4

# The issue peak: an H100 SM issues at most four warp instructions a clock
# (one a scheduler), 128 32-bit lanes; no row of the CUDA C++ Programming
# Guide's arithmetic-throughput table for compute capability 9.0 exceeds
# that (its highest 32-bit rate is fp32 add and multiply, 128 results a
# clock an SM; 16-bit add and multiply are 256 as packed pairs). So a step
# of k ops on a word takes at least k issue slots, each serving the word's
# lanes (2 for bf16, f16 and int16 pairs, 4 for int8x4). A float abs is a
# source modifier of the next instruction and takes no slot; an integer
# abs takes one. At 1.98 GHz x 132 SMs.
H100_SMS, H100_CLOCK = 132, 1.98e9
ISSUE_LANES = 128
SHUFFLE_LANES = 32  # words an SM's shuffles deliver a clock

# E6's plan (csrc/micro_ops.cu): the register route holds K = ceil(Z / 32)
# slots of S strips a lane, S * K <= ROLL_WORDS, K <= ROLL_SLOTS, at most
# 128 registers a thread (two blocks of ROLL_BLOCK_WARPS warps an SM:
# ROLL_WAVE_WARPS warps in one wave); the shared route keeps two buffers
# of Z words a warp.
ROLL_SLOTS, ROLL_WORDS = 12, 96
ROLL_STRIPS = (1, 2, 4, 8)
ROLL_BLOCK_WARPS = 8
ROLL_WAVE_WARPS = 2 * ROLL_BLOCK_WARPS
H100_SMEM = 232448  # the shared memory a block can have
# each step's ops
EW_STEP = ("add", "abs", "min", "add")  # sub, abs, min, add
OP_STEP = {"add": ("add",), "min": ("min",), "min_lax": ("min",),
           "abs": ("abs", "add"), "mul": ("mul",),
           "cmpsel": ("cmp", "add", "sel")}


def ops_seconds(dtype: str, elems: int, steps: int, kinds) -> float:
    """The least seconds an H100 takes to issue `steps` steps of the ops
    `kinds` on `elems` values of `dtype` (the issue peak above)."""
    slots = sum(1 for k in kinds
                if not (k == "abs" and dtype.startswith(("float", "bfloat"))))
    return (elems / LANES[dtype]) * steps * slots / (
        ISSUE_LANES * H100_SMS * H100_CLOCK)


def roll_step_seconds(rows: int, cols: int, dtype: str, steps: int) -> float:
    """The least seconds an H100 takes to issue `steps` steps of the roll
    chain on [rows, cols] values of `dtype`: each step moves every 32-bit
    word once between lanes, and an SM shuffles 32 words a clock."""
    words = rows * cols // LANES[dtype]
    return steps * words / (SHUFFLE_LANES * H100_SMS * H100_CLOCK)


def bytes_seconds(nbytes: int) -> float:
    """The least seconds an H100 takes to move `nbytes` through HBM."""
    return nbytes / H100_HBM_BYTES_PER_S


def _check(x: torch.Tensor, dtype: str, who: str, table) -> None:
    if dtype not in table:
        raise KeyError(f"{who}: dtype must be one of {table}, got {dtype!r}")
    if not x.is_contiguous() or x.dim() != 2:
        raise ValueError(f"{who}: a contiguous 2-d tensor, got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % LANES[dtype]:
        raise ValueError(f"{who}: rows of {dtype} must hold whole 32-bit "
                         f"words ({LANES[dtype]} values), got {x.shape[1]}")


def _launch(entry: str, argtypes, *args) -> None:
    lib = _lib("micro_ops", entry, argtypes)
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        _raise_launch(lib, "micro_ops", rc)


def ew_plain(x: torch.Tensor, dtype: str, inner: int = EW_INNER,
             reps: int = EW_REPS) -> torch.Tensor:
    v = x.to(TORCH_DTYPES[dtype])
    one = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(inner * reps):
        v = torch.minimum(v, (v - one).abs()) + one
    return v.to(torch.float32)


def ew_cuda(x: torch.Tensor, dtype: str, inner: int = EW_INNER,
            reps: int = EW_REPS) -> torch.Tensor:
    _check(x, dtype, "ew_cuda", EW_DTYPES)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"ew_cuda needs a CUDA f32 tensor, got {x.device} "
                         f"{x.dtype}; the plain version is ew_plain")
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("micro_ops_ew",
                [ctypes.c_void_p] * 2 + [ctypes.c_long] + [ctypes.c_int] * 3
                + [ctypes.c_void_p],
                x.data_ptr(), o.data_ptr(), x.numel(), DTYPES[dtype], inner,
                reps, torch.cuda.current_stream(x.device).cuda_stream)
    ew_cuda.launches += 1
    return o


def roll_plain(x: torch.Tensor, dtype: str, inner: int = EW_INNER,
               reps: int = EW_REPS, shifts=SHIFTS) -> torch.Tensor:
    v = x.to(TORCH_DTYPES[dtype])
    for _ in range(reps):
        for i in range(inner):
            v = torch.roll(v, int(shifts[i % 8]), 0)
    return v.to(torch.float32)


def roll_total(inner: int = EW_INNER, reps: int = EW_REPS,
               shifts=SHIFTS) -> int:
    """The one shift the whole chain comes to (before the mod Z)."""
    return reps * sum(int(shifts[i % 8]) for i in range(inner))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def roll_plan(rows: int, cols: int, dtype: str, shifts: tuple = SHIFTS,
              sms: int = H100_SMS) -> dict:
    """E6's launch on [rows, cols] of `dtype`: each warp owns `strips`
    whole word-columns of every row (rw = cols / lanes of them). In
    registers where Z <= 32 * ROLL_SLOTS and every shift mod Z is below
    32, with the fewest strips a warp that fit one wave (ROLL_WAVE_WARPS
    warps an SM), else the most the registers take; otherwise in shared
    memory, one strip a warp. As few warps a block as reach every SM.
    Raises where neither route fits: no fallback. Cached (the timed
    launches would wait for it): the dict is shared, not to be changed."""
    if len(shifts) != 8:
        raise ValueError(f"the roll chain takes 8 shifts, got {len(shifts)}")
    red = tuple(int(s) % rows for s in shifts)
    rw = cols // LANES[dtype]
    slots = _ceil(rows, 32)
    if slots <= ROLL_SLOTS and max(red) < 32:
        route = "registers"
        fits = [s for s in ROLL_STRIPS if s * slots <= ROLL_WORDS]
        strips = next((s for s in fits
                       if _ceil(rw, s) <= ROLL_WAVE_WARPS * sms), fits[-1])
        most = ROLL_BLOCK_WARPS
    else:
        route, strips = "shared", 1
        most = min(ROLL_BLOCK_WARPS, H100_SMEM // (8 * rows))
        if most < 1:
            raise ValueError(f"roll: {rows} rows do not fit one warp's "
                             f"shared memory (two buffers of {rows} words)")
    warps = _ceil(rw, strips)
    per_block = max(1, min(most, _ceil(warps, sms)))
    return {"route": route, "slots": slots, "strips": strips,
            "warps": warps, "warps_per_block": per_block,
            "blocks": _ceil(warps, per_block), "shifts": red}


def roll_cover(plan: dict, rows: int, rw: int):
    """[rows, rw] int: how many times the plan's launch stores each word
    (the kernels' indexing: global warp g, strip j, lane l, slot k holds
    word-column S g + j, row l + 32 k)."""
    import numpy as np

    count = np.zeros((rows, rw), np.int64)
    strips = plan["strips"]
    z = (32 * np.arange(_ceil(rows, 32))[:, None] + np.arange(32)).ravel()
    z = z[z < rows]
    for g in range(plan["blocks"] * plan["warps_per_block"]):
        for j in range(strips):
            c = g * strips + j
            if c < rw:
                count[z, c] += 1
    return count


def roll_source(rows: int, s: int):
    """[K, 32] int: the row whose word slot k of lane l takes in one step
    of shift s (0 <= s < 32, s < rows) on the register route, as the
    kernel's shuffles give it (-1 where slot k of lane l holds no row)."""
    import numpy as np

    K = _ceil(rows, 32)
    lane = np.arange(32)
    src, wsrc = (lane - s) & 31, (lane - s + rows) & 31
    # the wrap's sender m sends its last slot's row where that slot holds
    # one (m < rows - 32 (K - 1)), else the slot before's
    sent = np.where(lane < rows - 32 * (K - 1), K - 1, max(K - 2, 0))
    prev = 32 * sent[wsrc] + wsrc
    out = np.empty((K, 32), np.int64)
    for k in range(K):
        t = 32 * k + src
        out[k] = np.where(lane >= s, t, prev)
        prev = t
    out[32 * np.arange(K)[:, None] + lane >= rows] = -1
    return out


def roll_cuda(x: torch.Tensor, dtype: str, inner: int = EW_INNER,
              reps: int = EW_REPS, shifts=SHIFTS) -> torch.Tensor:
    _check(x, dtype, "roll_cuda", ROLL_DTYPES)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"roll_cuda needs a CUDA f32 tensor, got {x.device} "
                         f"{x.dtype}; the plain version is roll_plain")
    Z, cols = x.shape
    plan = roll_plan(Z, cols, dtype, tuple(shifts),
                     torch.cuda.get_device_properties(
                         x.device).multi_processor_count)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("micro_ops_roll",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
                x.data_ptr(), o.data_ptr(),
                (ctypes.c_int * 8)(*plan["shifts"]), Z, cols, DTYPES[dtype],
                inner, reps, ("registers", "shared").index(plan["route"]),
                plan["strips"], plan["warps_per_block"], plan["blocks"],
                torch.cuda.current_stream(x.device).cuda_stream)
    roll_cuda.launches += 1
    roll_cuda.last_plan = plan
    return o


def _op_step(name: str, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if name == "add":
        return x + b
    if name in ("min", "min_lax"):
        return torch.minimum(x, b)
    if name == "abs":
        return x.abs() - b
    if name == "mul":
        return x * b
    if name == "cmpsel":
        return torch.where(x < b, x + b, b)
    raise KeyError(f"op must be one of {OPS}, got {name!r}")


def op_plain(a: torch.Tensor, b: torch.Tensor, name: str,
             inner: int = OP_INNER, reps: int = OP_REPS) -> torch.Tensor:
    xs = [a + torch.tensor(i, dtype=a.dtype, device=a.device)
          for i in range(ILP)]
    for _ in range(inner * reps):
        xs = [_op_step(name, x, b) for x in xs]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc.to(torch.float32)


def op_cuda(a: torch.Tensor, b: torch.Tensor, name: str,
            inner: int = OP_INNER, reps: int = OP_REPS) -> torch.Tensor:
    dtype = str(a.dtype).removeprefix("torch.")
    _check(a, dtype, "op_cuda", OP_DTYPES)
    if name not in OPS:
        raise KeyError(f"op must be one of {OPS}, got {name!r}")
    if a.device.type != "cuda":
        raise ValueError(f"op_cuda needs CUDA tensors, got {a.device}; the "
                         f"plain version is op_plain")
    if b.dtype != a.dtype or b.shape != a.shape or not b.is_contiguous() \
            or b.device != a.device:
        raise ValueError("a and b must be contiguous, of one dtype, shape "
                         "and device")
    o = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _launch("micro_ops_op",
                [ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_int] * 4
                + [ctypes.c_void_p],
                a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel(),
                DTYPES[dtype], OPS.index(name), inner, reps,
                torch.cuda.current_stream(a.device).cuda_stream)
    op_cuda.launches += 1
    return o


ew_cuda.launches = 0
roll_cuda.launches = 0
roll_cuda.last_plan = None
op_cuda.launches = 0


def ew(x, dtype, inner=EW_INNER, reps=EW_REPS):
    """E5: the kernel on a CUDA tensor, the plain version on a CPU one."""
    fn = ew_cuda if x.device.type == "cuda" else ew_plain
    return fn(x, dtype, inner, reps)


def roll(x, dtype, inner=EW_INNER, reps=EW_REPS, shifts=SHIFTS):
    """E6: the kernel on a CUDA tensor, the plain version on a CPU one."""
    fn = roll_cuda if x.device.type == "cuda" else roll_plain
    return fn(x, dtype, inner, reps, shifts)


def op(a, b, name, inner=OP_INNER, reps=OP_REPS):
    """E7: the kernel on CUDA tensors, the plain version on CPU ones."""
    fn = op_cuda if a.device.type == "cuda" else op_plain
    return fn(a, b, name, inner, reps)


def op_inputs(dtype: str, rows: int, cols: int, device, seed: int = 0):
    """(a, b) as micro_vpu2.py draws them: integers in [1, 1000) for int32,
    standard normals otherwise, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if dtype == "int32":
        a = rng.integers(1, 1000, (rows, cols))
        b = rng.integers(1, 1000, (rows, cols))
    else:
        a = rng.standard_normal((rows, cols))
        b = rng.standard_normal((rows, cols))
    t = TORCH_DTYPES[dtype]
    # f64 -> f32 -> bf16, as jnp.asarray(np_f64, bf16) rounds
    cast = (lambda v: torch.as_tensor(v).to(torch.float32).to(t)) \
        if dtype == "bfloat16" else (lambda v: torch.as_tensor(v).to(t))
    return cast(a).to(device), cast(b).to(device)
