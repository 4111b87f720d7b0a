"""The per-op micro-benchmarks' plain versions (E5-E7,
ecc_ldpc_tpu_torch/experiments/micro.py) against the TPU scripts' Pallas
kernels (experiments/micro_vpu.py, micro_vpu2.py) run in interpret mode.

The scripts call pl.pallas_call without interpret=True and size their
arrays by module globals, so each test patches pallas_call with
interpret=True and lowers Z, L, INNER and REPS (to [16, 128], 4 x 2), for
its own scope only. Same numpy-seeded inputs on both sides; outputs must be
identical, except E7 in bf16: there XLA:CPU's excess precision leaves
the last add of the sum in f32 where the TPU kernel's types (and the card)
round it, so the plain version is held to a numpy oracle that rounds after
every op (ml_dtypes' bfloat16), and the JAX run to the same oracle with
that one rounding left out.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import experiments.micro_vpu as jmv
import experiments.micro_vpu2 as jmv2
from ecc_ldpc_tpu_torch.experiments import micro, micro_vpu, micro_vpu2

torch.set_num_threads(1)

Z, L, INNER, REPS = 16, 128, 4, 2


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    for mod in (jmv, jmv2):
        for name, v in (("Z", Z), ("L", L), ("INNER", INNER),
                        ("REPS", REPS)):
            monkeypatch.setattr(mod, name, v)


def _x(dtype: str, seed: int = 0) -> np.ndarray:
    """f32 [Z, L]: integers inside the dtype's range for the integer
    types (so the f32 -> int cast is exact), scaled normals otherwise."""
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        lim = 100 if dtype == "int8" else 1000
        return rng.integers(-lim, lim, (Z, L)).astype(np.float32)
    return (3 * rng.standard_normal((Z, L))).astype(np.float32)


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _jax_ew(x: np.ndarray, dtype: str) -> np.ndarray:
    k = functools.partial(jmv._ew_kernel, dtype=jnp.dtype(dtype))
    out = pl.pallas_call(
        k, out_shape=(jax.ShapeDtypeStruct((Z, L), jnp.float32),))(x)[0]
    return np.asarray(out)


def _jax_roll(x: np.ndarray, dtype: str) -> np.ndarray:
    """micro_vpu.run's roll call, without the timing."""
    s = jnp.arange(8, dtype=jnp.int32) + 1
    k = functools.partial(jmv._roll_kernel, dtype=jnp.dtype(dtype))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,),
        in_specs=[pl.BlockSpec((Z, L), lambda b, *_: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=(pl.BlockSpec((Z, L), lambda b, *_: (0, 0),
                                memory_space=pltpu.VMEM),),
    )
    out = pl.pallas_call(
        k, grid_spec=grid_spec,
        out_shape=(jax.ShapeDtypeStruct((Z, L), jnp.float32),))(s, x)[0]
    return np.asarray(out)


def _jax_op(a: np.ndarray, b: np.ndarray, name: str) -> np.ndarray:
    kern = jmv2.make_kernel(jmv2.OPS[name])
    out = pl.pallas_call(
        kern, out_shape=(jax.ShapeDtypeStruct((Z, L), jnp.float32),))(a, b)[0]
    return np.asarray(out)


def _oracle_op(a: np.ndarray, b: np.ndarray, name: str,
               last_rounded: bool = True) -> np.ndarray:
    """micro_vpu2's chains in numpy, rounded to the dtype after every op
    (with last_rounded=False, every op but the last add of the sum, whose
    bf16 rounding XLA:CPU folds away with the cast to f32 that follows)."""
    t = a.dtype.type
    step = {"add": lambda x: x + b, "min": lambda x: np.minimum(x, b),
            "min_lax": lambda x: np.minimum(x, b),
            "abs": lambda x: np.abs(x) - b, "mul": lambda x: x * b,
            "cmpsel": lambda x: np.where(x < b, x + b, b)}[name]
    with np.errstate(over="ignore", invalid="ignore"):
        xs = [a + t(i) for i in range(micro.ILP)]
        for _ in range(INNER * REPS):
            xs = [step(x).astype(a.dtype) for x in xs]
        acc = xs[0]
        for x in xs[1:-1]:
            acc = (acc + x).astype(a.dtype)
        if last_rounded:
            return (acc + xs[-1]).astype(a.dtype).astype(np.float32)
        return acc.astype(np.float32) + xs[-1].astype(np.float32)


@pytest.mark.parametrize("dtype", micro.EW_DTYPES)
def test_ew_plain_matches_jax(small, dtype):
    x = _x(dtype)
    got = micro.ew(torch.from_numpy(x), dtype, INNER, REPS).numpy()
    assert got.dtype == np.float32 and got.shape == (Z, L)
    np.testing.assert_array_equal(got, _jax_ew(x, dtype))


@pytest.mark.parametrize("dtype", micro.ROLL_DTYPES)
def test_roll_plain_matches_jax(small, dtype):
    x = _x(dtype, seed=1)
    got = micro.roll(torch.from_numpy(x), dtype, INNER, REPS).numpy()
    np.testing.assert_array_equal(got, _jax_roll(x, dtype))
    # the whole chain is one roll by the shifts' sum (E6's library call)
    total = micro.roll_total(INNER, REPS) % Z
    one = torch.roll(torch.from_numpy(x).to(micro.TORCH_DTYPES[dtype]),
                     total, 0).float().numpy()
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("dtype", micro.OP_DTYPES)
@pytest.mark.parametrize("name", micro.OPS)
def test_op_plain_matches_jax(small, name, dtype):
    a, b = micro.op_inputs(dtype, Z, L, "cpu", seed=2)
    got = micro.op(a, b, name, INNER, REPS).numpy()
    an, bn = _to_np(a), _to_np(b)
    np.testing.assert_array_equal(got, _oracle_op(an, bn, name))
    ref = _jax_op(an, bn, name)
    if dtype == "bfloat16":
        # XLA:CPU's excess precision leaves the last add of the sum in f32
        # (the TPU kernel's types round it to bf16, as the card does): the
        # JAX run equals the per-op oracle with that one rounding left out
        np.testing.assert_array_equal(
            ref, _oracle_op(an, bn, name, last_rounded=False))
    else:
        np.testing.assert_array_equal(got, ref)


def test_inputs_and_bounds():
    a, b = micro.op_inputs("int32", Z, L, "cpu")
    assert a.dtype == torch.int32 and int(a.min()) >= 1 and int(a.max()) < 1000
    # one f32 element-step of E5: sub, min, add issue, abs rides along
    t = micro.ops_seconds("float32", 1, 1, micro.EW_STEP)
    assert t == pytest.approx(3 / (128 * 132 * 1.98e9))
    # an int32 abs takes a slot; packed bf16 issues two lanes a slot
    assert micro.ops_seconds("int32", 1, 1, micro.EW_STEP) == pytest.approx(
        4 / (128 * 132 * 1.98e9))
    assert micro.ops_seconds("bfloat16", 2, 1, ("add",)) == pytest.approx(
        micro.ops_seconds("float32", 1, 1, ("add",)))
    assert micro.roll_total() % micro.Z == 16


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((Z, L))
    before = (micro.ew_cuda.launches, micro.roll_cuda.launches,
              micro.op_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        micro.ew_cuda(x, "float32", 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        micro.roll_cuda(x, "bfloat16", 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        micro.op_cuda(x, x, "add", 1, 1)
    with pytest.raises(ValueError, match="whole 32-bit words"):
        micro.ew_cuda(torch.zeros((Z, 6)), "int8", 1, 1)
    assert (micro.ew_cuda.launches, micro.roll_cuda.launches,
            micro.op_cuda.launches) == before


@pytest.mark.parametrize("mod", [micro_vpu, micro_vpu2])
def test_main_runs_on_the_cpu(mod, capsys):
    assert mod.main(["--device", "cpu", "--inner", "1", "--reps", "1",
                     "--shapes", "tpu", "--tries", "1"]) == 0
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and "Gelem-op/s" in out


@pytest.mark.parametrize("mod", [micro_vpu, micro_vpu2])
def test_main_needs_the_card_unless_cpu(mod):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--inner", "1", "--reps", "1", "--shapes", "tpu"])


def test_build_all_builds_and_reuses(tmp_path, monkeypatch):
    """build_all with a stand-in nvcc that writes its -o file and a ptxas
    line: every named library is built once, and reused after."""
    from ecc_ldpc_tpu_torch import _build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info    : Used 15 registers" && '
                    'echo lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    built = _build.build_all(("micro_ops", "dcmajor"))
    assert set(built) == {"micro_ops", "dcmajor"}
    for name, v in built.items():
        assert "Used 15 registers" in v["ptxas"] and v["seconds"] > 0
        assert _build.library_path(name).read_text() == "lib\n"
    again = _build.build_all(("micro_ops",))
    assert again["micro_ops"]["seconds"] == 0.0
    assert "Used 15 registers" in again["micro_ops"]["ptxas"]
    assert not list((tmp_path / "kernels").glob("*.tmp"))
