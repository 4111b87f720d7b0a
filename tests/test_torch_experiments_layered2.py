"""The static-rows ablation kernels' plain version (E2, E3,
ecc_ldpc_tpu_torch/experiments/ablate.py) against the TPU scripts' Pallas
kernels (experiments/ablate_layered2.py, static_unroll.py) run in
interpret mode, on the z16 surrogate of tests/test_torch_layered_qc.py,
as tests/test_torch_experiments_layered.py does E1's (same patches: Bt 8,
ITERS 3, pallas_call with interpret=True, for the fixture's scope only).

E2's script returns a scalar a chunk, so its kernel runs here through a
pallas_call of its own with build()'s grid spec, for the whole bits
array. XLA:CPU may mis-execute a static-rows trace
(ecc_ldpc_tpu/decode/pallas/layered_qc.py:835-843), so E3 is also held to
E1's dynamic kernel (E1 full: E3 without the cap).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import experiments.ablate_layered as je1
import experiments.ablate_layered2 as je2
import experiments.static_unroll as je3
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.decode.pallas.layered_qc import sweep_layout
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.convert import graph_from_numpy
from ecc_ldpc_tpu_torch.experiments import ablate
from ecc_ldpc_tpu_torch.experiments.variants import (
    E2_VARIANTS,
    E3_FLAGS,
)

torch.set_num_threads(1)

BT, ITERS = 8, 3
E1_FLAGS = dict(roll_on=True, sign_on=True, min2_on=True, vrow_on=True,
                castq_on=True)
E2_FLAGS = dict(roll_on=True, sign_on=True, min2_on=True, vrow_on=True,
                sub_on=True)
# the scripts' variant tables (ablate_layered.py:150-159,
# ablate_layered2.py:157-166) as flag overrides
E2_OFF = {"full": (), "noroll": ("roll_on",), "nosign": ("sign_on",),
          "nomin2": ("min2_on",), "novrow": ("vrow_on",),
          "nosub": ("sub_on",), "floor": tuple(E2_FLAGS)}


@pytest.fixture(scope="module")
def z16():
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    jspec = jax_expand_qc(JaxQCCode(Z=16, base=base), name="test.z16",
                          k=8 * 16)
    jg = jax_compile_qc_graph(jspec)
    g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name)
    rng = np.random.default_rng(7)
    llr3 = (1.5 * rng.standard_normal((jg.nb, jg.Z, BT)) + 0.5).astype(
        np.float32)
    return jg, g, llr3


@pytest.fixture(scope="module")
def jax_bits(z16):
    """{(script, variant): bits int8 [nb, Z, Bt]} of E2's variants, E3 and
    E1 full, each built once with pallas_call in interpret mode."""
    jg, _, llr3 = z16
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    for mod in (je1, je2, je3):
        mp.setattr(mod, "Bt", BT)
        mp.setattr(mod, "ITERS", ITERS)
    try:
        out = {}
        for v, off in E2_OFF.items():
            flags = dict(E2_FLAGS, **{k: False for k in off})
            out["e2", v] = _e2_bits(jg, llr3, flags)
        out["e3", "full"] = np.asarray(je3.build_static(jg)(llr3))
        out["e1", "full"] = np.asarray(je1.build(jg, **E1_FLAGS)(llr3))
    finally:
        mp.undo()
    return out


def _e2_bits(jg, llr3, flags):
    """E2's kernel through a pallas_call of its own (build()'s grid spec),
    for the whole bits array."""
    groups, ge_be, ge_delta, _, _, dup_free = sweep_layout(jg)
    assert dup_free
    nb, Z, BE, dcb = jg.nb, jg.Z, jg.num_block_edges, jg.dcb_max
    tables = (ge_be, np.asarray(jg.be_col_np, np.int64), ge_delta)
    kern = functools.partial(je2._kernel, tables=tables, groups=groups,
                             nb=nb, Z=Z, **flags)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(1,),
        in_specs=[pl.BlockSpec((nb, Z, BT), lambda b: (0, 0, b),
                               memory_space=pltpu.VMEM)],
        out_specs=(pl.BlockSpec((nb, Z, BT), lambda b: (0, 0, b),
                                memory_space=pltpu.VMEM),),
        scratch_shapes=[pltpu.VMEM((nb, Z, BT), jnp.float32),
                        pltpu.VMEM((BE, Z, BT), jnp.bfloat16),
                        pltpu.VMEM((dcb, Z, BT), jnp.float32)],
    )
    out = pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=(jax.ShapeDtypeStruct((nb, Z, BT), jnp.int8),))(llr3)[0]
    return np.asarray(out)


def _port(z16, flags):
    _, g, llr3 = z16
    bits = ablate.decode3(g, torch.from_numpy(llr3), flags, ITERS)
    assert bits.dtype == torch.int8 and bits.shape == llr3.shape
    return bits.numpy()


@pytest.mark.parametrize("variant", list(E2_VARIANTS))
def test_e2_plain_matches_jax(z16, jax_bits, variant):
    got = _port(z16, E2_VARIANTS[variant])
    np.testing.assert_array_equal(got, jax_bits["e2", variant])


def test_e3_plain_matches_jax_and_e1_full(z16, jax_bits):
    got = _port(z16, E3_FLAGS)
    np.testing.assert_array_equal(got, jax_bits["e3", "full"])
    # E3 is E1 full without the cap, which these magnitudes never reach
    np.testing.assert_array_equal(got, jax_bits["e1", "full"])
    assert 0 < int(got.sum()) < got.size  # the decode is not trivial


def test_e2_variants_touch_the_bits(jax_bits):
    """The ablations change what is computed: each differs from full."""
    for (script, v), bits in jax_bits.items():
        if script == "e2" and v != "full":
            assert not np.array_equal(bits, jax_bits["e2", "full"]), v
