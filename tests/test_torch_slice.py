"""End to end on dvbs2/16200/12 (the main path's family at a quarter of its
length): the port's get_code -> encoder -> numpy-seeded LLRs ->
get_decoder(..., device="cpu") must be bit-identical with the JAX
package's layered decoder on the same LLRs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder as jax_layered
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu.learn import load_schedule as jax_load_schedule
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.convert import schedule_from_numpy
from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder
from ecc_ldpc_tpu_torch.encode.structured import build_encoder
from ecc_ldpc_tpu_torch.learn.schedules import load_schedule

torch.set_num_threads(1)

CODE = "dvbs2/16200/12"
SCHED = "dvbs2_64800_12_T25_op2"


@pytest.fixture(scope="module")
def slice_inputs():
    spec = get_code(CODE)
    rng = np.random.default_rng(2024)
    msg = rng.integers(0, 2, (4, spec.k), dtype=np.uint8)
    cw = build_encoder(spec)(torch.from_numpy(msg)).numpy()
    assert spec.check_syndrome(cw)
    ebn0_db = 1.2
    sigma = 1.0 / np.sqrt(2.0 * spec.rate * 10 ** (ebn0_db / 10))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    return spec, cw, llr


@pytest.mark.parametrize("spec_str", [
    "layered/norm:0.8125/3/noet",
    f"layered/sched:{SCHED}/3",
])
def test_slice_bit_identical(slice_inputs, spec_str):
    spec, cw, llr = slice_inputs
    graph = choose_graph(spec, spec_str)
    got = get_decoder(graph, spec_str, device="cpu")(torch.from_numpy(llr))
    jg = jax_compile_qc_graph(jax_get_code(CODE))
    if "sched" in spec_str:
        jp = jax_load_schedule(SCHED)
        ps = schedule_from_numpy(np.asarray(jp.alphas)[:3],
                                 np.asarray(jp.betas)[:3])
        mine = load_schedule(SCHED)
        assert np.array_equal(mine.alphas[:3], ps.alphas)
        assert np.array_equal(mine.betas[:3], ps.betas)
        dec = jax_layered(jg, alpha=jnp.asarray(ps.alphas),
                          beta=jnp.asarray(ps.betas), max_iters=3,
                          early_term=True)
    else:
        dec = jax_layered(jg, alpha=0.8125, max_iters=3, early_term=False)
    want = dec(jnp.asarray(llr))
    assert got.bits.shape == (4, spec.n)
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())
    # the decoder moved the frames toward the transmitted codewords
    hard = (llr < 0).astype(np.uint8)
    assert (got.bits.numpy() != cw).sum() < (hard != cw).sum()
