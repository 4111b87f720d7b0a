"""The port's plain layered min-sum against the JAX package's layered
oracle (decode/xla/layered.py) and its Pallas kernel in interpret mode.

Same graph (carried across with convert.graph_from_numpy), same LLR array
from a numpy seed: bits, ok and iterations must be bit-identical in f32 —
same operations in the same order, no fused multiply-add, no reduction
across frames.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ecc_ldpc_tpu.codes.qc import expand_qc as jax_expand_qc
from ecc_ldpc_tpu.decode.pallas.layered_qc import make_layered_pallas_decoder
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder as jax_layered
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder as JaxDDE
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.convert import graph_from_numpy, schedule_from_numpy
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    _kernel_table,
    _plain_layers,
    layered_decode_plain,
    make_layered_decoder,
)

torch.set_num_threads(1)

T = 8
B = 32


@pytest.fixture(scope="module")
def z16():
    """The z16 surrogate of tests/pallas/test_layered_qc.py, both packages."""
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    jspec = jax_expand_qc(JaxQCCode(Z=16, base=base), name="test.z16",
                          k=8 * 16)
    jg = jax_compile_qc_graph(jspec)
    g = graph_from_numpy(jg.Z, jg.mb, jg.nb, jg.k, jg.be_row_np,
                         jg.be_col_np, jg.be_shift_np, jg.name)
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 2, (B, jspec.k), dtype=np.uint8)
    cw = JaxDDE(jspec).encode_numpy(msg)
    sigma = 0.62
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    al = rng.uniform(0.6, 1.1, T).astype(np.float32)
    be = rng.uniform(0.0, 0.25, T).astype(np.float32)
    return jg, g, llr, schedule_from_numpy(al, be)


CASES = [
    ("fixed", 0.8125, 0.0), ("track", 0.8125, 0.0),
    ("fixed", 0.8125, 0.25), ("track", 0.8125, 0.25),
    ("fixed", "sched", None), ("track", "sched", None),
]


def _params(z16, alpha, beta):
    if alpha == "sched":
        ps = z16[3]
        return ps.alphas, ps.betas
    return alpha, beta


def _assert_same(ref, res):
    assert res.bits.dtype == torch.uint8 and res.ok.dtype == torch.bool
    assert res.iterations.dtype == torch.int32
    assert np.array_equal(np.asarray(ref.bits), res.bits.numpy())
    assert np.array_equal(np.asarray(ref.ok), res.ok.numpy())
    assert np.array_equal(np.asarray(ref.iterations), res.iterations.numpy())


@pytest.mark.parametrize("ref", ["oracle", "pallas_interpret"])
@pytest.mark.parametrize("mode,alpha,beta", CASES)
def test_plain_bit_identical_to_jax(z16, ref, mode, alpha, beta):
    jg, g, llr, _ = z16
    a, b = _params(z16, alpha, beta)
    et = mode == "track"
    if ref == "oracle":
        dec = jax_layered(jg, alpha=a, beta=b, max_iters=T, early_term=et)
    else:
        dec = make_layered_pallas_decoder(
            jg, alpha=jnp.asarray(a) if alpha == "sched" else a,
            beta=jnp.asarray(b) if alpha == "sched" else b,
            max_iters=T, early_term=et, batch_tile=B, interpret=True)
    want = dec(jnp.asarray(llr))
    got = layered_decode_plain(g, torch.from_numpy(llr), alpha=a, beta=b,
                               max_iters=T, early_term=et)
    _assert_same(want, got)
    if et:
        # the batch exercises the freeze: some frames stop early, some not
        its = got.iterations.numpy()
        assert its.min() < T and got.ok.any()


def test_decoder_dispatch_on_cpu(z16):
    jg, g, llr, _ = z16
    dec = make_layered_decoder(g, alpha=0.8125, max_iters=4, device="cpu")
    x = torch.from_numpy(llr)
    a = dec(x)
    b = layered_decode_plain(g, x, alpha=0.8125, max_iters=4)
    assert torch.equal(a.bits, b.bits) and torch.equal(a.iterations,
                                                       b.iterations)


def test_kernel_table_follows_sweep_order(z16):
    """The CUDA kernel's slot table visits the same (column, shift)
    sequence as the plain version's gather indices."""
    _, g, _, _ = z16
    tab = _kernel_table(g, "cpu").numpy()
    mb, BE, Z = g.mb, g.num_block_edges, g.Z
    assert tab.shape == (mb + 1 + 2 * BE,)
    ptr = tab[:mb + 1]
    col, shift = tab[mb + 1:mb + 1 + BE], tab[mb + 1 + BE:]
    assert ptr[0] == 0 and ptr[-1] == BE
    for L, (idx, _, d) in enumerate(_plain_layers(g, "cpu")):
        s = slice(ptr[L], ptr[L + 1])
        assert d == ptr[L + 1] - ptr[L]
        z = np.arange(Z)
        want = np.concatenate([c * Z + (z + sh) % Z
                               for c, sh in zip(col[s], shift[s])])
        assert np.array_equal(idx.numpy(), want)
