"""The port's with_retry against the JAX package's, and the production
retry decoder on the stored trapping-set frames.

with_retry is compared on stub decoders that return fixed DecodeResults
built from numpy, identical in both packages: the frame id rides in
llr[:, 0], so a fallback's answer for a row does not depend on how the
wrapper gathers or pads the failed rows.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.decode.api import with_retry as jax_with_retry
from ecc_ldpc_tpu.decode.types import DecodeResult as JaxDecodeResult
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.api import choose_graph, get_decoder, with_retry
from ecc_ldpc_tpu_torch.decode.types import DecodeResult

torch.set_num_threads(1)

B, N = 12, 10
TRAP = os.path.join(os.path.dirname(__file__), "data",
                    "trap_batch_dvbs2_64800_12.npz")
PRIMARY = "layered/norm:0.8125/50"
RETRY = "layered/norm:0.8125/50;retry=layered/spa/50"


def _tables(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (B, N), dtype=np.uint8),
            rng.integers(0, 50, B).astype(np.int32))


def _stubs(primary_ok, fallback_ok):
    """(numpy llr, stub tables): primary and fallback answers per frame."""
    llr = np.zeros((B, N), np.float32)
    llr[:, 0] = np.arange(B)
    pb, pi = _tables(1)
    fb, fi = _tables(2)
    return llr, (pb, np.asarray(primary_ok), pi), (fb, np.asarray(fallback_ok), fi)


def _jax_stub(tab):
    bits, ok, iters = tab

    def dec(llr):
        ids = np.asarray(llr[:, 0]).astype(np.int64)
        return JaxDecodeResult(bits=jnp.asarray(bits[ids]),
                               ok=jnp.asarray(ok[ids]),
                               iterations=jnp.asarray(iters[ids]))
    return dec


def _torch_stub(tab, calls):
    bits, ok, iters = tab

    def dec(llr):
        ids = llr[:, 0].long().numpy()
        calls.append(len(ids))
        return DecodeResult(bits=torch.from_numpy(bits[ids]),
                            ok=torch.from_numpy(ok[ids]),
                            iterations=torch.from_numpy(iters[ids]))
    return dec


CASES = {
    # 5 failed rows; the fallback recovers 3 of them and fails 2
    "mixed": ([1, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 0],
              [1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1]),
    "all_ok": ([1] * B, [0] * B),
    "all_fail": ([0] * B, [1, 0] * (B // 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_with_retry_matches_jax(case):
    p_ok, f_ok = (np.asarray(v, bool) for v in CASES[case])
    llr, ptab, ftab = _stubs(p_ok, f_ok)
    want = jax_with_retry(_jax_stub(ptab), _jax_stub(ftab))(jnp.asarray(llr))
    fcalls = []
    got = with_retry(_torch_stub(ptab, []), _torch_stub(ftab, fcalls))(
        torch.from_numpy(llr))
    assert np.array_equal(np.asarray(want.bits), got.bits.numpy())
    assert np.array_equal(np.asarray(want.ok), got.ok.numpy())
    assert np.array_equal(np.asarray(want.iterations), got.iterations.numpy())
    # the fallback sees exactly the failed rows, once
    n_bad = int((~p_ok).sum())
    assert fcalls == ([n_bad] if n_bad else [])
    if case == "mixed":  # a retried row the fallback fails takes its output
        row = 4
        assert not got.ok[row]
        assert np.array_equal(got.bits[row].numpy(), ftab[0][row])
        assert int(got.iterations[row]) == ptab[2][row] + ftab[2][row]


def test_retry_spec_builds_host_level_wrapper():
    spec = get_code("dvbs2/16200/12")
    graph = choose_graph(spec, RETRY)
    dec = get_decoder(graph, RETRY, device="cpu")
    assert dec.host_level is True
    for bad in (";retry=layered/spa/50", "layered/spa/50;retry="):
        with pytest.raises(ValueError, match="PRIMARY;retry=FALLBACK"):
            get_decoder(graph, bad, device="cpu")


@pytest.fixture(scope="module")
def trap():
    d = np.load(TRAP)
    # 4 of the 8 stored frames, as tests/decode/test_retry_batch.py takes
    return (torch.from_numpy(d["llr"][:4].astype(np.float32)),
            torch.from_numpy(d["cw"][:4].astype(np.uint8)))


def test_trap_frames_recovered_by_retry(trap):
    """The port's twin of tests/decode/test_retry_batch.py with the
    production fallback: the primary fails every frame, and the retry
    decoder recovers each to the stored codeword exactly."""
    llr, cw = trap
    spec = get_code("dvbs2/64800/12")
    graph = choose_graph(spec, RETRY)
    pres = get_decoder(graph, PRIMARY, device="cpu")(llr)
    assert not bool(pres.ok.any())
    res = get_decoder(graph, RETRY, device="cpu")(llr)
    assert bool(res.ok.all())
    assert torch.equal(res.bits, cw)
    # every frame ran the primary's 50 iterations, then the fallback's
    assert bool((res.iterations > 50).all())
