"""Both graph-parallel tiers of the port (dist/graph_parallel.py) on D = 1,
2 and 4 gloo ranks (spawned once for the module, each D a sub-group),
against the JAX package on the same LLR arrays from a numpy seed:

- the QC (Z-sharded) tier on wimax/576/12 (Z = 24), min-sum, track mode:
  bits, ok and iterations identical to JAX's decode_flooding_qc and to
  the port's single-rank plain decoder for every D, and to JAX's
  make_qc_graph_parallel_decoder on 4 of the 8 virtual CPU devices
  tests/conftest.py sets up (its own tests hold it to decode_flooding_qc
  for every D); the K5 exchanges counted;
- the check-sharded tier on gallager_36(96, seed=8) (the JAX test's
  code), min-sum: on the frames both decode, the bits of the JAX
  single-device flooding decoder and of JAX's check-sharded tier;
- each raise, named: Z % D != 0, xor blocks, a kind the tier does not
  run.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ecc_ldpc_tpu.codes import gallager_36 as jax_gallager_36
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.decode import make_decoder as jax_make_decoder
from ecc_ldpc_tpu.decode.xla.flooding_qc import decode_flooding_qc
from ecc_ldpc_tpu.dist.graph_parallel import (
    make_graph_parallel_decoder as jax_make_gp,
)
from ecc_ldpc_tpu.dist.graph_parallel import (
    make_qc_graph_parallel_decoder as jax_make_qc_gp,
)
from ecc_ldpc_tpu.dist.graph_parallel import shard_graph as jax_shard_graph
from ecc_ldpc_tpu.graph import compile_graph as jax_compile_graph
from ecc_ldpc_tpu.graph.qc import compile_qc_graph as jax_compile_qc_graph
from ecc_ldpc_tpu_torch.codes.gallager import gallager_36
from ecc_ldpc_tpu_torch.codes.registry import get_code
from ecc_ldpc_tpu_torch.decode.flooding_qc import flooding_qc_decode_plain
from ecc_ldpc_tpu_torch.dist.graph_parallel import (
    make_graph_parallel_decoder,
    make_qc_graph_parallel_decoder,
    shard_graph,
)
from ecc_ldpc_tpu_torch.dist.mesh import maybe_init_distributed
from ecc_ldpc_tpu_torch.graph.qc import compile_qc_graph

from test_torch_ring import spawn_ranks

WORLD = 4
RANKS = (1, 2, 4)
T = 12
QC_CODE = "wimax/576/12"
B = 16


def _awgn_llr(n, B, ebn0_db, rate, rng):
    sigma = (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5
    y = 1.0 + sigma * rng.standard_normal((B, n))
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _inputs():
    """(QC llr, check-sharded llr): the all-zero codeword over AWGN, frame
    0 noiseless (done before the first sweep)."""
    qc = _awgn_llr(576, B, 1.8, 0.5, np.random.default_rng(31))
    gen = _awgn_llr(96, B, 3.0, 0.5, np.random.default_rng(32))
    qc[0] = gen[0] = 4.0
    return qc, gen


def _worker(rank, world, store, out_dir):
    torch.set_num_threads(1)
    maybe_init_distributed(f"file://{store}", world, rank)
    qc_llr, gen_llr = _inputs()
    res, raised = {}, {}
    for D in RANKS:
        group = dist.new_group(list(range(D)))  # every rank takes part
        if rank >= D:
            continue
        dec = make_qc_graph_parallel_decoder(
            get_code(QC_CODE), group, kind="minsum", alpha=0.8125,
            max_iters=T, device="cpu")
        r = dec(torch.from_numpy(qc_llr))
        res[f"qc{D}"] = r.bits.numpy()
        res[f"qc{D}_ok"] = r.ok.numpy()
        res[f"qc{D}_it"] = r.iterations.numpy()
        res[f"qc{D}_calls"] = np.array(dec.exchange.calls)
        dec = make_graph_parallel_decoder(
            gallager_36(96, seed=8), group, kind="minsum", alpha=0.8125,
            max_iters=T, device="cpu")
        r = dec(torch.from_numpy(gen_llr))
        res[f"gen{D}"] = r.bits.numpy()
        res[f"gen{D}_ok"] = r.ok.numpy()
        if D > 1:
            try:
                make_qc_graph_parallel_decoder(
                    get_code("80211n/648/12"), group, device="cpu")
            except ValueError as e:
                raised[D] = str(e)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res,
             raised=np.array([raised.get(D, "") for D in RANKS]))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("graph_parallel")
    spawn_ranks(_worker, WORLD, out)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _mesh(D):
    return jax.make_mesh((D,), ("graph",), devices=jax.devices()[:D])


@pytest.fixture(scope="module")
def qc_refs():
    """(JAX decode_flooding_qc, the port's single-rank plain decode) of the
    QC tier's LLRs."""
    qc_llr, _ = _inputs()
    jg = jax_compile_qc_graph(jax_get_code(QC_CODE))
    ref = decode_flooding_qc(jg, jnp.asarray(qc_llr), kind="minsum",
                             alpha=0.8125, max_iters=T)
    plain = flooding_qc_decode_plain(compile_qc_graph(get_code(QC_CODE)),
                                     torch.from_numpy(qc_llr), alpha=0.8125,
                                     max_iters=T)
    return ref, plain


@pytest.mark.parametrize("D", RANKS)
def test_qc_tier_is_the_single_rank_decode(ranks, qc_refs, D):
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    ref, plain = qc_refs
    wants = [ref]
    if D == 4:
        qc_llr, _ = _inputs()
        wants.append(jax_make_qc_gp(jax_get_code(QC_CODE), _mesh(D),
                                    kind="minsum", alpha=0.8125,
                                    max_iters=T)(jnp.asarray(qc_llr)))
    for r in range(D):  # every rank holds the whole result
        got = ranks[r]
        for want in wants:
            assert np.array_equal(np.asarray(want.bits), got[f"qc{D}"])
            assert np.array_equal(np.asarray(want.ok), got[f"qc{D}_ok"])
            assert np.array_equal(np.asarray(want.iterations),
                                  got[f"qc{D}_it"])
        assert np.array_equal(plain.bits.numpy(), got[f"qc{D}"])
    got = ranks[0]
    assert 0 < got[f"qc{D}_ok"].sum() < B and got[f"qc{D}_it"][0] == 0
    # track mode: one exchange at the start, two a sweep, one at the end;
    # the sweeps run until every frame is done (the last one to stop
    # counted one fewer) or T
    sweeps = min(T, int(got[f"qc{D}_it"].max()) + 1)
    assert int(got[f"qc{D}_calls"]) == 2 + 2 * sweeps


@pytest.mark.parametrize("D", RANKS)
def test_check_sharded_tier_agrees_on_ok_frames(ranks, D):
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    _, gen_llr = _inputs()
    jspec = jax_gallager_36(96, seed=8)
    single = jax_make_decoder(jax_compile_graph(jspec), "minsum",
                              alpha=0.8125, max_iters=T,
                              backend="xla")(jnp.asarray(gen_llr))
    jgp = jax_make_gp(jspec, _mesh(D), kind="minsum", alpha=0.8125,
                      max_iters=T)(jnp.asarray(gen_llr))
    got = ranks[0]
    bits, ok = got[f"gen{D}"], got[f"gen{D}_ok"]
    assert ok.mean() > 0.8
    for want in (single, jgp):
        both = ok & np.asarray(want.ok)
        assert both.sum() >= 0.8 * B
        assert np.array_equal(bits[both], np.asarray(want.bits)[both])
    assert gallager_36(96, seed=8).check_syndrome(bits[ok])
    for r in range(1, D):
        assert np.array_equal(ranks[r][f"gen{D}"], bits)


def test_shards_and_raises(ranks):
    """shard_graph's shards are the JAX package's; the raises, named."""
    for D in (3, 4):
        sg = shard_graph(gallager_36(96, seed=8), D)
        jsg = jax_shard_graph(jax_gallager_36(96, seed=8), D)
        assert np.array_equal(sg.cn_vn, jsg.cn_vn)
        assert np.array_equal(sg.cn_mask, jsg.cn_mask)
    for i, D in enumerate(RANKS):
        msg = str(ranks[0]["raised"][i])
        assert ("does not divide" in msg) == (D > 1), msg
    xor = compile_qc_graph(get_code("8023an"))
    with pytest.raises(ValueError, match="circulant blocks"):
        make_qc_graph_parallel_decoder(xor, device="cpu")
    with pytest.raises(KeyError, match="minsum or spa"):
        make_graph_parallel_decoder(gallager_36(96, seed=8), kind="minstar",
                                    device="cpu")
    with pytest.raises(KeyError):
        make_qc_graph_parallel_decoder(get_code(QC_CODE), kind="bitflip",
                                       device="cpu")
