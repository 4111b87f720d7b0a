"""K5's plain version (ecc_ldpc_tpu_torch/dist/ring.py) on gloo ranks
against the JAX package's ring_allreduce (its Pallas kernel in interpret
mode on virtual CPU devices), on the same numpy blocks: the same slot order,
so the same bits. The CUDA wrapper runs only on the card (chip_smoke.py
phase 23); here it must refuse a CPU tensor."""
import multiprocessing
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ecc_ldpc_tpu_torch.bench.ring import ring_bound
from ecc_ldpc_tpu_torch.dist.mesh import maybe_init_distributed
from ecc_ldpc_tpu_torch.dist.ring import (
    Ring,
    ring_allreduce,
    ring_allreduce_cuda,
    ring_allreduce_plain,
)

WORLD = 4


def _f32_blocks(D: int) -> np.ndarray:
    """[D, 16, 128] f32, the JAX package's own test input."""
    return np.random.default_rng(0).normal(size=(D, 16, 128)).astype(np.float32)


def _i64_blocks(D: int) -> np.ndarray:
    return np.random.default_rng(1).integers(-(1 << 40), 1 << 40,
                                             size=(D, 3, 5), dtype=np.int64)


def spawn_ranks(fn, world: int, out_dir, timeout: float = 300.0) -> None:
    """Run fn(rank, world, store, out_dir) in `world` spawned processes that
    meet through a gloo file store (no port, so parallel test workers
    cannot collide); raises unless every rank exits 0."""
    ctx = multiprocessing.get_context("spawn")
    store = str(pathlib.Path(out_dir) / "store")
    procs = [ctx.Process(target=fn, args=(r, world, store, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} ranks still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world


def _ring_worker(rank, world, store, out_dir):
    torch.set_num_threads(1)
    maybe_init_distributed(f"file://{store}", world, rank)
    res = {}
    for D in (1, 2, 4):
        group = dist.new_group(list(range(D)))  # every rank takes part
        if rank < D:
            x = torch.from_numpy(_f32_blocks(D)[rank])
            res[f"f32_D{D}"] = ring_allreduce_plain(x, group).numpy()
    x = torch.from_numpy(_i64_blocks(world)[rank])
    res["i64"] = ring_allreduce_plain(x).numpy()
    with Ring(None, "cpu") as ring:  # the wrapper takes the plain path
        res["dispatch"] = ring_allreduce(
            torch.from_numpy(_f32_blocks(world)[rank]), ring).numpy()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    spawn_ranks(_ring_worker, WORLD, out)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_ring(D: int) -> np.ndarray:
    import jax

    from ecc_ldpc_tpu.dist.ring import ring_allreduce as jax_ring_allreduce

    mesh = jax.make_mesh((D,), ("batch",), devices=jax.devices()[:D])
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("batch"))
    x = jax.device_put(_f32_blocks(D), sharding)
    return np.asarray(jax_ring_allreduce(x, mesh))


@pytest.mark.parametrize("D", [2, 4])
def test_plain_matches_jax_ring(ranks, D):
    """Every rank's sum has the JAX kernel's bits (0 ulps): both add the
    slots in order 0, 1, ..., D-1 in f32."""
    want = _jax_ring(D)
    for r in range(D):
        got = ranks[r][f"f32_D{D}"]
        assert got.dtype == np.float32 and got.shape == (16, 128)
        assert np.array_equal(got.view(np.int32), want[r].view(np.int32)), r
    # and not the same bits as a reordered sum, so the test can tell
    blocks = _f32_blocks(D)
    pairwise = (blocks[0] + blocks[-1]) + blocks[1:-1].sum(0)
    if D == 4:
        assert not np.array_equal(pairwise, want[0])


def test_single_rank_is_a_copy(ranks):
    """D = 1 returns the block, as the JAX ring does."""
    x = _f32_blocks(1)
    assert np.array_equal(ranks[0]["f32_D1"], x[0])
    assert np.array_equal(_jax_ring(1)[0], x[0])
    t = torch.from_numpy(x[0])
    assert ring_allreduce_plain(t) is t  # no process group: world 1
    with Ring(None, "cpu") as ring:
        assert ring.size == 1 and ring_allreduce(t, ring) is t


def test_int64_sums_match_numpy(ranks):
    want = _i64_blocks(WORLD).sum(0)
    for r in range(WORLD):
        assert ranks[r]["i64"].dtype == np.int64
        assert np.array_equal(ranks[r]["i64"], want)


def test_ring_dispatch_on_cpu_is_the_plain_version(ranks):
    want = ranks[0]["f32_D4"]
    for r in range(WORLD):
        assert np.array_equal(ranks[r]["dispatch"].view(np.int32),
                              want.view(np.int32))


def test_cuda_wrapper_refuses_cpu_tensors():
    before = ring_allreduce_cuda.launches
    with Ring(None, "cpu") as ring:
        with pytest.raises(ValueError, match="CUDA tensor"):
            ring_allreduce_cuda(torch.zeros(8), ring)
    assert ring_allreduce_cuda.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Ring(None, "cuda", 64)


def test_ring_bound():
    """Inputs read once and outputs written once over HBM: 2 D S bytes."""
    s, form = ring_bound(4, 16 << 20, 4 << 20)
    assert form == "bytes" and abs(s - 2 * 4 * (16 << 20) / 3.35e12) < 1e-15
    s, form = ring_bound(2, 64, 8)
    assert form == "bytes" and abs(s - 2 * 2 * 64 / 3.35e12) < 1e-18
    assert ring_bound(1, 64, 8)[0] == 2 * 64 / 3.35e12
