"""K5's plain version (ecc_ldpc_tpu_torch/dist/ring.py) on gloo ranks
against the JAX package's ring_allreduce (its Pallas kernel in interpret
mode on virtual CPU devices), on the same numpy blocks: the same slot order,
so the same bits. The CUDA wrapper runs only on the card (chip_smoke.py
phase 23); here it must refuse a CPU tensor, and a CPU model of its
schedule (push, interprocess events, the host handshake) must show the
hazards of csrc/ring.cu's header answered for D = 2..8."""
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


def ring_schedule(D: int, calls: int, seed: int, events: int = 2,
                  handshake: bool = True) -> list:
    """A CPU model of K5's schedule on the card (csrc/ring.cu's header):
    each of D ranks runs `calls` calls of push(k), record E_r[k % events],
    publish k + 1, spin until every peer published k + 1 (if `handshake`),
    waits on every peer's E_p[k % events], sum(k), on its host; each host
    step enqueues onto the rank's stream, and the steps of the hosts and
    the streams interleave in a seeded random order. A wait binds to the
    most recent record issued on the host at the time of the call, and
    passes once that record has run. Raises AssertionError on a hazard: a
    slot written twice in a call, a half written while its previous
    reader (the sum of call k - 2) has not run, a sum that reads a slot
    not written by that call, or no step able to run. Returns the call
    each wait bound to, as (waiter, peer, k, bound)."""
    rng = np.random.default_rng(seed)
    host = [[(op, k) for k in range(calls) for op in
             ("push", "record", "publish", "spin", "wait", "sum")]
            for _ in range(D)]
    stream = [[] for _ in range(D)]
    words = [0] * D                          # the host segment's counters
    issued = [[None] * events for _ in range(D)]   # latest record, by call
    ran = [[-1] * events for _ in range(D)]        # latest record run
    buf = {}                                 # (rank, half, slot) -> call
    writes = {}                              # (rank, k, slot) -> count
    summed = [-1] * D                        # the last call each rank summed
    bound = []

    def host_step(r):
        op, k = host[r][0]
        if op == "spin":
            if handshake and min(words) < k + 1:
                return False
        elif op == "publish":
            words[r] = k + 1
        elif op == "record":
            issued[r][k % events] = k
            stream[r].append(("record", k, None))
        elif op == "wait":
            for p in range(D):
                if p != r:
                    b = issued[p][k % events]
                    bound.append((r, p, k, b))
                    stream[r].append(("wait", p, (k % events, b)))
        else:
            stream[r].append((op, k, None))
        host[r].pop(0)
        return True

    def device_step(r):
        op, k, arg = stream[r][0]
        if op == "wait":  # ("wait", peer, (event, bound call))
            e, b = arg
            if b is not None and ran[k][e] < b:
                return False
        elif op == "record":
            ran[r][k % events] = k
        elif op == "push":
            for p in range(D):
                assert k < 2 or summed[p] >= k - 2, \
                    f"rank {r} pushes call {k} into rank {p}'s half before " \
                    f"its sum of call {k - 2} read it"
                buf[p, k % 2, r] = k
                writes[p, k, r] = writes.get((p, k, r), 0) + 1
        else:  # sum
            for s in range(D):
                assert buf.get((r, k % 2, s)) == k, \
                    f"rank {r}'s sum of call {k} reads slot {s} of call " \
                    f"{buf.get((r, k % 2, s))}"
            summed[r] = k
        stream[r].pop(0)
        return True

    while any(host) or any(stream):
        steps = [(host_step, r) for r in range(D) if host[r]]
        steps += [(device_step, r) for r in range(D) if stream[r]]
        for i in rng.permutation(len(steps)):
            fn, r = steps[i]
            if fn(r):
                break
        else:
            raise AssertionError("no host or device step can run: deadlock")
    assert all(c == 1 for c in writes.values())
    assert len(writes) == D * D * calls  # every slot of every call, once
    return bound


@pytest.mark.parametrize("D", range(2, 9))
def test_ring_schedule_model(D):
    """Over seeded interleavings of 5 calls: every slot written once a
    call, no half written while its last reader may still read it, each
    wait bound to its own call's record, and no deadlock."""
    for seed in range(25):
        bound = ring_schedule(D, 5, seed)
        assert len(bound) == D * (D - 1) * 5
        assert all(b == k for _, _, k, b in bound), seed


def test_ring_schedule_model_tells_the_hazards_apart():
    """The model sees what the design guards against: with one event a
    rank, some wait binds to the next call's record (safe, but not the
    record meant); without the host handshake some sum reads a stale slot
    or a wait binds to no record of its call."""
    late = [(k, b) for seed in range(200)
            for _, _, k, b in ring_schedule(2, 4, seed, events=1) if b != k]
    assert late and all(b == k + 1 for k, b in late)
    failed = 0
    for seed in range(200):
        try:
            bound = ring_schedule(3, 4, seed, handshake=False)
        except AssertionError:
            failed += 1
            continue
        failed += any(b != k for _, _, k, b in bound)
    assert failed > 0
