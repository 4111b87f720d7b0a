"""K5's plain version (ecc_ldpc_tpu_torch/dist/ring.py) on gloo ranks
against the JAX package's ring_allreduce (its Pallas kernel in interpret
mode on virtual CPU devices), on the same numpy blocks: the same slot order,
so the same bits. The CUDA wrapper runs only on the card (chip_smoke.py
phase 23); here it must refuse a CPU tensor, and a CPU model of its
schedule (push, interprocess events, the host handshake, and across nodes
the host-staged exchange and the remote copies) must show the hazards of
csrc/ring.cu's header answered for D = 2..8 on one node and on node
layouts up to 4 x 1. The node plan: a pure function of the ranks' node
keys, and on the spawned ranks with and without a launcher's GROUP_RANK,
with the host-staged gather of the remote blocks."""
import multiprocessing
import os
import pathlib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ecc_ldpc_tpu_torch import _build
from ecc_ldpc_tpu_torch.bench.ring import parse_groups, ring_bound
from ecc_ldpc_tpu_torch.dist.mesh import (
    build_per_node,
    maybe_init_distributed,
    node_key,
    node_leaders,
)
from ecc_ldpc_tpu_torch.dist.ring import (
    Ring,
    node_plan,
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
    # a manual launch (no launcher's GROUP_RANK): the ranks' node is the host
    os.environ.pop("GROUP_RANK", None)
    with Ring(None, "cpu") as ring:  # the wrapper takes the plain path
        res["dispatch"] = ring_allreduce(
            torch.from_numpy(_f32_blocks(world)[rank]), ring).numpy()
        res["dispatch_launches"] = np.array(ring.launches)
        res["plan_manual"] = ring.plan.line()
    # two nodes of two ranks, as torch.distributed.run numbers its agents
    os.environ["GROUP_RANK"] = str(rank // 2)
    res["node_key"] = node_key()
    built = []
    _build.build_all = lambda names: built.append(names) or {}
    build_per_node(names=("ring",))  # a leader builds, then the barrier
    res["built"] = np.array(built == [("ring",)])
    with Ring(None, "cpu") as ring:
        res["plan_nodes"] = ring.plan.line()
        i64, f32 = (torch.from_numpy(b(world)[rank]) for b in (_i64_blocks,
                                                               _f32_blocks))
        for name, x in (("i64", i64), ("f32", f32)):
            staged = ring.host_blocks(x).clone()
            want = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(want, x)
            res[f"host_blocks_{name}"] = np.array(all(
                torch.equal(staged[p], want[p].reshape(-1).view(torch.uint8))
                for p in ring.plan.host))
            res[f"host_rows_{name}"] = np.array(ring.plan.host)
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
        assert int(ranks[r]["dispatch_launches"]) == 0  # no kernel ran


def test_manual_launch_groups_ranks_by_host(ranks):
    """With no GROUP_RANK (a manual maybe_init_distributed launch) every
    rank of this host is one node: CUDA IPC to all, no host leg."""
    for r in range(WORLD):
        assert str(ranks[r]["plan_manual"]) == (
            f"ring: rank {r} D=4 node 0/1 ipc=[0,1,2,3] host=[]")


def test_ranks_on_two_nodes(ranks):
    """GROUP_RANK = rank // 2, as two torch.distributed.run agents of two
    ranks set it: each rank's plan names its node and peers, each node's
    leader (ranks 0 and 2) alone builds before the barrier, and the
    host-staged gather of the remote blocks is the plain all_gather's,
    byte for byte, f32 and int64."""
    host = socket.gethostname()
    for r in range(WORLD):
        got = ranks[r]
        node = r // 2
        peers = [2 * node, 2 * node + 1]
        others = [q for q in range(WORLD) if q not in peers]
        assert str(got["node_key"]) == f"{host}#{node}"
        assert str(got["plan_nodes"]) == (
            f"ring: rank {r} D=4 node {node}/2 ipc=[{peers[0]},{peers[1]}] "
            f"host=[{others[0]},{others[1]}]")
        assert bool(got["built"]) == (r in (0, 2))
        for name in ("i64", "f32"):
            assert bool(got[f"host_blocks_{name}"]), (r, name)
            assert got[f"host_rows_{name}"].tolist() == others


# node keys in rank order -> (node, nodes, ipc, host) of each rank
PLANS = {
    "hostnames": (["a", "a", "b", "b"],
                  [(0, 2, (0, 1), (2, 3))] * 2 + [(1, 2, (2, 3), (0, 1))] * 2),
    "group_rank_one_host": (["h#0", "h#0", "h#1", "h#1"],
                            [(0, 2, (0, 1), (2, 3))] * 2
                            + [(1, 2, (2, 3), (0, 1))] * 2),
    "2x2": (["a#0", "a#0", "b#1", "b#1"],
            [(0, 2, (0, 1), (2, 3))] * 2 + [(1, 2, (2, 3), (0, 1))] * 2),
    "1x4": (["h"] * 4, [(0, 1, (0, 1, 2, 3), ())] * 4),
    "4x1": (["h#0", "h#1", "h#2", "h#3"],
            [(r, 4, (r,), tuple(q for q in range(4) if q != r))
             for r in range(4)]),
    "uneven": (["a", "a", "a", "b"],
               [(0, 2, (0, 1, 2), (3,))] * 3 + [(1, 2, (3,), (0, 1, 2))]),
    "interleaved": (["a", "b", "a", "b"],
                    [(0, 2, (0, 2), (1, 3)), (1, 2, (1, 3), (0, 2))] * 2),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_node_plan(name):
    """The plan from the ranks' node keys: a node is the ranks with one
    key, numbered by its leader (lowest rank); CUDA IPC within it, host
    memory to every other rank."""
    keys, want = PLANS[name]
    leaders = node_leaders(keys)
    for r, (node, nodes, ipc, host) in enumerate(want):
        plan = node_plan(keys, r)
        assert (plan.node, plan.nodes, plan.ipc, plan.host) == (node, nodes,
                                                                ipc, host)
        assert plan.leader == leaders[r] == ipc[0] and plan.size == 4


def test_node_key_without_a_launcher(monkeypatch):
    monkeypatch.delenv("GROUP_RANK", raising=False)
    assert node_key() == socket.gethostname()
    monkeypatch.setenv("GROUP_RANK", "3")
    assert node_key() == f"{socket.gethostname()}#3"


def test_bench_ring_groups():
    assert parse_groups("2,0+2,4", 4) == [[0, 1], [0, 2], [0, 1, 2, 3]]
    with pytest.raises(ValueError, match="ascending"):
        parse_groups("2+0", 4)
    with pytest.raises(ValueError, match="below 4"):
        parse_groups("5", 4)


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
                  handshake: bool = True, nodes=None,
                  ordered_puts: bool = True) -> list:
    """A CPU model of K5's schedule on the card (csrc/ring.cu's header):
    each of D ranks, on the nodes `nodes` (a node a rank; default one node),
    runs `calls` calls of push(k) into its node's buffers, record E_r[k %
    events], publish k + 1, then, when there are several nodes, stage (a
    device copy of its block to the host), sync (the host waits for its
    stream), send and receive (the exchange over the process group: every
    rank's staged block as it is when the rank sends) and put (the remote
    blocks into their slots of half k % 2, on the rank's stream, or with
    `ordered_puts` False on a queue of their own), then spin until every
    node peer published k + 1 (if `handshake`), wait on every node peer's
    E_p[k % events], sum(k). Each host step enqueues onto the rank's
    stream, and the steps of the hosts and the device queues interleave in
    a seeded random order. A wait binds to the most recent record issued on
    the host at the time of the call, and passes once that record has run.
    Raises AssertionError on a hazard: a slot written twice in a call, a
    half written while its previous reader (the sum of call k - 2) has not
    run, a sum that reads a slot not written by that call, or no step able
    to run. Returns the call each wait bound to, as (waiter, peer, k,
    bound)."""
    nodes = [0] * D if nodes is None else list(nodes)
    ipc = [[p for p in range(D) if nodes[p] == nodes[r]] for r in range(D)]
    remote = [[p for p in range(D) if nodes[p] != nodes[r]] for r in range(D)]
    ops = ["push", "record", "publish"]
    if len(set(nodes)) > 1:
        ops += ["stage", "sync", "send", "receive", "put"]
    ops += ["spin", "wait", "sum"]
    rng = np.random.default_rng(seed)
    host = [[(op, k) for k in range(calls) for op in ops] for _ in range(D)]
    stream = [[] for _ in range(D)]
    copies = [[] for _ in range(D)]          # the puts' queue when unordered
    words = [0] * D                          # the host segment's counters
    issued = [[None] * events for _ in range(D)]   # latest record, by call
    ran = [[-1] * events for _ in range(D)]        # latest record run
    staged = [None] * D                      # the call in each host stage
    sent = {}                                # k -> {rank: staged call}
    received = [None] * D
    buf = {}                                 # (rank, half, slot) -> call
    writes = {}                              # (rank, k, slot) -> count
    summed = [-1] * D                        # the last call each rank summed
    bound = []

    def write(r, k, p, slot, value):
        assert k < 2 or summed[p] >= k - 2, \
            f"rank {r} writes call {k} into rank {p}'s half before its " \
            f"sum of call {k - 2} read it"
        buf[p, k % 2, slot] = value
        writes[p, k, slot] = writes.get((p, k, slot), 0) + 1

    def host_step(r):
        op, k = host[r][0]
        if op == "spin":
            if handshake and min(words[p] for p in ipc[r]) < k + 1:
                return False
        elif op == "publish":
            words[r] = k + 1
        elif op == "record":
            issued[r][k % events] = k
            stream[r].append(("record", k, None))
        elif op == "sync":
            if stream[r]:
                return False
        elif op == "send":
            sent.setdefault(k, {})[r] = staged[r]
        elif op == "receive":
            if len(sent.get(k, ())) < D:
                return False
            received[r] = dict(sent[k])
        elif op == "put":
            (stream if ordered_puts else copies)[r].append(
                ("put", k, received[r]))
        elif op == "wait":
            for p in ipc[r]:
                if p != r:
                    b = issued[p][k % events]
                    bound.append((r, p, k, b))
                    stream[r].append(("wait", p, (k % events, b)))
        else:
            stream[r].append((op, k, None))
        host[r].pop(0)
        return True

    def device_step(r, queue):
        op, k, arg = queue[r][0]
        if op == "wait":  # ("wait", peer, (event, bound call))
            e, b = arg
            if b is not None and ran[k][e] < b:
                return False
        elif op == "record":
            ran[r][k % events] = k
        elif op == "push":
            for p in ipc[r]:
                write(r, k, p, r, k)
        elif op == "stage":
            staged[r] = k
        elif op == "put":
            for q in remote[r]:
                write(r, k, r, q, arg[q])
        else:  # sum
            for s in range(D):
                assert buf.get((r, k % 2, s)) == k, \
                    f"rank {r}'s sum of call {k} reads slot {s} of call " \
                    f"{buf.get((r, k % 2, s))}"
            summed[r] = k
        queue[r].pop(0)
        return True

    while any(host) or any(stream) or any(copies):
        steps = [(host_step, r, None) for r in range(D) if host[r]]
        steps += [(device_step, r, q) for q in (stream, copies)
                  for r in range(D) if q[r]]
        for i in rng.permutation(len(steps)):
            fn, r, q = steps[i]
            if fn(r) if q is None else fn(r, q):
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


NODE_LAYOUTS = {"2x1": [0, 1], "2x2": [0, 0, 1, 1], "4x1": [0, 1, 2, 3],
                "uneven": [0, 0, 0, 1], "interleaved": [0, 1, 0, 1]}


@pytest.mark.parametrize("layout", sorted(NODE_LAYOUTS))
def test_ring_schedule_model_across_nodes(layout):
    """With ranks on several nodes (the host route: stage, exchange, puts
    on the stream): every slot written once a call, no half written under
    its last reader, each wait bound to its own call, no deadlock."""
    nodes = NODE_LAYOUTS[layout]
    D = len(nodes)
    node_peers = sum(nodes.count(n) - 1 for n in nodes)
    for seed in range(25):
        bound = ring_schedule(D, 4, seed, nodes=nodes)
        assert len(bound) == node_peers * 4
        assert all(b == k for _, _, k, b in bound), seed


def test_ring_schedule_model_catches_unordered_puts():
    """The model sees the hazard the stream order answers: remote blocks
    copied on a queue of their own, not ordered before the sum, leave some
    sum reading a slot of an earlier call."""
    failed = 0
    for seed in range(100):
        try:
            ring_schedule(4, 4, seed, nodes=[0, 0, 1, 1], ordered_puts=False)
        except AssertionError as e:
            assert "reads slot" in str(e)
            failed += 1
    assert failed > 0
