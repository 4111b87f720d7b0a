"""The sharded step of the port (ecc_ldpc_tpu_torch/dist/montecarlo.py,
dist/mesh.py) on the CPU: the per-frame Philox generator (known answers,
slicing invariance, distinct streams, statistics), mesh invariance with the
ranks of each mesh run one after another in this process (twins of
tests/dist/test_montecarlo.py), and MeshSpec and the rank layout against
the JAX package's."""
import jax
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.dist.mesh import MeshSpec as JaxMeshSpec
from ecc_ldpc_tpu.dist.mesh import make_mesh as jax_make_mesh
from ecc_ldpc_tpu_torch.dist import (
    Mesh,
    MeshSpec,
    make_mesh,
    make_sharded_step,
    maybe_init_distributed,
    sharded_sweep_counters,
)
from ecc_ldpc_tpu_torch.dist.montecarlo import (
    STREAM_MESSAGE,
    STREAM_NOISE,
    frame_bits,
    frame_normals,
    frame_words,
    philox4x32,
)
from ecc_ldpc_tpu_torch.sim.runner import Pipeline, SweepSpec

torch.set_num_threads(1)

DECODER = "minsum/norm:0.8125/10"
GRID = (1.0, 3.0)


def _frames(a: int, b: int) -> torch.Tensor:
    return torch.arange(a, b, dtype=torch.int64)


# Random123's known-answer vectors for Philox4x32-10 (kat_vectors):
# (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    out = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in out) == want


@pytest.mark.parametrize("a,b", [(0, 5), (5, 13), (12, 13), (3, 11)])
def test_rows_of_a_slice_are_rows_of_the_whole(a, b):
    """Frames [a, b) drawn alone equal rows [a, b) of frames [0, 13) drawn
    at once: message bits and normals (k, n not multiples of 128 and 4)."""
    whole_bits = frame_bits(7, 1, 2, _frames(0, 13), 301)
    whole_noise = frame_normals(7, 1, 2, _frames(0, 13), 1007)
    assert whole_bits.shape == (13, 301) and whole_bits.dtype == torch.uint8
    assert whole_noise.shape == (13, 1007)
    assert whole_noise.dtype == torch.float32
    assert torch.equal(frame_bits(7, 1, 2, _frames(a, b), 301), whole_bits[a:b])
    assert torch.equal(frame_normals(7, 1, 2, _frames(a, b), 1007),
                       whole_noise[a:b])
    # a frame's draw depends on its global index only, not on its row
    assert torch.equal(frame_normals(7, 1, 2, torch.tensor([b - 1]), 1007)[0],
                       whole_noise[b - 1])


def test_streams_differ_across_seed_point_step_frame():
    base = frame_words(5, 1, 2, STREAM_NOISE, _frames(0, 4), 16)
    others = [
        frame_words(6, 1, 2, STREAM_NOISE, _frames(0, 4), 16),
        frame_words(5 + (1 << 32), 1, 2, STREAM_NOISE, _frames(0, 4), 16),
        frame_words(5, 2, 2, STREAM_NOISE, _frames(0, 4), 16),
        frame_words(5, 1, 3, STREAM_NOISE, _frames(0, 4), 16),
        frame_words(5, 1, 2, STREAM_MESSAGE, _frames(0, 4), 16),
        frame_words(5, 1, 2, STREAM_NOISE, _frames(4, 8), 16),
    ]
    for o in others:
        # every word differs (a collision of 32-bit words is ~1e-7 here)
        assert not torch.any(o == base)
    # frames within one draw differ too, and so do blocks within a frame
    assert len(set(base[:, 0, 0].tolist())) == 4
    assert len(set(base[0, :, 0].tolist())) == 16
    assert int(base.min()) >= 0 and int(base.max()) <= 0xFFFFFFFF


def test_statistics_on_a_million_samples():
    """Normals: mean within 0.005 and variance within 0.01 of (0, 1) (5
    and 7 standard errors at N = 1.05M); fair bits within 0.002 of 1/2 (4
    standard errors); every uniform in (0, 1], so no log(0)."""
    z = frame_normals(11, 0, 0, _frames(0, 256), 4096).double()
    assert torch.isfinite(z).all()
    assert abs(z.mean().item()) < 0.005
    assert abs(z.var().item() - 1.0) < 0.01
    # the tails of a normal: ~0.27% beyond 3 sigma
    assert 0.002 < (z.abs() > 3).double().mean().item() < 0.0035
    bits = frame_bits(11, 0, 0, _frames(0, 256), 4096).double()
    assert abs(bits.mean().item() - 0.5) < 0.002
    w = frame_words(11, 0, 0, STREAM_NOISE, _frames(0, 64), 1024)
    u = ((w >> 8) + 1).double() / (1 << 24)
    assert u.min().item() > 0.0 and u.max().item() <= 1.0


CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pipeline():
    return Pipeline.build(SweepSpec(code="mackay1008", decoder=DECODER,
                                    ebn0_db=GRID), CPU)


def _counters(pipeline, batch, snr, total=64, steps=2, grid=GRID):
    """The counters of a (batch x snr) mesh: its ranks run one after
    another here, each its own points and frames, and their zero-padded
    parts summed (what the ring gives every rank)."""
    acc = 0
    for rank in range(batch * snr):
        mesh = Mesh(batch=batch, snr=snr, rank=rank, device=CPU)
        step = make_sharded_step(pipeline, mesh, total // batch)
        for s in range(steps):
            acc = acc + step.local(0, grid, s)
    return acc


def test_mesh_shape_invariance(pipeline):
    """The summed counters equal the single-rank counters for the same
    total batch and seed on every mesh; all four are integers here,
    bit_errors_sq included."""
    ref = _counters(pipeline, 1, 1)
    assert ref.dtype == torch.int64 and ref.shape == (2, 4)
    assert ref[0, 0] > 0  # the 1 dB point has errors: not vacuous
    for batch, snr in [(2, 1), (4, 1), (2, 2)]:
        assert torch.equal(_counters(pipeline, batch, snr), ref), (batch, snr)
    got, frames = sharded_sweep_counters(pipeline, Mesh(1, 1, device=CPU),
                                         64, GRID, steps=2)
    assert torch.equal(got, ref) and frames == 128


def test_snr_points_independent(pipeline):
    """A grid point's counters depend on its index in the grid, not on the
    other points: point 0 at 1 dB is the same alone and beside 3 dB, and
    the whole is deterministic."""
    both = _counters(pipeline, 2, 1, steps=1)
    alone = _counters(pipeline, 2, 1, steps=1, grid=(1.0,))
    assert torch.equal(both[0], alone[0])
    assert torch.equal(both, _counters(pipeline, 2, 1, steps=1))


def test_higher_snr_fewer_errors(pipeline):
    got = _counters(pipeline, 2, 2, steps=2)
    assert got[0, 0] > got[1, 0]  # 1 dB vs 3 dB


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_spec_resolve_matches_jax(n):
    for batch, snr in [(-1, 1), (-1, 2), (2, 1), (2, 2), (1, 4), (3, 3),
                       (4, 2), (-1, 3)]:
        try:
            want = JaxMeshSpec(batch=batch, snr=snr).resolve(n)
        except ValueError as e:
            want = ("raises", str(e))
        try:
            got = MeshSpec(batch=batch, snr=snr).resolve(n)
        except ValueError as e:
            got = ("raises", str(e))
        assert got == want, (batch, snr, n)


@pytest.mark.parametrize("batch,snr", [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2)])
def test_rank_layout_is_the_jax_mesh_order(batch, snr):
    """Rank r sits where the JAX mesh puts device r: row-major (batch, snr)."""
    mesh = jax_make_mesh(JaxMeshSpec(batch=batch, snr=snr),
                         devices=jax.devices()[:batch * snr])
    for r in range(batch * snr):
        m = Mesh(batch=batch, snr=snr, rank=r, device=CPU)
        assert mesh.devices[m.batch_shard, m.snr_shard].id == r
        assert dict(mesh.shape) == {"batch": m.batch, "snr": m.snr}


def test_single_process_mesh():
    """Without a process group the mesh is one rank, and a CUDA mesh needs
    a card."""
    assert maybe_init_distributed() is False
    assert maybe_init_distributed(num_processes=1) is False
    mesh = make_mesh(device="cpu")
    assert (mesh.batch, mesh.snr, mesh.rank, mesh.group) == (1, 1, 0, None)
    with pytest.raises(ValueError, match="mesh 2x1"):
        make_mesh(MeshSpec(batch=2, snr=1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Mesh(1, 1)  # a mesh is on a card unless the CPU is asked for
    with pytest.raises(ValueError, match="coordinator"):
        maybe_init_distributed(num_processes=2, process_id=0)
