"""The port's host-side G cache (encode/dense.py DenseEncoder.build):
a round trip in a fresh HOME with the cache threshold lowered onto a small
code, G and info_cols equal to the JAX package's systematic_generator, the
file named and laid out as the JAX package names and writes it (so either
package reads the other's), and a file written by the JAX package's
format code path loads without an elimination."""
import hashlib
import os

import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.encode import DenseEncoder as JaxDenseEncoder
from ecc_ldpc_tpu.encode.dense import systematic_generator as jax_generator
from ecc_ldpc_tpu_torch.codes import get_code
from ecc_ldpc_tpu_torch.encode import dense

CODE = "mackay1008"


@pytest.fixture
def home(tmp_path, monkeypatch):
    """A fresh HOME, and the cache threshold below the code's n * m."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(dense, "_CACHE_CELLS", 1000)
    return tmp_path


def _jax_cache_name(spec) -> str:
    """The file name the JAX package's DenseEncoder.build gives `spec`."""
    h = hashlib.sha256()
    h.update(np.int64([spec.m, spec.n]).tobytes())
    for r in spec.row_cols:
        h.update(np.asarray(r, np.int32).tobytes())
    return f"G_{h.hexdigest()[:24]}.npz"


def test_limits_are_the_jax_packages():
    assert dense.LARGE_CELLS == JaxDenseEncoder.LARGE_CELLS
    assert dense._CACHE_CELLS == 64_000_000


def test_round_trip_matches_jax(home, monkeypatch):
    spec = get_code(CODE)
    path = dense.cache_path(spec)
    assert path == os.path.join(str(home), ".cache", "ecc_ldpc_tpu_torch",
                                _jax_cache_name(jax_get_code(CODE)))
    assert not os.path.exists(path)
    enc = dense.DenseEncoder.build(spec)
    assert os.path.exists(path)
    assert not [f for f in os.listdir(os.path.dirname(path))
                if ".tmp" in f]  # written under a temporary name, replaced
    G, cols = jax_generator(jax_get_code(CODE))
    np.testing.assert_array_equal(enc.G, G)
    np.testing.assert_array_equal(enc.info_cols, cols)
    # the second build reads the file: no elimination
    monkeypatch.setattr(dense, "systematic_generator", _no_elimination)
    again = dense.DenseEncoder.build(spec)
    np.testing.assert_array_equal(again.G, G)
    np.testing.assert_array_equal(again.info_cols, cols)
    with np.load(path) as z:
        assert set(z.files) == {"G_packed", "n", "info_cols"}
        assert int(z["n"]) == spec.n
        np.testing.assert_array_equal(z["G_packed"], np.packbits(G, axis=1))
    # cache=False eliminates anew
    monkeypatch.setattr(dense, "systematic_generator", jax_generator)
    assert dense.DenseEncoder.build(spec, cache=False).k == G.shape[0]


def _no_elimination(*a, **k):
    raise AssertionError("the cached generator was eliminated again")


def test_jax_written_file_loads(home, monkeypatch):
    """The JAX package's writer (DenseEncoder.build's savez_compressed of
    G_packed, n and info_cols), run in numpy into the port's directory:
    the port loads it, encodes with it, and eliminates nothing."""
    jspec = jax_get_code(CODE)
    G, cols = jax_generator(jspec)
    path = dense.cache_path(get_code(CODE))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, G_packed=np.packbits(G, axis=1),
                            n=np.int64(jspec.n), info_cols=cols)
    os.replace(tmp, path)
    monkeypatch.setattr(dense, "systematic_generator", _no_elimination)
    enc = dense.DenseEncoder.build(get_code(CODE))
    msg = np.random.default_rng(1).integers(0, 2, (4, enc.k), dtype=np.uint8)
    cw = enc(torch.from_numpy(msg)).numpy()
    H = get_code(CODE).dense()
    assert not ((cw.astype(np.int64) @ H.T.astype(np.int64)) % 2).any()
    np.testing.assert_array_equal(cw[:, cols], msg)


def test_small_codes_skip_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    dense.DenseEncoder.build(get_code(CODE))
    assert not (tmp_path / ".cache").exists()
