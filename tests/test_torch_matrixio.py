"""The port's matrix files (codes/matrixio.py, codes/alist.py) and code
registry (codes/registry.py) against the JAX package's: every format
round-trips and writes the JAX package's bytes, sniff_format reads each
alike, every registry form (bare paths included) resolves to the JAX
spec, and an unknown code raises KeyError listing the known ones.
"""
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import alist as jax_alist
from ecc_ldpc_tpu.codes import get_code as jax_get_code
from ecc_ldpc_tpu.codes import list_codes as jax_list_codes
from ecc_ldpc_tpu.codes import matrixio as jax_matrixio
from ecc_ldpc_tpu_torch.codes import alist, get_code, list_codes, matrixio

torch.set_num_threads(1)

FORMATS = {  # format -> (the port's writer, the JAX package's, prefix)
    "alist": (alist.dumps_alist, jax_alist.dumps_alist, "alist:"),
    "matlab": (matrixio.dumps_matlab_sparse, jax_matrixio.dumps_matlab_sparse,
               "mat:"),
    "dense": (matrixio.dumps_dense, jax_matrixio.dumps_dense, "dense:"),
}
# every registered family, and a spec string of each of its forms
FORMS = [
    "mackay1008", "gallager/504/3/6/s1", "gallager/252", "80211n/648/12",
    "wimax/1152/23A", "dvbs2/16200/12", "nr5g/bg1/208", "nr5g/bg1/208/3168",
    "nr5g/bg2/52/500/1200", "nr5g/bg2/52/500/1200/rv3",
    "punct/80211n~648~12/600:648", "punct/wimax~576~12/3,7,300",
    "sc/3/6/10/32/s1", "ccsds/1024/12", "ccsds/1024/23/s3", "8023an",
]


def same_spec(spec, jspec):
    assert (spec.n, spec.m, spec.k, spec.name) == (jspec.n, jspec.m, jspec.k,
                                                   jspec.name)
    assert spec.punctured_cols == jspec.punctured_cols
    assert spec.shortened_cols == jspec.shortened_cols
    assert all(np.array_equal(a, b)
               for a, b in zip(spec.row_cols, jspec.row_cols))
    assert (spec.qc is None) == (jspec.qc is None)
    base = getattr(spec.qc, "base", None)
    if base is not None:
        assert np.array_equal(base, jspec.qc.base)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_formats_round_trip(fmt, tmp_path):
    dumps, jax_dumps, prefix = FORMATS[fmt]
    spec, jspec = get_code("wimax/576/12"), jax_get_code("wimax/576/12")
    text = dumps(spec)
    assert text == jax_dumps(jspec)
    assert matrixio.sniff_format(text) == jax_matrixio.sniff_format(text) \
        == fmt
    back = matrixio.loads_matrix(text, name="w")
    assert all(np.array_equal(a, b)
               for a, b in zip(back.row_cols, spec.row_cols))
    path = tmp_path / f"w.{fmt}"
    path.write_text(text)
    for s in (f"{prefix}{path}", f"file:{path}", str(path)):
        same_spec(get_code(s), jax_get_code(s))


def test_sniff_format_edge_cases():
    # triplets whose indices are all 0/1 digits are triplets, narrow
    # space-separated dense rows are dense, nonsense raises
    for text in ("1 10 1\n10 11 1\n11 100 1\n", "0 1 1\n1 1 0\n",
                 "011\n110\n101\n"):
        assert matrixio.sniff_format(text) == jax_matrixio.sniff_format(text)
    for bad in ("", "1 2 3 4\n0 1\n"):
        with pytest.raises(ValueError):
            matrixio.sniff_format(bad)
        with pytest.raises(ValueError):
            jax_matrixio.sniff_format(bad)


@pytest.mark.parametrize("form", FORMS)
def test_registry_forms_match_jax(form):
    same_spec(get_code(form), jax_get_code(form))


def test_unknown_code_raises_key_error():
    assert list_codes() == jax_list_codes()
    with pytest.raises(KeyError, match="unknown code 'nosuch'") as e:
        get_code("nosuch/12")
    assert "nr5g" in str(e.value) and "wimax" in str(e.value)
    with pytest.raises(KeyError):
        jax_get_code("nosuch/12")
    # a known family with too few parts names its form
    with pytest.raises(ValueError, match="5G NR spec is 'nr5g/bgX/Zc"):
        get_code("nr5g/bg1")
