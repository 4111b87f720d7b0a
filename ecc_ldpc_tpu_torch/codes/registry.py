"""String-named code registry (port of ecc_ldpc_tpu/codes/registry.py):
every form the JAX registry resolves, resolved to the same CodeSpec.

Examples:
  mackay1008                      shipped (3,6) n=1008 code
  gallager/2048/3/6/s0            (3,6)-regular n=2048, seed 0
  alist:/path/to/code.alist       load from file (also mat:, dense:, file:,
                                  and a bare path, whose format is sniffed)
  80211n/648/12                   802.11n n=648 rate 1/2  (rate as "12" etc.)
  wimax/1152/23A                  WiMAX n=1152 rate 2/3A
  dvbs2/64800/12                  DVB-S2 normal frame rate 1/2
  nr5g/bg1/208/3168               5G NR BG1, Zc=208, k=3168 (filler bits)
  nr5g/bg2/52/500/1200/rv2        the same with n_tx and a redundancy version
  punct/80211n~1944~12/0:81       puncture positions of an inner code
  sc/3/6/10/64                    spatially coupled (J, K, L, Z)
  ccsds/1024/12                   CCSDS AR4JA k=1024 rate 1/2
  8023an                          IEEE 802.3an 10GBASE-T (2048, 1723)

An unknown name raises KeyError listing the known ones; a known name with
too few or too many parts raises ValueError naming its form.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict

from .spec import CodeSpec

_REGISTRY: Dict[str, Callable[..., CodeSpec]] = {}
# a family's name and spec form, for the error on a spec with too few or
# too many parts (the JAX registry lets the constructor's TypeError out)
SPEC_FORMS = {
    "mackay1008": ("mackay1008", "mackay1008"),
    "gallager": ("Gallager", "gallager/N[/J[/K[/sSEED]]]"),
    "80211n": ("802.11n", "80211n/N/R"),
    "wimax": ("WiMAX", "wimax/N/R"),
    "dvbs2": ("DVB-S2", "dvbs2/N/R"),
    "nr5g": ("5G NR", "nr5g/bgX/Zc[/k[/n_tx[/rvN]]]"),
    "punct": ("punct", "punct/inner~with~tildes/positions"),
    "ccsds": ("CCSDS", "ccsds/K/R[/sSEED]"),
    "8023an": ("IEEE 802.3an", "8023an"),
    "sc": ("SC", "sc/J/K/L/Z[/sSEED]"),
}


def register(name: str, fn: Callable[..., CodeSpec]) -> None:
    _REGISTRY[name] = fn


def list_codes():
    return sorted(_REGISTRY)


def get_code(spec_str: str) -> CodeSpec:
    """Resolve a compact code-spec string to a CodeSpec."""
    if spec_str.startswith("alist:"):
        from .alist import load_alist

        return load_alist(spec_str[len("alist:"):])
    if spec_str.startswith("mat:"):
        from .matrixio import load_matlab_sparse

        return load_matlab_sparse(spec_str[len("mat:"):])
    if spec_str.startswith("dense:"):
        from .matrixio import load_dense

        return load_dense(spec_str[len("dense:"):])
    if spec_str.startswith("file:"):
        from .matrixio import load_matrix

        return load_matrix(spec_str[len("file:"):])
    parts = spec_str.split("/")
    head, args = parts[0], parts[1:]
    if head not in _REGISTRY:
        import os

        if os.path.exists(spec_str):
            # bare path: sniff alist / MATLAB-triplet / dense 0/1 text
            from .matrixio import load_matrix

            return load_matrix(spec_str)
        raise KeyError(f"unknown code {head!r}; known: {list_codes()}")
    fn = _REGISTRY[head]
    try:
        inspect.signature(fn).bind(*args)
    except TypeError:
        what, form = SPEC_FORMS.get(head, (head, head))
        raise ValueError(f"{what} spec is {form!r}, got {spec_str!r}") \
            from None
    return fn(*args)


def _register_builtins() -> None:
    from .dvbs2 import dvbs2
    from .gallager import gallager_regular
    from .ieee80211n import ieee80211n
    from .mackay import mackay_1008
    from .nr5g import nr5g
    from .wimax import wimax

    register("mackay1008", lambda: mackay_1008())

    def _gallager(n, j="3", k="6", seed="s0"):
        return gallager_regular(int(n), int(j), int(k), seed=int(seed.lstrip("s")))

    register("gallager", _gallager)
    register("80211n", lambda n, rate: ieee80211n(int(n), rate))
    register("wimax", lambda n, rate: wimax(int(n), rate))
    register("dvbs2", lambda n, rate: dvbs2(int(n), rate))
    def _nr5g(bg, zc, k=None, n_tx=None, rv=None):
        # 'nr5g/bg1/384/8448/12672/rv2' — redundancy version as a trailing
        # 'rvN' component (38.212 §5.4.2.1 circular buffer; codes/nr5g.py)
        return nr5g(
            bg, int(zc),
            None if k is None else int(k),
            None if n_tx is None else int(n_tx),
            None if rv is None else int(rv.lstrip("rv")),
        )

    register("nr5g", _nr5g)

    def _punct(inner, positions):
        from .puncture import parse_positions, puncture

        spec = get_code(inner.replace("~", "/"))
        return puncture(spec, parse_positions(positions, spec.n))

    register("punct", _punct)

    def _ccsds(k, rate, seed="s0"):
        from .ccsds import ar4ja
        return ar4ja(int(k), rate, seed=int(seed.lstrip("s")))

    register("ccsds", _ccsds)

    def _8023an():
        from .ieee8023an import ieee8023an

        return ieee8023an()

    register("8023an", _8023an)

    def _sc(j, k, l, z, seed="s0"):
        from .sc import sc_regular

        return sc_regular(int(j), int(k), int(l), int(z),
                          seed=int(seed.lstrip("s")))

    register("sc", _sc)


_register_builtins()
