"""String-named code registry (port of ecc_ldpc_tpu/codes/registry.py).

Only the DVB-S2 family is ported so far:

  dvbs2/64800/12                  DVB-S2 normal frame rate 1/2
  dvbs2/16200/12                  DVB-S2 short frame rate 1/2
"""
from __future__ import annotations

from .spec import CodeSpec

_PORTED = ("dvbs2",)


def get_code(spec_str: str) -> CodeSpec:
    """Resolve a compact code-spec string ('dvbs2/N/R') to a CodeSpec."""
    head, *args = spec_str.split("/")
    if head == "dvbs2":
        from .dvbs2 import dvbs2

        if len(args) != 2:
            raise ValueError(f"DVB-S2 spec is 'dvbs2/N/R', got {spec_str!r}")
        return dvbs2(int(args[0]), args[1])
    raise NotImplementedError(
        f"code {spec_str!r}: only the {_PORTED} families are ported; the "
        f"others wait in ROADMAP.md Queue 1 step 15 (other code families)"
    )
