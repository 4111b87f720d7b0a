"""String-named code registry (port of ecc_ldpc_tpu/codes/registry.py).

Ported so far:

  dvbs2/64800/12                  DVB-S2 normal frame rate 1/2
  dvbs2/16200/12                  DVB-S2 short frame rate 1/2
  ccsds/4096/12                   CCSDS AR4JA k=4096 rate 1/2
  ccsds/1024/45/s3                the same family at rate 4/5, shift seed 3
  8023an                          IEEE 802.3an (2048, 1723) RS-LDPC, xor blocks
  mackay1008                      shipped (3,6) n=1008 code
  alist:/path/to/code.alist       load from file
"""
from __future__ import annotations

from .spec import CodeSpec

_PORTED = ("dvbs2", "ccsds", "8023an", "mackay1008", "alist:")


def get_code(spec_str: str) -> CodeSpec:
    """Resolve a compact code-spec string to a CodeSpec."""
    if spec_str.startswith("alist:"):
        from .alist import load_alist

        return load_alist(spec_str[len("alist:"):])
    head, *args = spec_str.split("/")
    if head == "dvbs2":
        from .dvbs2 import dvbs2

        if len(args) != 2:
            raise ValueError(f"DVB-S2 spec is 'dvbs2/N/R', got {spec_str!r}")
        return dvbs2(int(args[0]), args[1])
    if head == "ccsds":
        from .ccsds import ar4ja

        if len(args) not in (2, 3):
            raise ValueError(
                f"CCSDS spec is 'ccsds/K/R[/sSEED]', got {spec_str!r}")
        seed = args[2] if len(args) == 3 else "s0"
        return ar4ja(int(args[0]), args[1], seed=int(seed.lstrip("s")))
    if head == "8023an" and not args:
        from .ieee8023an import ieee8023an

        return ieee8023an()
    if head == "mackay1008" and not args:
        from .mackay import mackay_1008

        return mackay_1008()
    raise NotImplementedError(
        f"code {spec_str!r}: only {_PORTED} are ported; the other families "
        f"wait in ROADMAP.md Queue 1 step 15 (other code families)"
    )
