"""Ablation study v2: where the STATIC-ROWS layered kernel's time goes, in
the throughput regime (E2; port of experiments/ablate_layered2.py).

The same sweep as ablate_layered.py with the code's tables compiled in
(csrc/ablate_layered.cu built with ABLATE_STATIC_FLAGS, one library a
variant, from csrc/ablate_static_dvbs2_64800_12.cuh): every edge's column
home and shift an immediate. The posterior takes the unrounded message and
nothing is capped, as in the TPU script; `nosub` drops the old-message
subtract (and its prefetch). Timed at the headline's B = 4096, the card's
counterpart of the TPU script's 8 overlapped one-tile calls, beside K1a
(bf16 storage) in the same process. The variants decode wrongly on
purpose; this measures time only.

Run:  python -m ecc_ldpc_tpu_torch.experiments.ablate_layered2 [--device cpu]
"""
from __future__ import annotations

import sys

from . import common
from .ablate import ITERS, THROUGHPUT_B
from .ablate_layered import run_variants
from .variants import E2_VARIANTS


def main(argv=None) -> int:
    p = common.parser(__doc__)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--batch", type=int, default=THROUGHPUT_B)
    args = p.parse_args(argv)
    dev, card = common.start(args)
    run_variants("ablate_layered2", E2_VARIANTS, args.batch, dev, card,
                 args.tries, args.iters, True, "throughput")
    return 0


if __name__ == "__main__":
    sys.exit(main())
