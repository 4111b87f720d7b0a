"""The ablation variants of csrc/ablate_layered.cu as flag sets (its
template parameter FL). The build holds one library a static set
(_build.ABLATE_STATIC_FLAGS: E2's and E3's)."""

ROLL, SIGN, MIN2, VROW, CASTQ, SUB, CAP = 1, 2, 4, 8, 16, 32, 64

# experiments/ablate_layered.py:150-159 (E1): every cost on, and the cap
E1_FULL = ROLL | SIGN | MIN2 | VROW | CASTQ | SUB | CAP
E1_VARIANTS = {
    "full": E1_FULL,
    "noroll": E1_FULL & ~ROLL,
    "nosign": E1_FULL & ~SIGN,
    "nomin2": E1_FULL & ~MIN2,
    "novrow": E1_FULL & ~VROW,
    "nocastq": E1_FULL & ~CASTQ,
    "floor": SUB | CAP,
}
# experiments/ablate_layered2.py:157-166 (E2): the posterior takes the
# unrounded message, no cap
E2_FULL = ROLL | SIGN | MIN2 | VROW | SUB
E2_VARIANTS = {
    "full": E2_FULL,
    "noroll": E2_FULL & ~ROLL,
    "nosign": E2_FULL & ~SIGN,
    "nomin2": E2_FULL & ~MIN2,
    "novrow": E2_FULL & ~VROW,
    "nosub": E2_FULL & ~SUB,
    "floor": 0,
}
# experiments/static_unroll.py (E3): the posterior takes the bf16-rounded
# message, no cap
E3_FLAGS = ROLL | SIGN | MIN2 | VROW | CASTQ | SUB
