"""Learned decoder parameters (port of ecc_ldpc_tpu/learn/): per-iteration
min-sum schedules, trained through the unrolled decoder (noms.py) and
shipped as JSON (schedules.py)."""

from .noms import (
    NomsParams,
    list_schedules,
    load_schedule,
    soft_ber_loss,
    train_noms,
    unrolled_posteriors,
)

__all__ = [
    "NomsParams",
    "list_schedules",
    "load_schedule",
    "soft_ber_loss",
    "train_noms",
    "unrolled_posteriors",
]
