"""Modulation, channel and LLR computation (port of ecc_ldpc_tpu/chan):
BPSK over AWGN (awgn.py) and the channel-spec registry with its modems
(modem.py: hard-decision BPSK, BSC, BEC, Rayleigh, Gray QAM and 8PSK,
DVB-S2 APSK, the bit interleaver), under the JAX package's names."""

from .awgn import (
    awgn_llr,
    bpsk,
    llr_from_channel,
    make_channel,
    noise_sigma,
    q_function,
    uncoded_bpsk_ber,
)
from .modem import (
    Channel,
    bsc_llr,
    build_channel,
    hard_bpsk_awgn_llr,
    parse_channel_spec,
    qam_awgn_llr,
    qam_modulate,
)

__all__ = [
    "awgn_llr",
    "make_channel",
    "bpsk",
    "llr_from_channel",
    "noise_sigma",
    "q_function",
    "uncoded_bpsk_ber",
    "Channel",
    "bsc_llr",
    "build_channel",
    "hard_bpsk_awgn_llr",
    "parse_channel_spec",
    "qam_awgn_llr",
    "qam_modulate",
]
