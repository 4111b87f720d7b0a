"""Channel-spec strings (port of ecc_ldpc_tpu/chan/modem.py:567-641).

`parse_channel_spec` reads every spec the JAX package reads and returns
the same dicts. `build_channel` serves 'bpsk' (BPSK over AWGN through
chan/awgn.make_channel, honoring the code's punctured and shortened
positions); the other channels raise until their modems are ported.
"""
from __future__ import annotations

from typing import Callable

from .awgn import make_channel

_QAM_NAMES = {"qpsk": 4, "qam4": 4, "qam16": 16, "qam64": 64, "qam256": 256}
# DVB-S2 APSK ring ratios per code rate (ecc_ldpc_tpu/chan/modem.py:293-296)
APSK16_GAMMA = {"23": 3.15, "34": 2.85, "45": 2.75, "56": 2.70,
                "89": 2.60, "910": 2.57}
APSK32_GAMMA = {"34": (2.84, 5.27), "45": (2.72, 4.87), "56": (2.64, 4.64),
                "89": (2.54, 4.33), "910": (2.53, 4.30)}
_WAITING = ("ROADMAP.md Queue 1 step 12 (chan/modem.py: QAM/PSK/APSK, "
            "BSC/BEC/Rayleigh/hard)")


def parse_channel_spec(spec: str) -> dict:
    """'bpsk' | 'hard' | 'bsc:P' | 'qpsk' | 'qamM' -> build kwargs."""
    s = spec.strip().lower()
    if s in ("bpsk", "awgn", "bpsk-awgn"):
        return {"kind": "bpsk"}
    if s in ("hard", "bpsk-hard"):
        return {"kind": "hard"}
    if s in ("rayleigh", "bpsk-rayleigh"):
        return {"kind": "rayleigh"}
    if s.startswith("bsc:"):
        p = float(s[4:])
        if not 0.0 < p < 0.5:
            raise ValueError(f"BSC crossover must be in (0, 0.5), got {p}")
        return {"kind": "bsc", "p": p}
    if s.startswith("bec:"):
        eps = float(s[4:])
        if not 0.0 < eps < 1.0:
            raise ValueError(f"BEC erasure prob must be in (0, 1), got {eps}")
        return {"kind": "bec", "eps": eps}
    il = False
    if s.endswith(":il"):
        il, s = True, s[:-3]

    def _with_il(d):  # keep bare specs' dicts unchanged (il only if set)
        if il:
            d["il"] = True
        return d

    if s in _QAM_NAMES:
        return _with_il({"kind": "qam", "M": _QAM_NAMES[s]})
    if s in ("8psk", "psk8"):
        return _with_il({"kind": "psk", "M": 8})
    if s.startswith("apsk16") or s.startswith("apsk32"):
        M = int(s[4:6])
        parts = s[6:].split(":") if len(s) > 6 else []
        gs = []
        for p in parts:
            if not p:
                continue
            if p.startswith("g"):
                gs.append(float(p[1:]))
            elif p.startswith("r"):
                tab = APSK16_GAMMA if M == 16 else APSK32_GAMMA
                if p[1:] not in tab:
                    raise ValueError(
                        f"unknown APSK rate key {p!r}; one of "
                        f"{sorted(tab)}")
                g = tab[p[1:]]
                gs = list(g) if isinstance(g, tuple) else [g]
            else:
                raise ValueError(f"bad APSK option {p!r} in {spec!r}")
        if not gs:
            gs = [APSK16_GAMMA["34"]] if M == 16 else list(APSK32_GAMMA["34"])
        if M == 32 and len(gs) != 2:
            raise ValueError("apsk32 needs two ring ratios (':gG1:gG2')")
        gamma = gs[0] if M == 16 else (gs[0], gs[1])
        return _with_il({"kind": "apsk", "M": M, "gamma": gamma})
    raise ValueError(
        f"unknown channel spec {spec!r} — one of bpsk, hard, rayleigh, "
        f"bsc:P, bec:EPS, qpsk, 8psk, qam16, qam64, qam256, "
        f"apsk16[:rRATE|:gG][:il], apsk32[:rRATE|:gG:gG][:il]"
    )


def build_channel(code_spec, channel: str = "bpsk") -> Callable:
    """Channel function f(gen, codeword_bits, ebn0_db, noise=None) -> llr
    for a code (gen: a torch.Generator on the codeword's device; noise: the
    unit normals instead, when the caller draws them)."""
    kind = parse_channel_spec(channel)["kind"]
    if kind != "bpsk":
        raise NotImplementedError(
            f"channel {channel!r} is not ported yet; it waits for {_WAITING}")
    return make_channel(code_spec)
