"""CRC attach/check as GF(2) matrix ops (port of ecc_ldpc_tpu/codes/crc.py).

5G NR attaches a CRC to every transport block and code block before LDPC
encoding (38.212 §5.1: CRC24A on the transport block, CRC24B on code
blocks; CRC16/11/6 for small blocks). The receiver validates decoded
payloads with it, which catches the rare frames whose wrong codeword
still satisfies every parity check.

CRC is linear over GF(2), so a batch's CRCs are one [B, k] x [k, r]
product mod 2. The matrix is built on the host by running the bit-serial
reference CRC on unit vectors (that reference is also the tests' oracle).
The product runs in f32 and takes % 2: cuBLAS has no int32 matrix
product, and the sums of 0/1 terms are exact in f32 below 2^24 (k here is
at most 8448), as encode/dense.py does.

Polynomials (3GPP 38.212 §5.1, MSB first, implicit leading x^r term):
  24A: x^24 + x^23 + x^18 + x^17 + x^14 + x^11 + x^10 + x^7 + x^6
       + x^5 + x^4 + x^3 + x + 1                        (0x864CFB)
  24B: x^24 + x^23 + x^6 + x^5 + x + 1                  (0x800063)
  16:  x^16 + x^12 + x^5 + 1                            (0x1021)
  11:  x^11 + x^10 + x^9 + x^5 + 1                      (0x621)
  6:   x^6 + x^5 + 1                                    (0x21)
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

POLYNOMIALS = {
    "24a": (24, 0x864CFB),
    "24b": (24, 0x800063),
    "16": (16, 0x1021),
    "11": (11, 0x621),
    "6": (6, 0x21),
}


def crc_bits_ref(bits, name: str) -> np.ndarray:
    """Bit-serial reference CRC (the oracle): long division of
    bits(x) * x^r by g(x) over GF(2). bits: 1-D 0/1 array, MSB first."""
    r, poly = POLYNOMIALS[name]
    reg = 0
    top = 1 << r
    for b in np.asarray(bits, dtype=np.int64):
        reg = (reg << 1) | int(b)
        if reg & top:
            reg ^= top | poly
    for _ in range(r):
        reg <<= 1
        if reg & top:
            reg ^= top | poly
    return np.asarray([(reg >> (r - 1 - i)) & 1 for i in range(r)],
                      dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def crc_matrix(name: str, k: int) -> np.ndarray:
    """uint8 [r, k] GF(2) matrix M with crc(m) = M @ m mod 2. Column j is
    the CRC of the unit impulse at position j, which equals the CRC of an
    impulse at position 0 of a message of length k - j: all columns come
    from one backward register recursion, O(k * r)."""
    r, poly = POLYNOMIALS[name]
    M = np.zeros((r, k), dtype=np.uint8)
    reg_bits = crc_bits_ref(np.asarray([1], dtype=np.int64), name)
    M[:, k - 1] = reg_bits
    reg = 0
    for i in range(r):
        reg = (reg << 1) | int(reg_bits[i])
    top = 1 << r
    for j in range(k - 2, -1, -1):
        reg <<= 1  # one more trailing zero in the message
        if reg & top:
            reg ^= top | poly
        M[:, j] = [(reg >> (r - 1 - i)) & 1 for i in range(r)]
    return M


def make_crc(name: str, k: int, device=None):
    """(attach, check) for k-bit payloads: attach uint8 [B, k] -> [B, k+r]
    (payload then CRC), check [B, k+r] -> bool [B]. The matrix lives on
    `device`, or (None) on the device of each call's bits, moved there
    once."""
    r, _ = POLYNOMIALS[name]
    Mt = torch.as_tensor(crc_matrix(name, k).T, dtype=torch.float32)
    on = {}
    if device is not None:
        on[torch.device(device)] = Mt.to(device)

    def crc(bits):
        dev = bits.device
        if dev not in on:
            on[dev] = Mt.to(dev)
        return torch.remainder(bits[..., :k].to(torch.float32) @ on[dev], 2.0)

    def attach(msg):
        return torch.cat([msg, crc(msg).to(msg.dtype)], dim=-1)

    def check(msg_crc):
        return (crc(msg_crc).to(torch.uint8)
                == msg_crc[..., k:].to(torch.uint8)).all(-1)

    return attach, check


def with_crc(ecc, name: str = "24b"):
    """Wrap an ECC facade (ecc.build_ecc) so its messages carry a CRC:
    the payload shrinks by r bits, encode attaches the CRC, and decode
    also checks it — DecodeResult.ok becomes (syndrome ok) AND (CRC ok),
    catching undetected-error frames a parity check alone would pass."""
    from ..decode.types import DecodeResult

    r, _ = POLYNOMIALS[name]
    k_payload = ecc.k - r
    if k_payload <= 0:
        raise ValueError(f"code k={ecc.k} too small for CRC{name}")
    attach, check = make_crc(name, k_payload)

    wrapped = dataclasses.replace(ecc)
    inner_decode = ecc.decode
    inner_encode = ecc.encode
    inner_extract = ecc.extract_message

    def encode(payload):
        return inner_encode(attach(payload))

    def decode(llr):
        res = inner_decode(llr)
        msg_crc = inner_extract(res.bits)
        return DecodeResult(bits=res.bits, ok=res.ok & check(msg_crc),
                            iterations=res.iterations)

    def extract_payload(codeword_bits):
        return inner_extract(codeword_bits)[..., :k_payload]

    wrapped.encode = encode
    wrapped.decode = decode
    wrapped.extract_payload = extract_payload
    wrapped.k_payload = k_payload
    return wrapped
