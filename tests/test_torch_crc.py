"""The port's CRC (codes/crc.py) against the JAX package's codes/crc.py:
the bit-serial reference, the GF(2) matrix, attach and check for all
five polynomials, and with_crc over the port's ECC facade on the CPU.
Everything here is integer arithmetic: identical bits are the contract.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecc_ldpc_tpu.codes import crc as jax_crc
from ecc_ldpc_tpu_torch.codes import crc
from ecc_ldpc_tpu_torch.ecc import build_ecc

torch.set_num_threads(1)

NAMES = ["24a", "24b", "16", "11", "6"]


def test_polynomials_are_the_jax_packages():
    assert crc.POLYNOMIALS == jax_crc.POLYNOMIALS


@pytest.mark.parametrize("name", NAMES)
def test_reference_and_matrix_match_jax(name):
    rng = np.random.default_rng(len(name))
    for k in (1, 7, 200, 1000):
        assert np.array_equal(crc.crc_matrix(name, k),
                              jax_crc.crc_matrix(name, k))
        m = rng.integers(0, 2, k).astype(np.uint8)
        ref = crc.crc_bits_ref(m, name)
        assert np.array_equal(ref, jax_crc.crc_bits_ref(m, name))
        assert np.array_equal((crc.crc_matrix(name, k).astype(np.int64) @ m)
                              % 2, ref)


@pytest.mark.parametrize("name", NAMES)
def test_attach_and_check_match_jax(name):
    k = 300
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 2, (16, k), dtype=np.uint8)
    attach, check = crc.make_crc(name, k)
    jattach, jcheck = jax_crc.make_crc(name, k)
    got = attach(torch.from_numpy(msg))
    want = np.asarray(jattach(jnp.asarray(msg)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # every single-bit corruption, payload or CRC field, is detected
    bad = got.clone()
    pos = rng.integers(0, got.shape[1], 16)
    bad[torch.arange(16), torch.from_numpy(pos)] ^= 1
    for x in (got, bad):
        assert np.array_equal(check(x).numpy(),
                              np.asarray(jcheck(jnp.asarray(x.numpy()))))
    assert bool(check(got).all()) and not bool(check(bad).any())


def test_crc16_known_vector():
    """CRC-16/XMODEM of ASCII '123456789' is 0x31C3."""
    bits = np.unpackbits(np.frombuffer(b"123456789", dtype=np.uint8))
    val = int("".join(map(str, crc.crc_bits_ref(bits, "16"))), 2)
    assert val == 0x31C3


def test_with_crc_over_the_ecc_on_the_cpu():
    """Payloads carry CRC24B through encode, channel and decode; ok is the
    syndrome AND the CRC, so a tampered message bit fails the check."""
    ecc = crc.with_crc(build_ecc("80211n/648/12", "layered/norm:0.8125/25",
                                 device="cpu"), "24b")
    assert ecc.k_payload == 324 - 24
    gen = torch.Generator().manual_seed(2)
    payload = torch.randint(0, 2, (8, ecc.k_payload), generator=gen,
                            dtype=torch.uint8)
    cw = ecc.encode(payload)
    out = ecc.decode(ecc.transmit(gen, cw, 6.0))
    assert bool(out.ok.all())
    assert torch.equal(ecc.extract_payload(out.bits), payload)
    _, check = crc.make_crc("24b", ecc.k_payload)
    msg_crc = ecc.extract_message(out.bits)
    tampered = msg_crc.clone()
    tampered[:, 3] ^= 1
    assert not bool(check(tampered).any())
    # a decoder that passes its parity check on a wrong message: the
    # wrapper's ok is false there
    inner = ecc.decoder

    def wrong_message(llr):
        res = inner(llr)
        bits = res.bits.clone()
        bits[:, 0] ^= 1  # a message bit; the syndrome flag stays true
        return type(res)(bits=bits, ok=res.ok, iterations=res.iterations)

    tampered_ecc = crc.with_crc(
        type(ecc)(name="tampered", spec=ecc.spec, encoder=ecc.encoder,
                  decoder=wrong_message, channel=ecc.channel), "24b")
    res = tampered_ecc.decode(ecc.transmit(gen, cw, 6.0))
    assert bool(inner(ecc.transmit(gen, cw, 6.0)).ok.all())
    assert not bool(res.ok.any())
    with pytest.raises(ValueError, match="too small"):
        crc.with_crc(types.SimpleNamespace(k=10), "24a")
