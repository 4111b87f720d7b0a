"""What the correctness tests put in the place of the timed path: the
control (the reference itself, stored in bfloat16) and the faults a cell
can have, each as a `wrap` for harness.run_cell."""
from __future__ import annotations

import types

import torch


def _result(bits, ok, iterations):
    return types.SimpleNamespace(bits=bits, ok=ok, iterations=iterations)


def control(cell):
    """The reference in the program's place, every stored value in bf16."""
    table, code_ref, dec_ref = cell.table, cell.code_ref, cell.decoder_ref
    spec = dec_ref.parse(cell.mix.decoder)

    def decode(llr):
        return dec_ref.decode(table, llr, spec, precision="bf16")

    if cell.mix.kind == "decode":
        return lambda dec: (lambda llr: _result(*decode(llr)))

    def wrap(pipe):
        pipe.encode = lambda msg: code_ref.encode(table, msg)
        pipe.channel = lambda _, cw, e, z: code_ref.llr(table, cw, z, e, "bf16")

        def dec(llr):
            bits, _, iters = decode(llr)
            return bits[:, :table.k], iters
        pipe.decode = dec
        return pipe
    return wrap


def unchanged(cell):
    """A decoder that returns its input state: the channel's hard
    decisions, no iteration."""
    def hard(llr):
        bits = (llr < 0).to(torch.uint8)
        zeros = torch.zeros(llr.shape[0], dtype=torch.int32, device=llr.device)
        return bits, zeros.bool(), zeros

    if cell.mix.kind == "decode":
        return lambda dec: (lambda llr: _result(*hard(llr)))

    def wrap(pipe):
        def dec(llr):
            bits, _, iters = hard(llr)
            return bits[:, :cell.table.k], iters
        pipe.decode = dec
        return pipe
    return wrap


def half(cell):
    """Half of the batch left out: the first half is decoded, the result
    stands for the whole (a decode repeats it; a step counts it twice)."""
    if cell.mix.kind == "decode":
        def wrap(dec):
            def call(llr):
                res = dec(llr[: llr.shape[0] // 2])
                return _result(*(torch.cat([x, x]) for x in
                                 (res.bits, res.ok, res.iterations)))
            return call
        return wrap

    def wrap(pipe):
        counts0 = pipe.counts

        def counts(msg, noise, ebn0_db):
            h = msg.shape[0] // 2
            return 2 * counts0(msg[:h], noise[:h], ebn0_db)
        pipe.counts = counts
        return pipe
    return wrap


def altered(cell):
    """One decoded bit flipped where the decoder produces it."""
    if cell.mix.kind == "decode":
        def wrap(dec):
            def call(llr):
                res = dec(llr)
                bits = res.bits.clone()
                bits[0, 0] ^= 1
                return _result(bits, res.ok, res.iterations)
            return call
        return wrap

    def wrap(pipe):
        decode0 = pipe.decode

        def dec(llr):
            msg_hat, iters = decode0(llr)
            msg_hat = msg_hat.clone()
            msg_hat[0, 0] ^= 1
            return msg_hat, iters
        pipe.decode = dec
        return pipe
    return wrap


def encoded(cell):
    """One codeword bit flipped where the sweep's encoder produces it (the
    decode cells have no encoder on their timed path)."""
    def wrap(pipe):
        encode0 = pipe.encode

        def enc(msg):
            cw = encode0(msg).clone()
            cw[0, -1] ^= 1
            return cw
        pipe.encode = enc
        return pipe
    return wrap


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
