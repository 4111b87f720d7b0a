"""The ECC facade: encode / transmit / decode as one object (port of
ecc_ldpc_tpu/ecc.py).

One object ties a code, its encoder, a channel honoring its
puncture/shorten structure, and a decoder on one device, resolved from the
same compact spec strings the CLI uses.

    ecc  = build_ecc("dvbs2/64800/12", "layered/norm:0.8125/25")
    cw   = ecc.encode(msg)                     # [B, k] -> [B, n]
    llr  = ecc.transmit(gen, cw, ebn0_db=1.2)  # BPSK + AWGN + LLR
    out  = ecc.decode(llr)                     # DecodeResult
    m2   = ecc.extract_message(out.bits)

The default decoder is the JAX package's, flooding `minsum/norm:0.8125/25`:
on a QC code it runs the QC flooding kernel (K3), on an unstructured code
such as `mackay1008` the flooding kernel (K2), or their plain versions
with device="cpu". Any decoder spec of decode/api.py passes through (the
message precisions `q:B:S` and `/pallas`, `/cleanup`, `bitflip`, `gdbf`),
and codes/crc.with_crc(ecc, "24a") wraps a facade so its payloads carry a
CRC.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .chan.modem import build_channel
from .codes.registry import get_code
from .codes.spec import CodeSpec
from .decode.api import choose_graph, get_decoder
from .device import resolve_device
from .encode.structured import build_encoder


@dataclasses.dataclass
class ECC:
    name: str
    spec: CodeSpec
    encoder: object
    decoder: Callable
    channel: Callable

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def n(self) -> int:
        return self.spec.n

    @property
    def rate(self) -> float:
        return self.spec.rate

    def encode(self, msg_bits):
        return self.encoder(msg_bits)

    def transmit(self, gen, codeword_bits, ebn0_db):
        return self.channel(gen, codeword_bits, ebn0_db)

    def decode(self, llr):
        return self.decoder(llr)

    def extract_message(self, codeword_bits):
        return self.encoder.extract_message(codeword_bits)


def build_ecc(code: str, decoder: str = "minsum/norm:0.8125/25",
              device="cuda", channel: str = "bpsk",
              backend: Optional[str] = None) -> ECC:
    """The facade of one (code, decoder, channel) on `device`; `backend`
    overrides the decoder spec's (decode/api.make_decoder: "pallas" stores
    a layered decoder's messages as the TPU's kernel did)."""
    dev = resolve_device(device)
    spec = get_code(code)
    graph = choose_graph(spec, decoder)
    overrides = {"backend": backend} if backend else {}
    return ECC(
        name=f"{code}|{decoder}",
        spec=spec,
        encoder=build_encoder(spec),
        decoder=get_decoder(graph, decoder, device=dev, **overrides),
        channel=build_channel(spec, channel),
    )
