"""Encoder and full-pipeline throughput on the card (port of
ecc_ldpc_tpu/bench/pipeline.py).

The headline metric is decoded Mbit/s (bench/throughput.py); a production
system also needs to know what the encoders and the complete encode ->
channel -> decode step sustain, since a slow front end caps the pipeline
however fast the decoder is. Each is timed as `chain` dependent steps
between two CUDA events, after a warm-up chain; the per-step time is the
median over `tries` chains divided by `chain`. Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..device import device_name, resolve_device
from .throughput import event_seconds


@dataclasses.dataclass
class PipelineBenchResult:
    encode_mbps: float  # info bits through the encoder
    pipeline_mbps: float  # info bits through encode+channel+decode
    decode_share: float  # fraction of pipeline time in the decoder
    code: str
    decoder: str
    batch: int
    device: str

    def json_line(self) -> str:
        return json.dumps({
            "metric": "pipeline_throughput",
            "encode_mbps": round(self.encode_mbps, 1),
            "pipeline_mbps": round(self.pipeline_mbps, 3),
            "decode_share": round(self.decode_share, 4),
            "code": self.code,
            "decoder": self.decoder,
            "batch": self.batch,
            "device": self.device,
        })


def _step_seconds(run, chain: int, tries: int) -> float:
    """Median over `tries` of one chain's seconds, divided by `chain`."""
    run()  # warm-up (and the build, on first use)
    return float(np.median([event_seconds(run) for _ in range(tries)])
                 ) / chain


def run_pipeline_benchmark(
    code: str = "dvbs2/64800/12",
    decoder: str = "layered/norm:0.8125/25/noet",
    batch: int = 1024,
    ebn0_db: float = 2.5,
    chain: int = 20,
    tries: int = 3,
    device="cuda",
) -> PipelineBenchResult:
    from ..chan.awgn import make_channel
    from ..codes.registry import get_code
    from ..decode.api import choose_graph, get_decoder
    from .throughput import _encoder

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("run_pipeline_benchmark times the card; it has no "
                         "CPU mode")
    spec = get_code(code)
    enc = _encoder(code)
    channel = make_channel(spec)
    dec = get_decoder(choose_graph(spec, decoder), decoder, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    msg0 = torch.randint(0, 2, (batch, spec.k), generator=gen, device=dev,
                         dtype=torch.uint8)

    # chain rule: the next message XORs with a ROLLED view of the previous
    # step's output; a plain XOR with the extracted message would be
    # identically zero (systematic codes), collapsing the chain to
    # all-zero frames, while the roll keeps every step's input
    # data-dependent and nondegenerate
    def run_encode():
        msg = msg0
        for _ in range(chain):
            cw = enc(msg)
            msg = msg ^ torch.roll(enc.extract_message(cw), 1, dims=1)

    def run_pipeline():
        msg = msg0
        for _ in range(chain):
            llr = channel(gen, enc(msg), ebn0_db)
            bits = dec(llr).bits
            msg = msg ^ torch.roll(enc.extract_message(bits), 1, dims=1)

    t_enc = _step_seconds(run_encode, chain, tries)
    t_pipe = _step_seconds(run_pipeline, chain, tries)
    bits = batch * spec.k
    return PipelineBenchResult(
        encode_mbps=bits / t_enc / 1e6,
        pipeline_mbps=bits / t_pipe / 1e6,
        decode_share=max(0.0, (t_pipe - t_enc) / t_pipe),
        code=code,
        decoder=decoder,
        batch=batch,
        device=device_name(dev),
    )
