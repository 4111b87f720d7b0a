"""The layer-step time of the cluster-tile kernels (csrc/cluster_tile.cuh)
at full width, on one CUDA card:

    python -m ecc_ldpc_tpu_torch.bench.cluster_probe

For each plan of decode/layered_qc.candidate_plans at the headline batch
(dvbs2/64800/12, 4096 frames, 1.5 dB: one a cluster size), the min-sum
kernel (K1a, alpha 0.8125) and the spa kernel (K1c) decode
the same LLRs in fixed mode at T = 2, 6 and 25 iterations. The time of a
layer step is the slope over the extra iterations, divided by the waves
of tiles and the layers:

    t_layer = (ms(6) - ms(2)) / (4 * waves * mb),
    waves = ceil(tiles / resident clusters),

each ms the median of 3 decodes timed by CUDA events. The design's rule:
waves x 25 x mb x t_layer must beat the 105 ms that K1a took with its
posteriors in HBM. Prints one JSON line per (kernel, plan), after the
card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..decode import layered_qc
from .throughput import make_inputs

T_SHORT, T_LONG = 2, 6
KERNELS = {"layered_qc": "minsum", "layered_exact": "spa"}


def _ms(fn, tries: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(tries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("cluster_probe times the card; no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = make_inputs("dvbs2/64800/12", "layered/norm:0.8125/25/noet", 4096,
                    1.5, dev, seed=0)
    g, llr = x.graph, x.llr
    chosen = layered_qc.tile_plan
    for name, cn in KERNELS.items():
        for _, _, plan in layered_qc.candidate_plans(g, llr.shape[0], cn,
                                                     sms):
            layered_qc.tile_plan = lambda *a, _p=plan, **k: _p
            try:
                wrapper = (layered_qc.layered_decode_cuda
                           if name == "layered_qc"
                           else layered_qc.layered_exact_cuda)
                kw = (dict(alpha=0.8125) if name == "layered_qc"
                      else dict(cn=cn))
                ms = {T: _ms(lambda: wrapper(g, llr, max_iters=T,
                                             early_term=False, **kw))
                      for T in (T_SHORT, T_LONG, 25)}
                resident = wrapper.last_plan[1]
            finally:
                layered_qc.tile_plan = chosen
            waves = -(-plan.tiles // resident)
            t_layer = (ms[T_LONG] - ms[T_SHORT]) / (
                (T_LONG - T_SHORT) * waves * g.mb) * 1e3
            print(json.dumps({
                "kernel": name, "cn": cn, "plan": plan.as_dict(),
                "resident_clusters": resident, "waves": waves,
                "ms": {str(k): v for k, v in ms.items()},
                "t_layer_us": t_layer,
                "predicted_25_ms": waves * 25 * g.mb * t_layer / 1e3,
                "chosen": plan == chosen(g, llr.shape[0], cn, sms),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
