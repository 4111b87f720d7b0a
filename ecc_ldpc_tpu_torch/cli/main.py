"""Command line of the port (port of ecc_ldpc_tpu/cli/main.py:21-132 and the
sweep, compare, plot and codes subcommands). Usage:

  python -m ecc_ldpc_tpu_torch.cli sweep \\
      --code dvbs2/64800/12 \\
      --decoder "layered/norm:0.8125/50;retry=layered/spa/50" \\
      --ebn0 1.0:1.5:0.25 --batch 4096 --min-frame-errors 100 \\
      --out results.json --resume sweep_state.json

  python -m ecc_ldpc_tpu_torch.cli compare a.json b.json
  python -m ecc_ldpc_tpu_torch.cli plot a.json b.json --metric fer
  python -m ecc_ldpc_tpu_torch.cli codes --info nr5g/bg1/384 --threshold \\
      wimax/2304/56

Sweeps run on the card (`--device cuda`, the default) or, with
`--device cpu`, through the plain PyTorch path. Result files are the JAX
package's (PointResult JSON), so either package's compare reads them.

The sharded sweep runs one process per rank on a BATCHxSNR mesh:

  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m ecc_ldpc_tpu_torch.cli sweep --code dvbs2/64800/12 \
      --decoder layered/norm:0.8125/25 --ebn0 1.0,1.1 --batch 4096 --mesh 2x2

(add `--device cpu` for the plain path over gloo on the host). Ranks
beyond the host's cards share a card, by time-slicing. Rank 0 prints the
table and writes --out.
"""
from __future__ import annotations

import argparse
import sys

# subcommands of the JAX package's CLI that the port does not have yet
_WAITING = {
    "findsnr": "ROADMAP.md Queue 1 step 14 (sim/findsnr.py)",
    "trap": "ROADMAP.md Queue 1 step 14 (sim/microscope.py)",
    "bench": "ROADMAP.md Queue 1 step 14 (bench/ ab, pipeline; the port's "
             "benchmark is bench/throughput.py, driven by chip_smoke.py)",
    "learn": "ROADMAP.md Queue 1 step 14 (learn/noms.py)",
}


def parse_ebn0(text) -> tuple:
    """'0:4:0.5' (start:stop:step, inclusive), '1,2,3.5', or a list
    (from --config JSON files)."""
    if isinstance(text, (list, tuple)):
        return tuple(float(x) for x in text)
    if ":" in text:
        parts = [float(x) for x in text.split(":")]
        start, stop = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 1.0
        out, v = [], start
        while v <= stop + 1e-9:
            out.append(round(v, 9))
            v += step
        return tuple(out)
    return tuple(float(x) for x in text.split(","))


def cmd_sweep(args) -> int:
    from ..sim import StoppingRule, SweepSpec, format_table, run_sweep
    from ..sim.report import save_results

    if args.config:
        # JSON config file: keys mirror the CLI flags and take precedence;
        # "code"/"decoder" accept a string or a list.
        import json

        with open(args.config) as f:
            cfg = json.load(f)
        for k, v in cfg.items():
            k = k.replace("-", "_")
            if k in ("code", "decoder") and isinstance(v, str):
                v = [v]
            setattr(args, k, v)
    mesh, joined = None, False
    if args.mesh:
        from ..dist import MeshSpec, make_mesh, maybe_init_distributed
        from ..sim.runner import run_sweep_sharded

        joined = maybe_init_distributed()
        b, s = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(MeshSpec(batch=b, snr=s), device=args.device)
    lead = mesh is None or mesh.rank == 0  # the rank that prints and writes

    def progress(pr):
        if args.verbose and lead:
            print(format_table([pr]).splitlines()[-1], flush=True)

    all_results = []
    for code in args.code:
        for decoder in args.decoder:
            spec = SweepSpec(
                code=code,
                decoder=decoder,
                ebn0_db=parse_ebn0(args.ebn0),
                batch=args.batch,
                seed=args.seed,
                stopping=StoppingRule(
                    min_frame_errors=args.min_frame_errors,
                    max_frames=args.max_frames,
                ),
                backend=args.backend,
                channel=args.channel,
            )
            if mesh is not None:
                all_results += run_sweep_sharded(
                    spec, mesh, resume_path=args.resume, progress=progress)
            else:
                all_results += run_sweep(spec, device=args.device,
                                         resume_path=args.resume,
                                         progress=progress)
    if joined:
        import torch.distributed

        torch.distributed.destroy_process_group()
    if not lead:
        return 0
    print(format_table(all_results))
    if args.out:
        save_results(all_results, args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _load_results(path):
    import json

    from ..sim.runner import PointResult

    with open(path) as f:
        return [PointResult.from_json(d) for d in json.load(f)]


def cmd_compare(args) -> int:
    """BER/FER-curve parity: two result sets match iff their Wilson CIs
    overlap at every shared Eb/N0 point."""
    from ..sim import curves_overlap

    a, b = _load_results(args.results[0]), _load_results(args.results[1])
    rc = 0
    for metric in ("fer", "ber"):
        ok = curves_overlap(a, b, metric=metric)
        print(f"{metric.upper()} curves overlap: {'YES' if ok else 'NO'}")
        rc |= 0 if ok else 1
    return rc


def cmd_plot(args) -> int:
    """ASCII waterfall curves from saved sweep results."""
    from ..sim.report import plot_curves

    results = []
    for path in args.results:
        results += _load_results(path)
    print(plot_curves(results, metric=args.metric))
    return 0


def cmd_codes(args) -> int:
    """List the registered code families, or analyze codes (degree
    profiles, 4-cycle census, QC shape) and print their thresholds."""
    from ..codes import get_code, list_codes

    if args.threshold:
        from ..codes.threshold import bec_threshold, de_threshold_ebn0

        for spec_str in args.threshold:
            spec = get_code(spec_str)
            th = de_threshold_ebn0(spec)
            eps = bec_threshold(spec)
            print(f"{spec_str}: rate {spec.rate:.4f}, "
                  f"BP threshold (GA-DE) {th:+.3f} dB Eb/N0, "
                  f"BEC threshold (exact DE) eps*={eps:.4f} "
                  f"(capacity {1 - spec.rate:.4f})")
        return 0
    if args.info:
        import json

        from ..codes.analyze import analyze, format_info

        for spec_str in args.info:
            info = analyze(get_code(spec_str), cycles=not args.no_cycles)
            print(json.dumps(info) if args.json else format_info(info))
        return 0
    for name in list_codes():
        print(name)
    return 0


def cmd_waiting(args) -> int:
    print(f"{args.cmd}: not ported yet; it waits for "
          f"{_WAITING[args.cmd]}", file=sys.stderr)
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ecc-sim-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sweep", help="Monte-Carlo BER/FER sweep")
    sp.add_argument("--code", action="append", default=None,
                    help="code spec string (repeatable)")
    sp.add_argument("--decoder", action="append", default=None,
                    help="decoder spec string (repeatable)")
    sp.add_argument("--batch", type=int, default=256)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (the plain "
                         "PyTorch path)")
    sp.add_argument("--backend", default=None,
                    help="decoder backend (the JAX package's flag): pallas "
                         "stores a layered decoder's messages as the TPU's "
                         "kernel did (bf16 on dvbs2/64800, f32 elsewhere); "
                         "auto and xla store f32; xla-mm (the TPU's "
                         "incidence-matmul form) raises")
    sp.add_argument("--verbose", "-v", action="store_true")
    sp.add_argument("--ebn0", required=True, help="'0:4:0.5' or '1,2,3'")
    sp.add_argument("--channel", default="bpsk",
                    help="channel spec (chan/modem.py): bpsk, hard, "
                         "rayleigh, bsc:P, bec:EPS, qpsk, 8psk, qam16, "
                         "qam64, qam256, apsk16[:rRATE|:gG], "
                         "apsk32[:rRATE|:gG:gG]; ':il' after a symbol "
                         "channel adds the DVB-S2 bit interleaver (also "
                         "with --mesh)")
    sp.add_argument("--min-frame-errors", type=int, default=100)
    sp.add_argument("--max-frames", type=int, default=1_000_000)
    sp.add_argument("--out", default=None, help="write results JSON here")
    sp.add_argument("--resume", default=None, help="sweep state file")
    sp.add_argument("--config", default=None,
                    help="JSON config file whose keys mirror these flags")
    sp.add_argument("--mesh", default=None,
                    help="sharded sweep over a BATCHxSNR mesh of ranks "
                         "(one process each, under torch.distributed.run)")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser(
        "compare", help="BER/FER-curve parity check between two result files"
    )
    sp.add_argument("results", nargs=2, help="two results JSON files")
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser("plot", help="ASCII waterfall curves from results")
    sp.add_argument("results", nargs="+", help="results JSON files")
    sp.add_argument("--metric", default="fer", choices=("fer", "ber"))
    sp.set_defaults(fn=cmd_plot)

    sp = sub.add_parser(
        "codes", help="list registered code families / inspect a code")
    sp.add_argument("--info", action="append", default=None,
                    help="code spec string to analyze (repeatable): degree "
                         "profiles, 4-cycle census, QC block shape")
    sp.add_argument("--json", action="store_true",
                    help="emit --info reports as JSON lines")
    sp.add_argument("--threshold", action="append", default=None,
                    help="print the asymptotic BP threshold (protograph "
                         "Gaussian-approximation density evolution) of a "
                         "code spec (repeatable)")
    sp.add_argument("--no-cycles", action="store_true",
                    help="skip the 4-cycle census (O(sum col_deg^2))")
    sp.set_defaults(fn=cmd_codes)

    for name, step in _WAITING.items():
        sp = sub.add_parser(name, help=f"not ported yet ({step})")
        sp.set_defaults(fn=cmd_waiting)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    # a subcommand that is not ported yet takes any arguments and says
    # what it waits for
    args, rest = parser.parse_known_args(argv)
    if rest and args.fn is not cmd_waiting:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    # the JAX package's defaults
    if getattr(args, "code", None) is None:
        args.code = ["mackay1008"]
    if getattr(args, "decoder", None) is None:
        args.decoder = ["minsum/norm:0.8125/25"]
    return args.fn(args)
