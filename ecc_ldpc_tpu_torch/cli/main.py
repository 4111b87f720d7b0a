"""Command line of the port (port of ecc_ldpc_tpu/cli/main.py:21-132 and the
sweep, compare and plot subcommands). Usage:

  python -m ecc_ldpc_tpu_torch.cli sweep \\
      --code dvbs2/64800/12 \\
      --decoder "layered/norm:0.8125/50;retry=layered/spa/50" \\
      --ebn0 1.0:1.5:0.25 --batch 4096 --min-frame-errors 100 \\
      --out results.json --resume sweep_state.json

  python -m ecc_ldpc_tpu_torch.cli compare a.json b.json
  python -m ecc_ldpc_tpu_torch.cli plot a.json b.json --metric fer

Sweeps run on the card (`--device cuda`, the default) or, with
`--device cpu`, through the plain PyTorch path. Result files are the JAX
package's (PointResult JSON), so either package's compare reads them.
"""
from __future__ import annotations

import argparse
import sys

# subcommands of the JAX package's CLI that the port does not have yet
_WAITING = {
    "codes": "ROADMAP.md Queue 1 step 15 (other code families, analyze, "
             "threshold)",
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
    if args.mesh:
        raise NotImplementedError(
            "--mesh (the sharded sweep) is not ported yet; it waits for "
            "ROADMAP.md Queue 1 step 13 (dist/)")

    def progress(pr):
        if args.verbose:
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
                channel=args.channel,
            )
            all_results += run_sweep(spec, device=args.device,
                                     resume_path=args.resume,
                                     progress=progress)
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
    sp.add_argument("--verbose", "-v", action="store_true")
    sp.add_argument("--ebn0", required=True, help="'0:4:0.5' or '1,2,3'")
    sp.add_argument("--channel", default="bpsk",
                    help="channel spec (chan/modem.py; the port runs bpsk)")
    sp.add_argument("--min-frame-errors", type=int, default=100)
    sp.add_argument("--max-frames", type=int, default=1_000_000)
    sp.add_argument("--out", default=None, help="write results JSON here")
    sp.add_argument("--resume", default=None, help="sweep state file")
    sp.add_argument("--config", default=None,
                    help="JSON config file whose keys mirror these flags")
    sp.add_argument("--mesh", default=None,
                    help="sharded sweep over a BATCHxSNR mesh (not ported "
                         "yet: ROADMAP.md Queue 1 step 13)")
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
