"""Command line of the port (port of ecc_ldpc_tpu/cli/main.py: every
subcommand, sweep, compare, plot, codes, findsnr, trap, bench and learn).
Usage:

  python -m ecc_ldpc_tpu_torch.cli sweep \\
      --code dvbs2/64800/12 \\
      --decoder "layered/norm:0.8125/50;retry=layered/spa/50" \\
      --ebn0 1.0:1.5:0.25 --batch 4096 --min-frame-errors 100 \\
      --out results.json --resume sweep_state.json

  python -m ecc_ldpc_tpu_torch.cli compare a.json b.json
  python -m ecc_ldpc_tpu_torch.cli plot a.json b.json --metric fer
  python -m ecc_ldpc_tpu_torch.cli codes --info nr5g/bg1/384 --threshold \\
      wimax/2304/56

  python -m ecc_ldpc_tpu_torch.cli findsnr --code dvbs2/64800/12 \\
      --decoder layered/norm:0.8125/25 --target-fer 1e-2 --bracket 0.9:1.4 \\
      --tol-db 0.02 --batch 2048 --max-frames 16384 -v
  python -m ecc_ldpc_tpu_torch.cli trap --code mackay1008 --ebn0 2.0 \\
      --frames 8192 --out trap.json
  python -m ecc_ldpc_tpu_torch.cli learn --code dvbs2/64800/12 \\
      --ebn0 1.8:2.6 --iters 25 --steps 55 --batch 16 --out sched.json
  python -m ecc_ldpc_tpu_torch.cli bench --code dvbs2/64800/12 \\
      --decoder layered/norm:0.8125/25/noet --batch 4096 [--pipeline | --ab]

Every subcommand with --code runs on the card (`--device cuda`, the
default) or, with `--device cpu`, through the plain PyTorch path; `bench`
times the card and refuses the CPU. `--profile-dir DIR` writes a
torch.profiler Chrome trace of the run into DIR (bench/profile.trace).
Result and schedule files are the JAX package's, so either package reads
them.

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

# the Eb/N0 of `bench`'s decode-only run: the JAX package's run_benchmark
# default, which its bench subcommand uses
BENCH_EBN0_DB = 2.5


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
    from ..bench.profile import trace
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
    with trace(args.profile_dir):
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
                        spec, mesh, resume_path=args.resume,
                        progress=progress)
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


def cmd_findsnr(args) -> int:
    """Inverse sweep: bisect the Eb/N0 hitting a target FER. Coding gain
    between two configs = the difference of their answers."""
    import json

    from ..bench.profile import trace
    from ..sim.findsnr import find_operating_point

    lo, hi = (float(x) for x in args.bracket.split(":")[:2])
    with trace(args.profile_dir):
        for code in args.code:
            for decoder in args.decoder:
                op = find_operating_point(
                    code, decoder, target_fer=args.target_fer,
                    bracket=(lo, hi), tol_db=args.tol_db, batch=args.batch,
                    max_frames_per_probe=args.max_frames,
                    channel=args.channel, backend=args.backend,
                    seed=args.seed, device=args.device,
                    progress=(lambda e, f, ci, n: print(
                        f"  probe {e:+.3f} dB: FER {f:.3e} "
                        f"[{ci[0]:.1e},{ci[1]:.1e}] over {n} frames",
                        flush=True)) if args.verbose else None,
                )
                print(json.dumps(op.json_dict()))
    return 0


def cmd_learn(args) -> int:
    """Train a per-iteration min-sum schedule (learn/noms.py) and write a
    schedule JSON loadable with learn.load_schedule(path) (in either
    package) or usable as make_decoder(alpha=..., beta=...)."""
    import json
    import time

    from ..bench.profile import trace
    from ..learn import train_noms

    if args.alpha_only and args.beta_only:
        raise SystemExit(
            "--alpha-only and --beta-only together freeze every parameter "
            "— nothing to train"
        )
    code = args.code[0]
    # --ebn0 here is a TRAINING BAND, not a sweep grid: 'lo:hi' is the
    # band's endpoints (parse_ebn0's 1-dB default step would collapse
    # '1.8:2.6' to a single point), and a comma list contributes its
    # min/max.
    if ":" in args.ebn0:
        ebn0 = [float(x) for x in args.ebn0.split(":")[:2]]
    else:
        ebn0 = parse_ebn0(args.ebn0)
    band = (min(ebn0), max(ebn0))
    last = [time.perf_counter()]

    def progress(step, loss):
        # the step's seconds: its loss came back to the host at its end
        now = time.perf_counter()
        print(f"  step {step}: loss {loss:.4f}, {now - last[0]:.3f} s",
              flush=True)
        last[0] = now

    with trace(args.profile_dir):
        params, losses = train_noms(
            code, iters=args.iters, steps=args.steps, batch=args.batch,
            seed=args.seed, ebn0_range=band, init_alpha=args.init_alpha,
            lr=args.lr, learn_alpha=not args.beta_only,
            learn_beta=not args.alpha_only, device=args.device,
            progress=progress if args.verbose else None,
        )
    out = {
        "code": code,
        "decoder": "layered min-sum",
        "iters": args.iters,
        "alphas": [round(float(a), 6) for a in params.alphas],
        "betas": [round(float(b), 6) for b in params.betas],
        "trained": {
            "objective": "multi-iteration soft-BER (learn/noms.py)",
            "init_alpha": args.init_alpha, "steps": args.steps,
            "batch": args.batch, "lr": args.lr, "seed": args.seed,
            "ebn0_range_db": list(band),
        },
        "caveats": "code-specific; beta-bearing schedules are "
                   "SNR-band-specific - use within ebn0_range_db",
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"loss {losses[:3].mean():.4f} -> {losses[-5:].mean():.4f}; "
          f"wrote {args.out}")
    print(f"use: decode.make_decoder(graph, 'layered', "
          f"alpha=learn.load_schedule({args.out!r}).alphas, "
          f"beta=..., max_iters={args.iters})")
    return 0


def cmd_trap(args) -> int:
    """Harvest and classify decoder failures as (a, b) trapping sets."""
    from ..bench.profile import trace
    from ..sim.microscope import harvest

    with trace(args.profile_dir):
        rep = harvest(args.code[0], args.decoder[0], ebn0_db=args.ebn0,
                      frames=args.frames, batch=args.batch, seed=args.seed,
                      channel=args.channel, backend=args.backend,
                      device=args.device)
    print(rep.summary())
    if args.out:
        import json

        with open(args.out, "w") as f:
            json.dump(rep.to_json(), f, indent=1)
        print(f"report -> {args.out}")
    return 0


def cmd_bench(args) -> int:
    """Decoded throughput on the card: decode only (bench/throughput.py),
    --pipeline (bench/pipeline.py) or --ab over the --code x --decoder
    grid (bench/ab.py)."""
    from ..bench.profile import trace

    code, decoder = args.code[0], args.decoder[0]
    if args.ab:
        from ..bench.ab import ab_compare

        arms = [(c, d) for c in args.code for d in args.decoder]
        if len(arms) < 2:
            raise SystemExit("--ab needs >=2 (code, decoder) combos — "
                             "repeat --code and/or --decoder")
        with trace(args.profile_dir):
            res = ab_compare(arms, batch=args.batch, device=args.device)
        print(res.json_line())
        return 0
    if args.pipeline:
        from ..bench.pipeline import run_pipeline_benchmark

        with trace(args.profile_dir):
            res = run_pipeline_benchmark(code=code, decoder=decoder,
                                         batch=args.batch, device=args.device)
        print(res.json_line())
        return 0
    from ..bench.throughput import run_benchmark

    print(run_benchmark(code=code, decoder=decoder, batch=args.batch,
                        ebn0_db=BENCH_EBN0_DB, device=args.device,
                        profile_dir=args.profile_dir).json_line())
    return 0


def _common(sp) -> None:
    """The flags every simulating subcommand shares (the JAX CLI's
    common(), plus --device)."""
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
                         "rounds as the TPU's kernels did (bf16 storage of "
                         "the layered kernel on dvbs2/64800 and of the QC "
                         "flooding kernel where its f32 state did not fit, "
                         "bf16 matmul inputs of flooding min-sum on "
                         "unstructured codes, bf16 permutations on xor "
                         "codes; f32 elsewhere) and picks the graph view as "
                         "the JAX package does; auto and xla keep f32; "
                         "xla-mm decodes flooding minsum or spa on the "
                         "expanded graph in f32")
    sp.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace here")
    sp.add_argument("--verbose", "-v", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ecc-sim-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sweep", help="Monte-Carlo BER/FER sweep")
    _common(sp)
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

    sp = sub.add_parser(
        "findsnr", help="find the Eb/N0 hitting a target FER (inverse sweep)")
    _common(sp)
    sp.add_argument("--target-fer", type=float, default=1e-2)
    sp.add_argument("--bracket", default="0:6",
                    help="'lo:hi' Eb/N0 search bracket in dB")
    sp.add_argument("--tol-db", type=float, default=0.05)
    sp.add_argument("--max-frames", type=int, default=65536,
                    help="frame budget per probe point")
    sp.add_argument("--channel", default="bpsk",
                    help="channel spec (chan/modem.py)")
    sp.set_defaults(fn=cmd_findsnr)

    sp = sub.add_parser(
        "trap", help="harvest + classify decoder failures as (a,b) "
                     "trapping sets (error-floor microscopy)")
    _common(sp)
    sp.add_argument("--ebn0", type=float, required=True)
    sp.add_argument("--frames", type=int, default=1 << 14)
    sp.add_argument("--channel", default="bpsk")
    sp.add_argument("--out", default=None, help="write report JSON here")
    sp.set_defaults(fn=cmd_trap)

    sp = sub.add_parser("bench", help="decoded-throughput benchmark (the card)")
    _common(sp)
    sp.add_argument("--pipeline", action="store_true",
                    help="measure encoder + full encode->channel->decode "
                         "throughput instead of decode-only")
    sp.add_argument("--ab", action="store_true",
                    help="interleaved A/B comparison over the --code x "
                         "--decoder grid (the only drift-safe way to "
                         "compare two configs)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser(
        "learn", help="train a per-iteration min-sum schedule (NOMS)")
    _common(sp)
    sp.add_argument("--ebn0", required=True,
                    help="training SNR band, e.g. '1.8:2.6' or '2.0,2.4'")
    sp.add_argument("--iters", type=int, default=25)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--init-alpha", type=float, default=0.8125)
    sp.add_argument("--alpha-only", action="store_true",
                    help="freeze betas at 0 (scale-invariant schedule)")
    sp.add_argument("--beta-only", action="store_true",
                    help="freeze alphas at init")
    sp.add_argument("--out", required=True, help="schedule JSON path")
    sp.set_defaults(fn=cmd_learn)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the JAX package's defaults
    if getattr(args, "code", None) is None:
        args.code = ["mackay1008"]
    if getattr(args, "decoder", None) is None:
        args.decoder = ["minsum/norm:0.8125/25"]
    return args.fn(args)
