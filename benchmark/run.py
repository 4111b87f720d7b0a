"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device, with --trace 1
breakdown, and last checks (each compared number beside its limit, also
the last lines of standard error). It exits non-zero and prints no result
without CUDA or with fewer cards than the cell asks for, when a module of
JAX or of the JAX package is loaded once the window has closed, or when the
port is missing from the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cache_dirs() -> None:
    """Keep every build and kernel cache at fixed paths in the checkout
    (the port builds its kernels into build/kernels there itself)."""
    cache = ROOT / "build" / "cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    # import the benchmark as a package from the checkout's root, not its
    # modules from the script's own directory
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if pathlib.Path(p or ".").resolve()
                                 != ROOT / "benchmark"]
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
