"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source csrc/<name>.cu has a plain C interface (no PyTorch headers),
so nvcc builds it in seconds. The library lands in build/kernels/ beside
the package (git-ignored), named by a hash of its source, the shared
csrc/*.cuh headers and the flags, so an edited source is rebuilt and a
built one is reused. Nothing is built or
loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("layered_qc", "layered_exact", "flooding", "flooding_qc")


def nvcc_path() -> str:
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from source")
    return found


def library_path(name: str) -> pathlib.Path:
    # the tag covers the shared headers too, so editing one rebuilds
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=KERNEL_SOURCES) -> dict:
    """Build every named source that is not built yet, one nvcc process per
    source, all started together. Returns {name: {"seconds", "ptxas"}}
    (seconds 0.0 and the stored ptxas report for a library already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = {"seconds": 0.0,
                         "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": report}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built now if missing)."""
    lib = library_path(name)
    if not lib.exists():
        build_all((name,))
    return ctypes.CDLL(str(lib))
