"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source csrc/<name>.cu has a plain C interface (no PyTorch headers),
so nvcc builds it in seconds. The library lands in build/kernels/ beside
the package (git-ignored), named by a hash of its source, the shared
csrc/*.cuh headers and the flags, so an edited source is rebuilt and a
built one is reused. Nothing is built or
loaded when a module is imported.

The three layered sources build twice: <name> is their f32 library and
<name>_prec, built with -DLAYERED_PREC=1, the library of their message
precisions (bf16, the q: grid; csrc/cluster_tile.cuh). Apart, the f32
kernels keep their own code and register allocation, and the libraries
build side by side; layered_exact's precision build, the longest, comes
in two halves (circulant, and _xor), one nvcc each.
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
KERNEL_SOURCES = ("layered_qc", "layered_exact", "layered_classic", "flooding",
                  "flooding_qc", "ring")
# library -> (its source, its own nvcc flags): every source, and the
# precision build of each layered one
LIBRARIES = {name: (name, ()) for name in KERNEL_SOURCES}
LIBRARIES.update({f"{name}_prec": (name, ("-DLAYERED_PREC=1",))
                  for name in KERNEL_SOURCES[:3]})
LIBRARIES["layered_exact_prec"] = ("layered_exact",
                                   ("-DLAYERED_PREC=1", "-DLAYERED_PERM=1"))
LIBRARIES["layered_exact_prec_xor"] = ("layered_exact",
                                       ("-DLAYERED_PREC=1", "-DLAYERED_PERM=2"))


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


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + LIBRARIES[name][1]


def library_path(name: str) -> pathlib.Path:
    # the tag covers the shared headers too, so editing one rebuilds
    src = (CSRC / f"{LIBRARIES[name][0]}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=tuple(LIBRARIES)) -> dict:
    """Build every named library that is not built yet, one nvcc process
    per library, all started together. Returns {name: {"seconds",
    "ptxas"}} (seconds 0.0 and the stored ptxas report for a library
    already built)."""
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
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{LIBRARIES[name][0]}.cu")]
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
