"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source csrc/<name>.cu has a plain C interface (no PyTorch headers),
so nvcc builds it in seconds. The library lands in build/kernels/ beside
the package (git-ignored), named by a hash of its source, the shared
csrc/*.cuh headers and the flags, so an edited source is rebuilt and a
built one is reused. Nothing is built or
loaded when a module is imported.

The three layered sources and the two flooding ones build twice: <name>
is their f32 library and <name>_prec, built with -DLAYERED_PREC=1, the
library of their precisions (bf16 storage, the q: grid, the TPU's bf16
permutations and bf16 matmul inputs; csrc/cluster_tile.cuh,
csrc/flooding_qc.cu, csrc/flooding.cu). Apart, the f32 kernels keep their
own code and register allocation, and the libraries build side by side;
the precision builds of layered_exact and layered_classic, the longest,
come in two halves (circulant, and _xor), one nvcc each. The experiments'
ablate_layered source builds its dynamic instances once and each static
sweep (-DABLATE_STATIC_FLAGS) as a library of its own, so the unrolled
sweeps build side by side.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
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
                  "flooding_qc", "ring", "micro_ops", "ablate_layered",
                  "dcmajor")
# library -> (its source, its own nvcc flags): every source, and the
# precision build of each layered one
LIBRARIES = {name: (name, ()) for name in KERNEL_SOURCES}
LIBRARIES.update({f"{name}_prec": (name, ("-DLAYERED_PREC=1",))
                  for name in KERNEL_SOURCES[:5]})
LIBRARIES["layered_exact_prec"] = ("layered_exact",
                                   ("-DLAYERED_PREC=1", "-DLAYERED_PERM=1"))
LIBRARIES["layered_exact_prec_xor"] = ("layered_exact",
                                       ("-DLAYERED_PREC=1", "-DLAYERED_PERM=2"))
LIBRARIES["layered_classic_prec"] = ("layered_classic",
                                     ("-DLAYERED_PREC=1", "-DLAYERED_PERM=1"))
LIBRARIES["layered_classic_prec_xor"] = ("layered_classic",
                                         ("-DLAYERED_PREC=1",
                                          "-DLAYERED_PERM=2"))
# the experiments' static sweeps (E2's seven variants and E3), one library
# an instance, named by its flag set: the kernel's template parameter,
# whose bits experiments/variants.py names
ABLATE_STATIC_FLAGS = (47, 46, 45, 43, 39, 15, 0, 63)
LIBRARIES.update({f"ablate_static_{fl}": ("ablate_layered",
                                          (f"-DABLATE_STATIC_FLAGS={fl}",))
                  for fl in ABLATE_STATIC_FLAGS})


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


def cuobjdump_path() -> str:
    """The CUDA toolkit's cuobjdump, beside nvcc."""
    return str(pathlib.Path(nvcc_path()).with_name("cuobjdump"))


_SASS_FUNCTION = re.compile(r"\s*Function : (\S+)")
_SASS_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]+);")


def sass_counts(name: str) -> dict:
    """{kernel function: SASS instructions} of a built library, from
    `cuobjdump -sass`, the NOPs that pad each function left out."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        m = _SASS_FUNCTION.match(ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
            continue
        m = _SASS_INSTRUCTION.match(ln)
        if fn and m and "NOP" not in m.group(1).split():
            counts[fn] += 1
    return counts


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
    "ptxas"}}: the seconds until its nvcc ended (0.0 for a library already
    built) and its ptxas report (the stored one for a library already
    built)."""
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
        report = lib.with_name(f"{lib.name}.{os.getpid()}.log.tmp")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{LIBRARIES[name][0]}.cu")]
        with open(report, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, lib, report)
    failed = []
    while procs:
        for name in [n for n, v in procs.items() if v[0].poll() is not None]:
            proc, tmp, lib, report = procs.pop(name)
            seconds = time.perf_counter() - t0
            text = report.read_text()
            report.unlink()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
                continue
            lib.with_suffix(".log").write_text(text)
            os.replace(tmp, lib)
            out[name] = {"seconds": seconds, "ptxas": text}
        time.sleep(0.05)
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
