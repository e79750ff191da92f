"""Build and load the hand-written CUDA kernels.

At first use each ``csrc/*.cu`` source is compiled by ``nvcc`` into a
shared library with a plain C interface, under ``build/kernels/`` beside
the package, and loaded with ctypes. Each library's file name carries a
hash of its source, so an edited source rebuilds and an unchanged one
loads at once. The sources are compiled in parallel, one ``nvcc`` each.

Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception. Pointers and the
stream are passed as ``c_void_p``: an untyped Python int would be cut to
32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("estep_round", "ridge")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes shorthands for the signatures the wrapper modules declare
PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    all at once. Returns {name: seconds} for those compiled here; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    seconds, failed = {}, []
    for n, out, tmp, t0, p in procs:
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def build_logs(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """The compiler output kept by :func:`build` for each library."""
    out = {}
    for n in names:
        log = library_path(n).with_suffix(".log")
        out[n] = log.read_text() if log.exists() else ""
    return out


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare ``signatures``
    ({function: argtypes}); every entry point returns an int error code."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
