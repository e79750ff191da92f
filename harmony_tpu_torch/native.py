"""Loader for the native host-side kernels (``native/scale_csc.cpp``).

Counterpart of ``harmony_tpu/native.py``, binding the same three
functions with the same signatures and return values: the row
standardisation of a CSC genes x cells matrix (``csc_scale_rows``, behind
:func:`harmony_tpu_torch.scale.scale_data`), its row means and standard
deviations (``csc_row_stats``) and the library-size log normalisation of
its counts (``csc_log_normalize``).
The repo's C++ source is built with ``g++`` at first use into
``build/native/`` beside the package (the library's name carries a hash of
the source, so an edited source rebuilds), and bound with ctypes under a
lock. This is a host helper, not a device kernel; where no ``g++`` is
found each function returns None (:mod:`harmony_tpu_torch.scale` then
takes its NumPy path), as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "scale_csc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"

_LIB = None  # the loaded library, False once a build failed
_LIB_LOCK = threading.Lock()
_F64P = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "csc_scale_rows": [_F64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                       _F64P],
    "csc_row_stats": [_F64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _F64P, _F64P],
    "csc_log_normalize": [_F64P, _I64P, ctypes.c_int64, ctypes.c_double],
}


def _build() -> Path:
    """Compile the source into ``build/native/`` unless its hash is built.
    Each process writes a file of its own and renames it into place."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libharmony_native_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o",
                        str(tmp)], check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; None where ``g++`` or the
    source is missing. A failed build raises."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            if shutil.which("g++") is None or not SRC.exists():
                _LIB = False
            else:
                lib = ctypes.CDLL(str(_build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = None
                _LIB = lib
        return _LIB or None


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _csc(data, indices, indptr):
    """Contiguous float64 values and int64 indices; the caller keeps them
    alive while native code reads them."""
    return (np.ascontiguousarray(data, dtype=np.float64),
            np.ascontiguousarray(indices, dtype=np.int64),
            np.ascontiguousarray(indptr, dtype=np.int64))


def _check(x, i, p, nrow, ncol):
    if p.shape != (ncol + 1,) or x.shape != i.shape or p[-1] != x.size:
        raise ValueError("malformed CSC arrays")
    if x.size and (i.min() < 0 or i.max() >= nrow):
        raise ValueError("CSC row index out of range")


def csc_scale_rows(data, indices, indptr, nrow: int, ncol: int,
                   thresh: float) -> Optional[np.ndarray]:
    """Native scaleRows_dgc (src/utils.cpp:112-155): (nrow, ncol) float64,
    rows to mean 0 and sd 1 (zero-aware, ncol - 1 denominator), clipped at
    +-thresh. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x, i, p = _csc(data, indices, indptr)
    _check(x, i, p, nrow, ncol)
    res = np.empty((nrow, ncol), dtype=np.float64)
    lib.csc_scale_rows(_ptr(x, ctypes.c_double), _ptr(i, ctypes.c_int64),
                       _ptr(p, ctypes.c_int64), nrow, ncol, float(thresh),
                       _ptr(res, ctypes.c_double))
    return res


def csc_row_stats(data, indices, indptr, nrow: int, ncol: int):
    """Row means and zero-aware sample standard deviations (ncol - 1
    denominator, src/utils.cpp:132-147) of a CSC matrix: (mean, sd), each
    (nrow,) float64; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x, i, p = _csc(data, indices, indptr)
    _check(x, i, p, nrow, ncol)
    mean = np.empty(nrow, dtype=np.float64)
    sd = np.empty(nrow, dtype=np.float64)
    lib.csc_row_stats(_ptr(x, ctypes.c_double), _ptr(i, ctypes.c_int64),
                      _ptr(p, ctypes.c_int64), nrow, ncol, _ptr(mean, ctypes.c_double),
                      _ptr(sd, ctypes.c_double))
    return mean, sd


def csc_log_normalize(data, indptr, ncol: int, scale: float = 1e4) -> Optional[np.ndarray]:
    """Library-size log1p normalisation of CSC counts, x <- log1p(x /
    colsum * scale) (a zero column sum taken as 1), in place: returns
    ``data`` itself where it is a contiguous float64 array, else the
    normalised copy; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(data, dtype=np.float64)
    p = np.ascontiguousarray(indptr, dtype=np.int64)
    if p.shape != (ncol + 1,) or p[-1] != x.size:
        raise ValueError("malformed CSC arrays")
    lib.csc_log_normalize(_ptr(x, ctypes.c_double), _ptr(p, ctypes.c_int64), ncol,
                          float(scale))
    return x
