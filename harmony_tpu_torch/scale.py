"""Row standardisation for preprocessing (``scaleData``/``scaleRows_dgc``).

Counterpart of ``harmony_tpu/scale.py``, in NumPy on the host: the
reference scales a sparse genes x cells matrix row-wise to mean 0 and sd 1,
clipped at ``+-thresh``, on the CSC arrays with a zero-aware variance
(R/utils.R:87-98, src/utils.cpp:112-155: denominator ``ncol - 1``, the
zeros contributing ``nz * mean^2``). A ``scipy.sparse`` input takes the
native C++ routine (:mod:`harmony_tpu_torch.native`) where ``g++`` is
found, else the NumPy path; a dense input the NumPy path.
"""

from __future__ import annotations

import numpy as np

from . import native


def scale_data(A, margin: int = 1, thresh: float = 10.0) -> np.ndarray:
    """Standardise rows (margin=1) or columns (margin=2) with clipping.

    Accepts a dense array or a ``scipy.sparse`` matrix; returns a dense
    float64 array, as the reference does."""
    if margin not in (1, 2):
        raise ValueError("margin must be 1 (rows) or 2 (columns)")
    try:
        import scipy.sparse as sp

        is_sparse = sp.issparse(A)
    except ImportError:
        is_sparse = False
    if is_sparse:
        M = A.tocsc() if margin == 1 else A.T.tocsc()
        res = _scale_rows_csc(M, thresh)
    else:
        M = np.asarray(A, dtype=np.float64)
        res = _scale_rows_dense(M if margin == 1 else M.T, thresh)
    return res if margin == 1 else res.T


def _scale_rows_dense(M: np.ndarray, thresh: float) -> np.ndarray:
    ncol = M.shape[1]
    mean = M.mean(axis=1, keepdims=True)
    # sample sd with the ncol - 1 denominator (src/utils.cpp:147)
    sd = np.sqrt(((M - mean) ** 2).sum(axis=1, keepdims=True) / (ncol - 1))
    sd = np.where(sd == 0, 1.0, sd)
    return np.clip((M - mean) / sd, -thresh, thresh)


def _scale_rows_csc(M, thresh: float) -> np.ndarray:
    """``scaleRows_dgc``: the native routine, or :func:`scale_rows_csc_numpy`."""
    nrow, ncol = M.shape
    res = native.csc_scale_rows(M.data, M.indices, M.indptr, nrow, ncol, thresh)
    if res is not None:
        return res
    return scale_rows_csc_numpy(M.data, M.indices, M.indptr, nrow, ncol, thresh)


def scale_rows_csc_numpy(x, i, p, nrow: int, ncol: int, thresh: float) -> np.ndarray:
    """The NumPy path of ``scaleRows_dgc`` on CSC arrays (values ``x``, row
    ids ``i``, column pointers ``p``)."""
    x = np.asarray(x, dtype=np.float64)
    i = np.asarray(i)
    mean = np.zeros(nrow)
    np.add.at(mean, i, x)
    mean /= ncol
    # zero-aware sum of squared deviations (src/utils.cpp:132-145)
    sd = np.zeros(nrow)
    np.add.at(sd, i, (x - mean[i]) ** 2)
    nz = np.full(nrow, ncol, dtype=np.int64)
    np.subtract.at(nz, i, 1)
    sd += nz * mean ** 2
    sd = np.sqrt(sd / (ncol - 1))
    sd = np.where(sd == 0, 1.0, sd)
    res = np.zeros((nrow, ncol))
    cols = np.repeat(np.arange(ncol), np.diff(np.asarray(p)))
    np.add.at(res, (i, cols), x)
    res = (res - mean[:, None]) / sd[:, None]
    return np.clip(res, -thresh, thresh)
