"""Bundled reference datasets, as ``harmony_tpu/datasets.py`` loads them:
``cell_lines`` and ``cell_lines_small`` (metadata and 20 scaled PCs), and
``pbmc_ctrl``/``pbmc_stim`` (gene-count sparse matrices, Kang et al. 2017,
from the Seurat vignette), with ``pbmc_dataset`` reproducing the vignette's
preprocessing in NumPy.

The files are searched in the JAX package's directories and order: the
``path=`` argument alone where it is given, else the directory in
``HARMONY_TPU_DATA``, then the vendored ``harmony_tpu/data/`` of this
checkout (read by path; nothing of the JAX package is imported), then
:data:`REFERENCE_DATA`, the reference R package's ``data/``. For each
dataset the vendored ``.npz`` is read first, then the reference's
``.rda``/``.RData`` (through the port's own NumPy reader,
:mod:`harmony_tpu_torch.rdata`), and only where neither is found do the
cell lines fall back to a deterministic synthetic set with the same
schema, and ``pbmc_stim`` raise ``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from .rdata import RFactor, SparseMatrix, load_rdata

VENDORED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "harmony_tpu", "data")
# the JAX package's third directory (harmony_tpu/datasets.py:23-27)
REFERENCE_DATA = "/root/reference/data"


@dataclasses.dataclass
class CellDataset:
    """Embedding and metadata, the shape ``run_harmony`` consumes."""

    scaled_pcs: np.ndarray  # (N, d) float64
    meta_data: Dict[str, np.ndarray]
    name: str

    @property
    def n_cells(self) -> int:
        return self.scaled_pcs.shape[0]


def _search_dirs(path: Optional[str]) -> List[str]:
    if path:
        return [path]
    return [p for p in (os.environ.get("HARMONY_TPU_DATA", ""), VENDORED, REFERENCE_DATA) if p]


def _find(fname: str, path: Optional[str]) -> Optional[str]:
    for base in _search_dirs(path):
        full = os.path.join(base, fname)
        if os.path.exists(full):
            return full
    return None


def _df_to_meta(df: Dict) -> Dict[str, np.ndarray]:
    """A data.frame's columns as arrays, factors as their level strings."""
    return {k: v.as_strings() if isinstance(v, RFactor) else np.asarray(v)
            for k, v in df.items()}


def _df_to_matrix(df: Dict) -> np.ndarray:
    """A numeric data.frame as an (rows, columns) float64 matrix."""
    return np.stack([np.asarray(v, dtype=np.float64) for v in df.values()], axis=1)


def _load_cell_lines(fname: str, key: str, path: Optional[str]) -> CellDataset:
    npz = _find(f"{key}.npz", path)
    if npz is not None:
        with np.load(npz, allow_pickle=False) as z:
            meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
            return CellDataset(scaled_pcs=z["scaled_pcs"], meta_data=meta, name=key)
    full = _find(fname, path)
    if full is None:
        return _synthetic_cell_lines(key)
    obj = load_rdata(full)[key]
    return CellDataset(scaled_pcs=_df_to_matrix(obj["scaled_pcs"]),
                       meta_data=_df_to_meta(obj["meta_data"]), name=key)


def cell_lines(path: Optional[str] = None) -> CellDataset:
    """Cell-line mixture (10x), 20 scaled PCs, covariates dataset/cell_type."""
    return _load_cell_lines("cell_lines.rda", "cell_lines", path)


def cell_lines_small(path: Optional[str] = None) -> CellDataset:
    """300-cell subset of cell_lines."""
    return _load_cell_lines("cell_lines_small.RData", "cell_lines_small", path)


def pbmc_stim(path: Optional[str] = None):
    """(pbmc_ctrl, pbmc_stim) gene-count CSC matrices (genes x cells), as
    :class:`SparseMatrix`: the two vendored ``.npz`` files, else the
    reference's ``pbmc_stim.RData``."""
    out = []
    for key in ("pbmc_ctrl", "pbmc_stim"):
        npz = _find(f"{key}.npz", path)
        if npz is None:
            continue
        with np.load(npz, allow_pickle=False) as z:
            out.append(SparseMatrix(
                data=z["data"], indices=z["indices"], indptr=z["indptr"],
                shape=tuple(z["shape"]),
                dimnames=[z["genes"] if "genes" in z.files else None,
                          z["cells"] if "cells" in z.files else None],
            ))
    if len(out) == 2:
        return tuple(out)
    full = _find("pbmc_stim.RData", path)
    if full is None:
        raise FileNotFoundError(
            "pbmc data not found: neither pbmc_ctrl.npz and pbmc_stim.npz nor "
            f"pbmc_stim.RData in {_search_dirs(path)}; set HARMONY_TPU_DATA")
    d = load_rdata(full)
    return d["pbmc.ctrl"], d["pbmc.stim"]


def pbmc_dataset(n_pcs: int = 20, path: Optional[str] = None) -> CellDataset:
    """Stimulated-vs-control PBMC integration input, the Seurat vignette's
    preprocessing in NumPy: concatenate ctrl and stim counts, library-size
    log-normalise, keep the 1,000 most variable genes, scale them
    (scaleData, src/utils.cpp:112-155), PCA to ``n_pcs``."""
    from .scale import scale_data

    ctrl, stim = pbmc_stim(path)
    counts = np.concatenate([ctrl.toarray(), stim.toarray()], axis=1)
    cond = np.array(["ctrl"] * ctrl.shape[1] + ["stim"] * stim.shape[1])
    libsize = counts.sum(axis=0, keepdims=True)
    norm = np.log1p(counts / np.where(libsize == 0, 1, libsize) * 1e4)
    top = np.argsort(norm.var(axis=1))[::-1][:1000]
    scaled = scale_data(norm[top], margin=1, thresh=10.0)
    Xc = scaled - scaled.mean(axis=1, keepdims=True)
    _, S, Vt = np.linalg.svd(Xc, full_matrices=False)
    pcs = Vt[:n_pcs].T * S[:n_pcs]  # (N, n_pcs)
    # unit-variance PCs, as the quickstart's scaled_pcs
    pcs = pcs / pcs.std(axis=0, keepdims=True) / np.sqrt(pcs.shape[0])
    return CellDataset(scaled_pcs=pcs, meta_data={"stim": cond}, name="pbmc_stim")


def _synthetic_cell_lines(name: str) -> CellDataset:
    """Schema-compatible synthetic fallback (deterministic)."""
    n = 300 if name == "cell_lines_small" else 2370
    rng = np.random.default_rng(0)
    types = rng.integers(0, 3, n)
    datasets = rng.integers(0, 2, n)
    d = 20
    Z = (
        (rng.normal(size=(3, d)) * 3.0)[types]
        + (rng.normal(size=(2, d)) * 1.5)[datasets]
        + rng.normal(size=(n, d)) * 0.5
    ) / 50.0
    return CellDataset(
        scaled_pcs=Z,
        meta_data={"dataset": np.array([f"d{x}" for x in datasets]),
                   "cell_type": np.array([f"t{x}" for x in types])},
        name=name + "_synthetic",
    )
