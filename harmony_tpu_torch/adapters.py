"""Ecosystem adapters: the analog of the reference's L6 layer
(``RunHarmony.Seurat`` / ``RunHarmony.SingleCellExperiment``,
R/RunHarmony.R:60-194) for the Python single-cell stack, as
``harmony_tpu/adapters.py`` has them, over the port's ``run_harmony``.

* :func:`run_harmony_anndata`: reads an ``obsm`` embedding (default
  ``X_pca``) and covariates from ``obs``, writes the corrected embedding to
  ``obsm['X_harmony']`` (``reduction.save='harmony'``,
  R/RunHarmony.R:102-111); ``dims_use`` subsetting and validation as the
  reference's (R/RunHarmony.R:77-86).
* :func:`run_harmony_dataframe`: a DataFrame embedding and metadata.

AnnData and pandas are optional: any object with ``obsm``, ``obs`` and
``n_obs`` works. Every keyword (``device`` too) goes to ``run_harmony``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .api import run_harmony
from .config import HarmonyConfigError


def project_dim_loadings(adata, basis: str = "X_harmony") -> np.ndarray:
    """Feature loadings of an ``obsm`` basis, ``X^T · emb`` (n_var, d): the
    AnnData analog of ``Seurat::ProjectDim`` (R/RunHarmony.R:112-119), for
    a dense or scipy-sparse ``adata.X``."""
    emb = np.asarray(adata.obsm[basis])
    X = adata.X
    if X is None:
        raise HarmonyConfigError(
            "project_dim requires adata.X (the feature matrix) to project "
            "loadings; pass project_dim=False"
        )
    return np.asarray(X.T @ emb)


def run_harmony_anndata(
    adata,
    group_by_vars: Sequence[str],
    basis: str = "X_pca",
    adjusted_basis: str = "X_harmony",
    dims_use: Optional[Sequence[int]] = None,
    project_dim: Optional[bool] = None,
    **kwargs,
):
    """Run Harmony on an AnnData object in place; returns the object.

    ``basis`` is ``reduction.use``, ``adjusted_basis`` ``reduction.save``,
    ``group_by_vars`` ``group.by.vars`` and ``project_dim`` ``project.dim``
    (R/RunHarmony.R:60-68): feature loadings go to
    ``varm[adjusted_basis]``, by default where the object has a feature
    matrix ``X`` and a ``varm`` mapping."""
    if basis not in adata.obsm:
        raise HarmonyConfigError(
            f"{basis} cell embeddings not found in AnnData object. Run PCA "
            "(e.g. scanpy.pp.pca) first."
        )
    embedding = np.asarray(adata.obsm[basis])
    dims_avail = range(embedding.shape[1])
    if dims_use is None:
        dims_use = list(dims_avail)
    if not all(d in dims_avail for d in dims_use):
        raise HarmonyConfigError(
            "trying to use more dimensions than computed. Rerun dimension "
            "reduction with more dimensions or use fewer dims"
        )
    if len(dims_use) == 1:
        raise HarmonyConfigError("only specified one dimension in dims_use")
    missing = [v for v in group_by_vars if v not in adata.obs]
    if missing:
        raise HarmonyConfigError(f"covariates missing from adata.obs: {missing}")
    meta = {v: np.asarray(adata.obs[v]) for v in group_by_vars}
    adata.obsm[adjusted_basis] = run_harmony(
        embedding[:, list(dims_use)], meta, list(group_by_vars), **kwargs
    )
    if project_dim is None:
        project_dim = (getattr(adata, "X", None) is not None
                       and getattr(adata, "varm", None) is not None)
    if project_dim:
        adata.varm[adjusted_basis] = project_dim_loadings(adata, adjusted_basis)
    return adata


def run_harmony_dataframe(embedding_df, meta_df, vars_use: Sequence[str], **kwargs):
    """A DataFrame embedding (cells x dims) and a metadata DataFrame in; a
    DataFrame of the corrected embedding (columns ``harmony_1`` ...) out,
    on the embedding's index, where pandas is installed, else an array."""
    values = np.asarray(embedding_df, dtype=np.float64)
    meta = {v: np.asarray(meta_df[v]) for v in vars_use}
    out = run_harmony(values, meta, list(vars_use), **kwargs)
    try:
        import pandas as pd
    except ImportError:
        return out
    if not hasattr(embedding_df, "index"):
        return out
    return pd.DataFrame(out, index=embedding_df.index,
                        columns=[f"harmony_{i + 1}" for i in range(out.shape[1])])
