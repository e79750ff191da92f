"""Column normalisation helpers (the analog of ``arma::normalise``)."""

from __future__ import annotations

import torch


def l2_normalize_columns(X: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalise columns; zero columns stay zero (``arma::normalise(X, 2, 0)``,
    src/harmony.cpp:42,136,220,633)."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return X / torch.where(norms <= eps, torch.ones_like(norms), norms)


def l1_normalize_columns(X: torch.Tensor) -> torch.Tensor:
    """L1-normalise columns (``arma::normalise(X, 1, 0)``,
    src/harmony.cpp:321-323); entries are non-negative, so the plain column
    sum is the norm, and a zero column is left as it is."""
    sums = X.sum(dim=0, keepdim=True)
    return X / torch.where(sums == 0, torch.ones_like(sums), sums)
