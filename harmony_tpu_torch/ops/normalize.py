"""Column normalisation helpers (the analog of ``arma::normalise``)."""

from __future__ import annotations

import torch


def l2_normalize_columns(X: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """L2-normalise columns; zero columns stay zero (``arma::normalise(X, 2, 0)``,
    src/harmony.cpp:42,136,220,633). A 2-byte X takes the sequence XLA
    compiles ``jnp.linalg.norm`` of such an array into: bf16's squares in
    float32, float16's squared in float16; summed in float32, the sum
    rounded to X's dtype, its square root rounded, the quotient."""
    if X.dtype == torch.bfloat16:
        Xf = X.float()
        norms = torch.sqrt((Xf * Xf).sum(dim=0, keepdim=True).to(X.dtype))
    elif X.dtype == torch.float16:
        norms = torch.sqrt((X * X).float().sum(dim=0, keepdim=True).to(X.dtype))
    else:
        norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return X / torch.where(norms <= eps, torch.ones_like(norms), norms)


def l1_normalize_columns(X: torch.Tensor) -> torch.Tensor:
    """L1-normalise columns (``arma::normalise(X, 1, 0)``,
    src/harmony.cpp:321-323); entries are non-negative, so the plain column
    sum is the norm, and a zero column is left as it is."""
    sums = X.sum(dim=0, keepdim=True)
    return X / torch.where(sums == 0, torch.ones_like(sums), sums)
