"""Batch-diversity statistics O and E, and the per-cell penalty gather.

Counterpart of ``harmony_tpu/ops/stats.py``: with the one-hot design held
as integer codes, ``O = R Phi^T`` (src/harmony.cpp:150) is a one-hot
product and a cell's penalty is the sum of its per-covariate columns
(src/harmony.cpp:322).
"""

from __future__ import annotations

from typing import Tuple

import torch


def one_hot_design(codes: torch.Tensor, offsets: Tuple[int, ...], B: int,
                   dtype=torch.float32) -> torch.Tensor:
    """The stacked one-hot Phi (B, N)."""
    off = torch.as_tensor(offsets, dtype=codes.dtype, device=codes.device)
    gcodes = (codes + off[:, None]).long()
    oh = torch.nn.functional.one_hot(gcodes, B).to(dtype)  # (ncov, N, B)
    return oh.sum(dim=0).t()


def compute_O(R: torch.Tensor, codes: torch.Tensor, offsets: Tuple[int, ...],
              B: int) -> torch.Tensor:
    """O[k, b] = sum_n R[k, n] * Phi[b, n] (src/harmony.cpp:150)."""
    Phi_t = one_hot_design(codes, offsets, B, dtype=torch.float32).t()
    return (R.float() @ Phi_t).to(R.dtype)


def compute_E(R: torch.Tensor, Pr_b: torch.Tensor) -> torch.Tensor:
    """E = rowSums(R) * Pr_b^T (src/harmony.cpp:149)."""
    return R.sum(dim=1, keepdim=True) * Pr_b[None, :]


def penalty_for_cells(pen: torch.Tensor, codes: torch.Tensor,
                      offsets: Tuple[int, ...]) -> torch.Tensor:
    """Per-cell penalty: sum over covariates of pen[:, batch_of(cell, c)]."""
    out = None
    for c, off in enumerate(offsets):
        term = pen[:, off:].index_select(1, codes[c].long())
        out = term if out is None else out + term
    return out
