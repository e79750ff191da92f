"""The Harmony objective (``compute_objective``, src/harmony.cpp:158-170).

    J = [ sum(R . dist) + sum(sigma_k R log R)
        + sum((R . sigma_k) * ((theta_b log((O+E+1)/(2E+1))) Phi)) ] * 2000/N

The three terms are returned separately, as the reference traces each.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import HarmonyConfig
from .stats import penalty_for_cells


def xlogx(R: torch.Tensor) -> torch.Tensor:
    """x log x with 0 -> 0 (``safe_entropy``/``trunc_log``, src/utils.cpp:77-81)."""
    return torch.where(R > 0, R * torch.log(R), torch.zeros_like(R))


def compute_objective(
    cfg: HarmonyConfig,
    R: torch.Tensor,
    dist: torch.Tensor,
    O: torch.Tensor,
    E: torch.Tensor,
    codes: torch.Tensor,
    sigma: torch.Tensor,
    theta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (total, dist_term, entropy_term, cross_term), each * 2000/N."""
    nc = cfg.norm_const
    Rf = R.float()
    kmeans_error = (Rf * dist.float()).sum()
    entropy = (sigma.float()[:, None] * xlogx(Rf)).sum()
    Of, Ef = O.float(), E.float()
    pen_log = theta.float()[None, :] * torch.log((Of + Ef + 1.0) / (2.0 * Ef + 1.0))
    pen_cells = penalty_for_cells(pen_log, codes, cfg.covariate_offsets)
    cross = (Rf * sigma.float()[:, None] * pen_cells).sum()
    return (
        (kmeans_error + entropy + cross) * nc,
        kmeans_error * nc,
        entropy * nc,
        cross * nc,
    )
