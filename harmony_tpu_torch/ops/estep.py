"""The E-step round in plain PyTorch: the twin of the K1 kernel.

Counterpart of ``harmony_tpu/ops/estep.py`` (``update_R``,
src/harmony.cpp:269-342). Cells are visited in a permutation, in
``ceil(1/block_size)`` blocks; each block first removes its old
contribution from the global O/E, then recomputes its assignments

    R_blk = L1norm( exp(-dist_blk / sigma) ) * ((2E+1)/(O+E+1))^theta [cell]
    R_blk = L1norm(R_blk)

and adds them back. As in the JAX function: one gather into a
(n_blocks, S) block layout with a sentinel zero column for the pad
slots, dist recomputed from (Y, Z) per block instead of stored, the
k-means error and entropy accumulated inside the round, and one
inverse-map scatter back to natural order. The op order and zero guards
are those of the JAX function, which the parity fixtures pin.

``ops/cuda_estep.py`` holds the CUDA kernel that replaces this loop on
the card; this function is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import HarmonyConfig
from .assign import make_blocks
from .normalize import l1_normalize_columns
from .objective import xlogx


class RoundResult(NamedTuple):
    R: torch.Tensor
    E: torch.Tensor
    O: torch.Tensor
    kmeans_error: torch.Tensor  # sum R . dist over the round's final R
    entropy: torch.Tensor  # sum sigma_k R log R


def _pad1(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([X, X.new_zeros((*X.shape[:-1], 1))], dim=-1)


def block_update_round(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, N) L2-normalised corrected embedding
    Y: torch.Tensor,  # (d, K) L2-normalised centroids
    R: torch.Tensor,  # (K, N)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    codes: torch.Tensor,  # (ncov, N)
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    perm: torch.Tensor,  # (N,) cell permutation
) -> RoundResult:
    """One full update_R round in block layout, objective terms included."""
    K, N = R.shape
    nb, S = cfg.n_blocks, cfg.max_block_size
    dtype = R.dtype
    f32 = torch.float32

    idx, mask = make_blocks(cfg, perm.to(Z.device))  # (nb, S); sentinel N
    mf = mask.to(dtype)
    R_blk = _pad1(R)[:, idx]  # (K, nb, S)
    Z_blk = _pad1(Z)[:, idx]  # (d, nb, S)
    c_blk = _pad1(codes)[:, idx].long()  # (ncov, nb, S)

    b_ids = torch.arange(cfg.B, device=Z.device)
    oh = torch.zeros((nb, S, cfg.B), dtype=dtype, device=Z.device)
    for c, off in enumerate(cfg.covariate_offsets):
        oh = oh + ((c_blk[c][..., None] + off == b_ids) & mask[..., None]).to(dtype)

    # old-block statistics: masked slots gathered the zero column
    rsum_old = torch.einsum("kbs->bk", R_blk)  # (nb, K)
    O_old = torch.einsum("kbs,bsc->bkc", R_blk.float(), oh.float()).to(dtype)

    theta_row = theta[None, :]
    sigma_col = sigma[:, None]
    sigma_f32 = sigma.float()[:, None]
    acc_d = torch.zeros((), dtype=f32, device=Z.device)
    acc_e = torch.zeros((), dtype=f32, device=Z.device)
    R_new = torch.zeros((K, nb, S), dtype=dtype, device=Z.device)
    for i in range(nb):
        Z_b, oh_b, m_b, cb = Z_blk[:, i], oh[i], mf[i], c_blk[:, i]

        # Step 1: remove the block's old contribution (src/harmony.cpp:312-313)
        E = E - rsum_old[i][:, None] * Pr_b[None, :]
        O = O - O_old[i]

        # Step 2: recompute the block's assignments (src/harmony.cpp:318-323)
        g = Y.t().float() @ Z_b.float()  # (K, S)
        d_b = (2.0 * (1.0 - g)).to(dtype)
        R_n = torch.exp(-d_b / sigma_col)
        R_n = l1_normalize_columns(R_n)
        pen = ((2.0 * E + 1.0) / (O + E + 1.0)) ** theta_row  # (K, B)
        pc = None
        for c, off in enumerate(cfg.covariate_offsets):
            t = pen[:, off:].index_select(1, cb[c])
            pc = t if pc is None else pc + t
        R_n = l1_normalize_columns(R_n * pc) * m_b[None, :]

        # Step 3: add the block back + objective accumulators
        E = E + R_n.sum(dim=1, keepdim=True) * Pr_b[None, :]
        O = O + (R_n.float() @ oh_b.float()).to(dtype)
        Rf = R_n.float()
        acc_d = acc_d + (Rf * d_b.float()).sum()
        acc_e = acc_e + (sigma_f32 * xlogx(Rf)).sum()
        R_new[:, i] = R_n

    # scatter back through the inverse map
    flat_idx = idx.reshape(-1)  # (nb*S,), N for pad slots
    pos = torch.full((N + 1,), nb * S, dtype=torch.int64, device=Z.device)
    pos[flat_idx] = torch.arange(nb * S, dtype=torch.int64, device=Z.device)
    R_flat = _pad1(R_new.reshape(K, nb * S))
    return RoundResult(R=R_flat[:, pos[:N]], E=E, O=O, kmeans_error=acc_d,
                       entropy=acc_e)


def objective_from_stats(
    cfg: HarmonyConfig,
    kmeans_error: torch.Tensor,
    entropy: torch.Tensor,
    O: torch.Tensor,
    E: torch.Tensor,
    sigma: torch.Tensor,
    theta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Objective from the round's accumulators plus the cross term as a
    K x B contraction: sum_{k,n} R sigma_k pen_log[k, code(n)] equals
    sum_{k,b} sigma_k pen_log[k, b] O[k, b] (estep.py:329-350)."""
    nc = cfg.norm_const
    Of, Ef = O.float(), E.float()
    pen_log = theta.float()[None, :] * torch.log((Of + Ef + 1.0) / (2.0 * Ef + 1.0))
    cross = (sigma.float()[:, None] * pen_log * Of).sum()
    total = (kmeans_error + entropy + cross) * nc
    return total, kmeans_error * nc, entropy * nc, cross * nc
