"""Mixture-of-experts ridge correction (M-step), batched over clusters.

Counterpart of the dense path of ``harmony_tpu/ops/ridge.py``
(``moe_correct_ridge_cpp``, src/harmony.cpp:345-638). The reference
subsets cells and batches per cluster; here subsetting is masking, with
the same exactness argument as the JAX package:

* dropped cells get ``R_eff = 0`` and add nothing to any moment;
* dropped batches get a zero design row and an identity row in the normal
  matrix, so their beta rows are exactly 0;
* clusters with no covariate keeping >= 2 levels (src/harmony.cpp:449-452)
  get W == 0 and keep their old centroid.

Single-covariate runs with ``mstep_impl='kernel'`` take their moments and
correction from the K4/K5 wrappers (``ops/cuda_ridge.py``), which launch
the CUDA kernels on the card and run their plain twins on the CPU.
That branch drops the cell mask: with one covariate a cell is dropped iff
its only batch is, so keep-masking the per-batch moments is the cell mask,
and a dropped batch's beta rows are exactly zero, so no cell receives a
correction from it (src/harmony.cpp:368-410). Runs with more covariates
stay on the dense PyTorch contractions, as the JAX package keeps them on
XLA.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..config import HarmonyConfig
from .normalize import l2_normalize_columns

_F32 = torch.float32


def _covariate_of_batch(cfg: HarmonyConfig, device) -> torch.Tensor:
    """(B,) covariate id of each global batch row (src/harmony.cpp:96-97)."""
    ids = [c for c, b in enumerate(cfg.B_vec) for _ in range(b)]
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def compute_masks(
    cfg: HarmonyConfig, O: torch.Tensor, batch_sizes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-filter masks: (keep (K, B) bool, any_active (K,) bool).

    keep[k, b] iff O[k,b]/N_b exceeds the cutoff AND b's covariate keeps
    >= 2 such levels (src/harmony.cpp:368-410); any_active[k] iff some
    covariate keeps >= 2 levels (src/harmony.cpp:449-452).
    """
    present = (O / batch_sizes[None, :]) > cfg.batch_prop_cutoff  # (K, B)
    cov_of_b = _covariate_of_batch(cfg, O.device)
    cov_levels = torch.zeros(
        (O.shape[0], cfg.n_covariates), dtype=torch.int64, device=O.device
    )
    cov_levels.index_add_(1, cov_of_b, present.long())  # integer: exact
    cov_active = cov_levels > 1
    keep = present & cov_active.index_select(1, cov_of_b)
    return keep, cov_active.any(dim=1)


def _onehots(cfg: HarmonyConfig, codes: torch.Tensor) -> List[torch.Tensor]:
    return [
        torch.nn.functional.one_hot(codes[c].long(), cfg.B_vec[c]).to(_F32)
        for c in range(cfg.n_covariates)
    ]


def _moments_dense(cfg, R_eff, Zf, codes, onehots=None):
    """One-hot contractions, O(K·N·B·d): for each covariate, M[k, b, :] =
    sum_n R[k,n] oh[n,b] [Z;1][:, n]; the ones row gives O. Returns
    (O_eff (K,B), rhs_batches (K,B,d), cross_blocks, onehots)."""
    if onehots is None:
        onehots = _onehots(cfg, codes)
    Z_aug = torch.cat([Zf, Zf.new_ones((1, Zf.shape[1]))], dim=0)  # (d+1, N)
    moments = [
        torch.stack([(R_eff * oh[:, b]) @ Z_aug.t() for b in range(oh.shape[1])], 1)
        for oh in onehots
    ]
    O_eff = torch.cat([M[:, :, -1] for M in moments], dim=1)
    rhs_batches = torch.cat([M[:, :, :-1] for M in moments], dim=1)
    cross_blocks: Dict[Tuple[int, int], torch.Tensor] = {}
    for c1 in range(cfg.n_covariates):
        for c2 in range(c1 + 1, cfg.n_covariates):
            b1, b2 = cfg.B_vec[c1], cfg.B_vec[c2]
            joint = codes[c1].long() * b2 + codes[c2].long()
            ohj = torch.nn.functional.one_hot(joint, b1 * b2).to(_F32)
            cross_blocks[(c1, c2)] = (R_eff @ ohj).reshape(cfg.K, b1, b2)
    return O_eff, rhs_batches, cross_blocks, onehots


def _correction_dense(cfg, W, R_eff, onehots):
    """corr[:, n] = sum_c sum_k R[k,n] W[k, 1+off_c+code_c(n), :]."""
    corr = None
    for c, oh in enumerate(onehots):
        o = cfg.covariate_offsets[c]
        for b in range(oh.shape[1]):
            t = W[:, 1 + o + b, :].t() @ (R_eff * oh[:, b])
            corr = t if corr is None else corr + t
    return corr


def moe_correct_ridge(
    cfg: HarmonyConfig,
    Z_orig: torch.Tensor,  # (d, N)
    R: torch.Tensor,  # (K, N)
    O: torch.Tensor,  # (K, B)
    E: torch.Tensor,  # (K, B)
    codes: torch.Tensor,  # (ncov, N)
    batch_sizes: torch.Tensor,  # (B,)
    lamb: torch.Tensor,  # (B+1,) fixed ridge diag (ignored when estimating)
    Y_old: torch.Tensor,  # (d, K)
    onehots=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (Z_corr, Y_new, W); W is (K, B+1, d) with intercept rows zeroed.
    Z_corr is recomputed from Z_orig (src/harmony.cpp:347)."""
    K, B = cfg.K, cfg.B
    dev = Z_orig.device
    keep, any_active = compute_masks(cfg, O, batch_sizes)
    keepf = keep.to(_F32)
    use_kernel = cfg.mstep_impl == "kernel" and cfg.n_covariates == 1
    Zf = Z_orig.to(_F32).contiguous()
    cross_blocks: Dict[Tuple[int, int], torch.Tensor] = {}

    if use_kernel:
        from .cuda_ridge import moments

        Rf = R.to(_F32).contiguous()
        M = moments(Rf, Zf, codes[0].contiguous(), B)  # (K, B, d+1)
        O_eff = M[:, :, -1] * keepf
        rhs_batches = M[:, :, :-1] * keepf[:, :, None]
        r_tot = O_eff.sum(dim=1)
        rhs0 = rhs_batches.sum(dim=1)
    elif cfg.n_covariates == 1:
        # keep-masking the moments is the cell mask (see module docstring)
        R_eff = R.to(_F32)
        O_all, rhs_all, _, onehots = _moments_dense(cfg, R_eff, Zf, codes, onehots)
        O_eff = O_all * keepf
        rhs_batches = rhs_all * keepf[:, :, None]
        r_tot = O_eff.sum(dim=1)
        rhs0 = rhs_batches.sum(dim=1)
    else:
        # a cell is kept iff ANY of its batches is (src/harmony.cpp:389-402);
        # an all-true mask multiplies by 1.0, which is exact
        cell_mask = None
        for c, off in enumerate(cfg.covariate_offsets):
            kc = keep[:, off : off + cfg.B_vec[c]].index_select(1, codes[c].long())
            cell_mask = kc if cell_mask is None else (cell_mask | kc)
        R_eff = R.to(_F32) * cell_mask.to(_F32)
        O_eff, rhs_batches, cross_blocks, onehots = _moments_dense(
            cfg, R_eff, Zf, codes, onehots
        )
        # every cell has exactly one covariate-0 level: their sum is the
        # intercept moment (src/harmony.cpp:561)
        b0 = cfg.B_vec[0]
        r_tot = O_eff[:, :b0].sum(dim=1)
        rhs0 = rhs_batches[:, :b0, :].sum(dim=1)
        O_eff = O_eff * keepf
        rhs_batches = rhs_batches * keepf[:, :, None]

    # ---- Normal matrices G (K, B+1, B+1) ---------------------------------
    G = torch.zeros((K, B + 1, B + 1), dtype=_F32, device=dev)
    G[:, 0, 0] = r_tot
    G[:, 0, 1:] = O_eff
    G[:, 1:, 0] = O_eff
    diag = torch.arange(1, B + 1, device=dev)
    G[:, diag, diag] = O_eff
    offsets = cfg.covariate_offsets
    for (c1, c2), cross in cross_blocks.items():
        b1, b2 = cfg.B_vec[c1], cfg.B_vec[c2]
        o1, o2 = offsets[c1], offsets[c2]
        cross = (
            cross
            * keepf[:, o1 : o1 + b1][:, :, None]
            * keepf[:, o2 : o2 + b2][:, None, :]
        )
        G[:, 1 + o1 : 1 + o1 + b1, 1 + o2 : 1 + o2 + b2] = cross
        G[:, 1 + o2 : 1 + o2 + b2, 1 + o1 : 1 + o1 + b1] = cross.transpose(1, 2)

    # ---- Ridge diagonal (lambda) -----------------------------------------
    if cfg.lambda_estimation:
        # lambda = alpha * E (find_lambda_cpp, src/utils.cpp:159-163)
        lam_b = cfg.alpha * E.to(_F32)
    else:
        lam_b = lamb[1:].to(_F32).expand(K, B)
    one = torch.ones((), dtype=_F32, device=dev)
    G[:, diag, diag] = G[:, diag, diag] + torch.where(keep, lam_b, one)
    G[:, 0, 0] = G[:, 0, 0] + torch.where(any_active, 0.0 * one, one)

    rhs = torch.cat([rhs0[:, None, :], rhs_batches], dim=1)  # (K, B+1, d)
    W = _solve_ridge(cfg, G, rhs)

    # centroid refresh from the intercept betas (src/harmony.cpp:610-611);
    # skipped clusters keep their centroid
    Y_new = torch.where(any_active[None, :], W[:, 0, :].t().to(Y_old.dtype), Y_old)
    Y_new = l2_normalize_columns(Y_new)
    W = W.clone()
    W[:, 0, :] = 0.0

    # ---- Correction: Z_corr = Z_orig - sum_k W_k^T Phi_Rk ----------------
    if use_kernel:
        from .cuda_ridge import correction

        Z_corr = correction(W[:, 1:, :].contiguous(), Rf, Zf, codes[0].contiguous())
        return Z_corr.to(Z_orig.dtype), Y_new, W
    corr = _correction_dense(cfg, W, R_eff, onehots)
    return (Zf - corr).to(Z_orig.dtype), Y_new, W


def _solve_ridge(cfg: HarmonyConfig, G: torch.Tensor, rhs: torch.Tensor):
    """Batched solve of G W = rhs, G symmetric positive definite.

    'auto' mirrors the reference: the closed-form arrowhead inverse for one
    covariate (src/harmony.cpp:574-586), a general solve otherwise
    (``arma::inv``, src/harmony.cpp:572-573, here Cholesky).
    """
    solver = cfg.ridge_solver
    if solver == "auto":
        solver = "arrowhead" if cfg.n_covariates == 1 else "cholesky"
    if solver == "solve":
        return torch.linalg.solve(G, rhs)
    if solver == "arrowhead":
        if cfg.n_covariates != 1:
            raise ValueError("arrowhead solver requires a single covariate")
        return _arrowhead_solve(G, rhs)
    if solver != "cholesky":
        raise ValueError(f"unknown ridge_solver {solver!r}")
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(rhs, L)


def _arrowhead_solve(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Closed-form arrowhead inverse applied to rhs (src/harmony.cpp:574-586).

    For G = [[b0, a^T], [a, D]] with diagonal D: inv = (1/u) m m^T + diag(b)
    with b = 1/diag(G) (b[0] = 0), m = (-a) * b (m[0] = 1),
    u = b0 - sum(a^2 * b).
    """
    ac = -G[:, 0, :].clone()
    ac[:, 0] = 1.0
    b0 = G[:, 0, 0]
    b = 1.0 / torch.diagonal(G, dim1=1, dim2=2)
    b[:, 0] = 0.0
    u = b0 - (ac * ac * b).sum(dim=1)
    ac_b = ac * b
    ac_b[:, 0] = 1.0
    t = torch.einsum("kb,kbd->kd", ac_b, rhs)
    return ac_b[:, :, None] * (t / u[:, None])[:, None, :] + b[:, :, None] * rhs
