"""The E-step rounds in plain PyTorch: the twin of the K1 kernel, and the
cell-granular rotate round.

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

:func:`rotate_update_round` is the rotate schedule's round below
``n_blocks * 128`` cells (``HarmonyConfig.rotate_route == 'cell'``), where
whole tiles cannot make the reference's block count. It is XLA, not a
kernel, in the JAX package, and plain PyTorch here on the card too.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

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


def _update_block(cfg, Y, E, O, rsum_old, O_old, Z_b, oh_b, cb, m_b, Pr_b, sigma, theta):
    """One block of an update round: remove its old contribution (row sums
    ``rsum_old`` (K, 1), ``O_old`` (K, B)), recompute its assignments and
    add them back. Returns (E, O, R_n, k-means error, entropy)."""
    dtype = E.dtype
    # Step 1: remove the block's old contribution (src/harmony.cpp:312-313)
    E = E - rsum_old * Pr_b[None, :]
    O = O - O_old

    # Step 2: recompute the block's assignments (src/harmony.cpp:318-323)
    g = Y.t().float() @ Z_b.float()  # (K, S)
    d_b = (2.0 * (1.0 - g)).to(dtype)
    R_n = l1_normalize_columns(torch.exp(-d_b / sigma[:, None]))
    pen = ((2.0 * E + 1.0) / (O + E + 1.0)) ** theta[None, :]  # (K, B)
    pc = None
    for c, off in enumerate(cfg.covariate_offsets):
        t = pen[:, off:].index_select(1, cb[c])
        pc = t if pc is None else pc + t
    R_n = l1_normalize_columns(R_n * pc) * m_b[None, :]

    # Step 3: add the block back + objective accumulators
    E = E + R_n.sum(dim=1, keepdim=True) * Pr_b[None, :]
    O = O + (R_n.float() @ oh_b.float()).to(dtype)
    Rf = R_n.float()
    return (E, O, R_n, (Rf * d_b.float()).sum(),
            (sigma.float()[:, None] * xlogx(Rf)).sum())


def block_update_round(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np) L2-normalised corrected embedding
    Y: torch.Tensor,  # (d, K) L2-normalised centroids
    R: torch.Tensor,  # (K, Np)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    codes: torch.Tensor,  # (ncov, Np)
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    perm: torch.Tensor,  # (N,) cell permutation
    order: Optional[torch.Tensor] = None,
    carry: bool = False,
) -> RoundResult:
    """One full update_R round in block layout, objective terms included.

    ``order`` says which cells R's columns hold (None: the cells in
    order); ``carry=True`` returns R with the columns in the round's block
    order (column p holds cell ``perm[p]``), so a phase can hand it to its
    next round as ``order=perm`` and scatter it back once at its end."""
    if order is not None:
        R = torch.empty_like(R).index_copy_(1, order.to(R.device).long(), R)
    K, Np = R.shape
    nb, S = cfg.n_blocks, cfg.max_block_size
    dtype = R.dtype
    f32 = torch.float32

    idx, mask = make_blocks(cfg, perm.to(Z.device))  # (nb, S); sentinel Np
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

    acc_d = torch.zeros((), dtype=f32, device=Z.device)
    acc_e = torch.zeros((), dtype=f32, device=Z.device)
    R_new = torch.zeros((K, nb, S), dtype=dtype, device=Z.device)
    for i in range(nb):
        E, O, R_n, kerr, ent = _update_block(
            cfg, Y, E, O, rsum_old[i][:, None], O_old[i], Z_blk[:, i], oh[i], c_blk[:, i],
            mf[i], Pr_b, sigma, theta)
        acc_d, acc_e = acc_d + kerr, acc_e + ent
        R_new[:, i] = R_n

    if carry:  # the blocks' slots in order are the round's positions
        R_pos = R_new.reshape(K, nb * S)[:, mask.reshape(-1)]
        return RoundResult(R=R_pos, E=E, O=O, kmeans_error=acc_d, entropy=acc_e)
    # scatter back through the inverse map
    flat_idx = idx.reshape(-1)  # (nb*S,), Np for pad slots
    pos = torch.full((Np + 1,), nb * S, dtype=torch.int64, device=Z.device)
    pos[flat_idx] = torch.arange(nb * S, dtype=torch.int64, device=Z.device)
    R_flat = _pad1(R_new.reshape(K, nb * S))
    return RoundResult(R=R_flat[:, pos[:Np]], E=E, O=O, kmeans_error=acc_d,
                       entropy=acc_e)


class RotateLayout(NamedTuple):
    """Phase constants of the cell-granular rotate round (Z and the codes
    are fixed across a phase's rounds), each followed by a mirror of its
    first S cells."""

    Z_pad: torch.Tensor  # (d, Np+S)
    oh_pad: torch.Tensor  # (Np+S, B) one-hot design, pad rows zero
    codes_pad: torch.Tensor  # (ncov, Np+S)
    valid_pad: torch.Tensor  # (Np+S,) 1.0 for real cells


def _block_len(cfg: HarmonyConfig) -> int:
    return -(-cfg.Np // cfg.n_blocks)


def make_rotate_layout(cfg: HarmonyConfig, Z: torch.Tensor, codes: torch.Tensor) -> RotateLayout:
    """The mirror-padded phase constants (harmony_tpu/ops/estep.py:185):
    with the first S = ceil(Np / n_blocks) cells appended, every circular
    block ``[(r + b S) mod Np, +S)`` is one contiguous slice."""
    S = _block_len(cfg)
    mirror = lambda X: torch.cat([X, X[..., :S]], dim=-1)
    valid_pad = mirror((torch.arange(cfg.Np, device=Z.device) < cfg.N).to(Z.dtype))
    codes_pad = mirror(codes)
    b_ids = torch.arange(cfg.B, device=Z.device)
    oh = torch.zeros((cfg.Np + S, cfg.B), dtype=Z.dtype, device=Z.device)
    for c, off in enumerate(cfg.covariate_offsets):
        oh = oh + ((codes_pad[c].long()[:, None] + off == b_ids)
                   & (valid_pad[:, None] > 0)).to(Z.dtype)
    return RotateLayout(Z_pad=mirror(Z), oh_pad=oh, codes_pad=codes_pad, valid_pad=valid_pad)


def draw_rotate_schedules(cfg: HarmonyConfig, generator: torch.Generator,
                          rounds: int) -> List[Tuple[int, List[int]]]:
    """``rounds`` (cell rotation in [0, Np), order of the n_blocks blocks)
    pairs for :func:`rotate_update_round` (estep.py:250-252), drawn
    together and brought to the host once."""
    dev = generator.device
    rs = torch.randint(0, cfg.Np, (rounds,), generator=generator, device=dev)
    orders = [torch.randperm(cfg.n_blocks, generator=generator, device=dev).tolist()
              for _ in range(rounds)]
    return list(zip(rs.tolist(), orders))


def rotate_update_round(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np) L2-normalised corrected embedding
    Y: torch.Tensor,  # (d, K)
    R: torch.Tensor,  # (K, Np)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    codes: torch.Tensor,  # (ncov, Np)
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    r: int,
    order: Sequence[int],
    layout: Optional[RotateLayout] = None,
) -> RoundResult:
    """The cell-granular rotate round (harmony_tpu/ops/estep.py:212) for
    the schedule (r, order): virtual position p < Np holds cell
    (p + r) mod Np, block b is positions [b S, (b+1) S), and the blocks run
    in ``order``. Each block reads its old statistics from R, then updates
    as :func:`block_update_round` does. The last block's positions past
    Np are dead (``live``); its write keeps what the neighbours wrote, and
    the mirror region folds back onto the first S cells at the end."""
    K, Np = R.shape
    S = _block_len(cfg)
    dtype, f32 = R.dtype, torch.float32
    if layout is None:
        layout = make_rotate_layout(cfg, Z, codes)
    R_pad = torch.cat([R, R[:, :S]], dim=1)
    pos = torch.arange(S, device=R.device)
    acc_d = torch.zeros((), dtype=f32, device=R.device)
    acc_e = torch.zeros((), dtype=f32, device=R.device)
    R_new = torch.zeros((K, Np + S), dtype=dtype, device=R.device)
    for b in order:
        b = int(b)
        start = (b * S + r) % Np
        sl = slice(start, start + S)
        live = ((b * S + pos) < Np).to(dtype)
        oh_b = layout.oh_pad[sl]
        R_old = R_pad[:, sl] * live[None, :]
        E, O, R_n, kerr, ent = _update_block(
            cfg, Y, E, O, R_old.sum(dim=1, keepdim=True),
            (R_old.float() @ oh_b.float()).to(dtype), layout.Z_pad[:, sl], oh_b,
            layout.codes_pad[:, sl].long(), live * layout.valid_pad[sl], Pr_b, sigma, theta)
        acc_d, acc_e = acc_d + kerr, acc_e + ent
        R_new[:, sl] = torch.where(live[None, :] > 0, R_n, R_new[:, sl])
    # each cell was written once, at its own position or at its mirror
    R_out = R_new[:, :Np].clone()
    R_out[:, :S] += R_new[:, Np:]
    return RoundResult(R=R_out, E=E, O=O, kmeans_error=acc_d, entropy=acc_e)


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
