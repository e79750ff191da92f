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
kernel, in the JAX package, and plain PyTorch here on the card too; it
reads its schedule, a row of :func:`draw_rotate_schedules`' table, on the
device, so ``engine.run_rounds`` captures its rounds into a CUDA graph.

:func:`sharded_block_update_round` and :func:`sharded_rotate_update_round`
run the two rounds on a mesh, as the JAX package partitions its XLA
rounds: the blocks are global, each rank updates its own cells of each,
and the block statistics are summed over the ranks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

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


def _update_block(cfg, Y, E, O, rsum_old, O_old, Z_b, oh_b, cb, m_b, Pr_b, sigma, theta,
                  mesh=None):
    """One block of an update round: remove its old contribution (row sums
    ``rsum_old`` (K, 1), ``O_old`` (K, B)), recompute its assignments and
    add them back; on a ``mesh`` the block's cells are the rank's part of
    it and its new row sums and O are summed over the ranks (one
    all-reduce) before they are added. Returns (E, O, R_n, k-means error,
    entropy), the last two the rank's part."""
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
    rsum, O_new = R_n.sum(dim=1, keepdim=True), (R_n.float() @ oh_b.float()).to(dtype)
    if mesh is not None:
        from ..sharding import all_reduce_many

        rsum, O_new = (t.to(dtype) for t in all_reduce_many([rsum, O_new], mesh))
    E = E + rsum * Pr_b[None, :]
    O = O + O_new
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


def _design(cfg: HarmonyConfig, codes: torch.Tensor, dtype) -> torch.Tensor:
    """(n, B) stacked one-hot design of (ncov, n) codes."""
    b_ids = torch.arange(cfg.B, device=codes.device)
    oh = torch.zeros((codes.shape[1], cfg.B), dtype=dtype, device=codes.device)
    for c, off in enumerate(cfg.covariate_offsets):
        oh = oh + (codes[c].long()[:, None] + off == b_ids).to(dtype)
    return oh


def _sharded_blocks(cfg, mesh, Z, Y, R_c, E, O, codes, cells, cuts, Pr_b, sigma,
                    theta) -> RoundResult:
    """The blocks of a round on a mesh, in order: block i is the rank's
    real cells ``cells[cuts[i]:cuts[i+1]]`` (column ids of Z and the
    codes), whose old statistics are read from ``R_c`` (K, len(cells)), R's
    columns of ``cells``. Every block's old statistics are summed over the
    ranks in one all-reduce before the first block, each block's commit in
    one after its assignments (:func:`_update_block`), the objective terms
    in one at the end. R comes back in the order of ``cells``."""
    from ..sharding import all_reduce_many

    dtype, f32 = R_c.dtype, torch.float32
    Z_c = Z.index_select(1, cells)
    c_c = codes.index_select(1, cells).long()
    oh = _design(cfg, c_c, dtype)
    bl = list(zip(cuts, cuts[1:]))
    rsum_old = torch.stack([R_c[:, a:b].sum(dim=1) for a, b in bl])  # (nb, K)
    O_old = torch.stack([R_c[:, a:b].float() @ oh[a:b].float() for a, b in bl])
    rsum_old, O_old = (t.to(dtype) for t in all_reduce_many([rsum_old, O_old], mesh))
    acc_d = torch.zeros((), dtype=f32, device=Z.device)
    acc_e = torch.zeros((), dtype=f32, device=Z.device)
    R_new = torch.empty_like(R_c)
    ones = R_c.new_ones(R_c.shape[1])
    for i, (a, b) in enumerate(bl):
        E, O, R_n, kerr, ent = _update_block(
            cfg, Y, E, O, rsum_old[i][:, None], O_old[i], Z_c[:, a:b], oh[a:b], c_c[:, a:b],
            ones[a:b], Pr_b, sigma, theta, mesh)
        acc_d, acc_e = acc_d + kerr, acc_e + ent
        R_new[:, a:b] = R_n
    acc_d, acc_e = all_reduce_many([acc_d.reshape(1), acc_e.reshape(1)], mesh)
    return RoundResult(R=R_new, E=E, O=O, kmeans_error=acc_d[0], entropy=acc_e[0])


def sharded_block_update_round(
    cfg: HarmonyConfig,
    mesh,
    Z: torch.Tensor,  # (d, n) the rank's columns, L2-normalised
    Y: torch.Tensor,  # (d, K) replicated
    R: torch.Tensor,  # (K, n), or (K, nv) in the order ``order``
    E: torch.Tensor,  # (K, B) replicated
    O: torch.Tensor,
    codes: torch.Tensor,  # (ncov, n) the rank's columns
    Pr_b: torch.Tensor,
    sigma: torch.Tensor,
    theta: torch.Tensor,
    perm: torch.Tensor,  # (N,) global permutation, replicated
    order: Optional[torch.Tensor] = None,
) -> Tuple[RoundResult, torch.Tensor]:
    """:func:`block_update_round` on a mesh (the JAX package's XLA round
    on the sharded state, harmony_tpu/engine.py:356-367), plain PyTorch on
    each rank. The blocks are global, cut from the replicated global
    permutation (``permute_phase.rank_blocks``), so the trajectory does not
    depend on the mesh size; each rank updates the members of each block
    that are its cells, and the statistics are summed over the ranks where
    the JAX package's partitioned sums are (:func:`_sharded_blocks`).
    ``order`` says which of the rank's columns R's columns hold (None: all
    n in order). Returns the round, R's columns holding the rank's real
    cells in the permutation's order, and those cells (the round's
    ``order`` for the next round; pad cells are in no block)."""
    from .permute_phase import rank_blocks

    _, cells, cuts = rank_blocks(cfg, mesh, perm.to(Z.device).long())
    if order is not None:
        R = R.new_zeros((R.shape[0], Z.shape[1])).index_copy_(1, order, R)
    return _sharded_blocks(cfg, mesh, Z, Y, R.index_select(1, cells), E, O, codes, cells, cuts,
                           Pr_b, sigma, theta), cells


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
    oh = _design(cfg, codes_pad, Z.dtype) * valid_pad[:, None]
    return RotateLayout(Z_pad=mirror(Z), oh_pad=oh, codes_pad=codes_pad, valid_pad=valid_pad)


def draw_rotate_schedules(cfg: HarmonyConfig, generator: torch.Generator,
                          rounds: int) -> torch.Tensor:
    """``rounds`` rounds' schedules of :func:`rotate_update_round`
    (harmony_tpu/ops/estep.py:250-252): the cell rotations in [0, Np) by
    one ``randint``, then one ``randperm`` of the n_blocks blocks a round,
    as a (rounds, 1 + n_blocks) int32 table on the generator's device in
    the layout of ``ops/rotate.draw_schedules`` (row r: round r's
    rotation, then its block order). The table stays there, so a round
    reads its row with no host read."""
    dev = generator.device
    rs = torch.randint(0, cfg.Np, (rounds,), generator=generator, device=dev)
    orders = torch.stack([torch.randperm(cfg.n_blocks, generator=generator, device=dev)
                          for _ in range(rounds)])
    return torch.cat([rs[:, None], orders], dim=1).to(torch.int32)


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
    sched: torch.Tensor,  # (1 + n_blocks,) the round's row of the schedule table
    layout: Optional[RotateLayout] = None,
) -> RoundResult:
    """The cell-granular rotate round (harmony_tpu/ops/estep.py:212) for
    the schedule row ``sched`` (:func:`draw_rotate_schedules`: the rotation
    r, then the block order): virtual position p < Np holds cell
    (p + r) mod Np, block b is positions [b S, (b+1) S), and the blocks run
    in the row's order. The row is read on the device: each block's start
    (b S + r) mod Np in the mirror-padded layout, its live mask (the last
    block's positions past Np are dead) and the cells it covers are
    tensors, its columns of the layout and of the mirror-padded R are
    gathered with ``index_select`` (the JAX function's ``dynamic_slice``),
    and R is written back from the blocks with one gather through each
    cell's slot, so no tensor becomes a Python number and a captured round
    replays any schedule. Each block reads its old statistics from R, then
    updates as :func:`block_update_round` does; the loop over the n_blocks
    positions is a Python loop of fixed length."""
    K, Np = R.shape
    nb, S = cfg.n_blocks, _block_len(cfg)
    dtype = R.dtype
    dev = R.device
    if layout is None:
        layout = make_rotate_layout(cfg, Z, codes)
    sched = sched.to(dev).long()
    r, order = sched[0], sched[1:]
    pos = torch.arange(S, device=dev)
    # the blocks in the round's order: their columns of the mirror layout
    # and their live slots
    vpos = order[:, None] * S + pos  # (nb, S) virtual positions
    cols = (torch.remainder(order * S + r, Np)[:, None] + pos).reshape(-1)
    live = (vpos < Np).to(dtype)
    R_pad = torch.cat([R, R[:, :S]], dim=1)
    R_old = R_pad.index_select(1, cols).reshape(K, nb, S) * live
    Z_blk = layout.Z_pad.index_select(1, cols).reshape(-1, nb, S)
    oh_blk = layout.oh_pad.index_select(0, cols).reshape(nb, S, -1)
    c_blk = layout.codes_pad.index_select(1, cols).reshape(-1, nb, S).long()
    m_blk = live * layout.valid_pad.index_select(0, cols).reshape(nb, S)
    acc_d = torch.zeros((), dtype=torch.float32, device=dev)
    acc_e = torch.zeros((), dtype=torch.float32, device=dev)
    R_new = torch.empty((K, nb, S), dtype=dtype, device=dev)
    for j in range(nb):
        R_o = R_old[:, j]
        E, O, R_n, kerr, ent = _update_block(
            cfg, Y, E, O, R_o.sum(dim=1, keepdim=True),
            (R_o.float() @ oh_blk[j].float()).to(dtype), Z_blk[:, j], oh_blk[j], c_blk[:, j],
            m_blk[j], Pr_b, sigma, theta)
        acc_d, acc_e = acc_d + kerr, acc_e + ent
        R_new[:, j] = R_n
    # cell c sits at virtual position p = (c - r) mod Np, slot p mod S of
    # block p // S, which ran at the position of that block in the order
    at = torch.empty_like(order).index_copy_(0, order, torch.arange(nb, device=dev))
    p = torch.remainder(torch.arange(Np, device=dev) - r, Np)
    slot = at.index_select(0, p // S) * S + p % S
    R_out = R_new.reshape(K, nb * S).index_select(1, slot)
    return RoundResult(R=R_out, E=E, O=O, kmeans_error=acc_d, entropy=acc_e)


def rotate_block_cells(cfg: HarmonyConfig, mesh, sched: Sequence[int], j: int) -> torch.Tensor:
    """The rank's real cells of the block at position ``j`` of the
    cell-granular schedule row ``sched`` (the rotation r, then the block
    order; a host row of :func:`draw_rotate_schedules`' table), as its
    column ids, in the block's order: block b covers cells (r + b S + i)
    mod Np for i below its live length min(S, Np - b S), which may wrap
    past the last cell and span ranks."""
    from ..sharding import cell_range, valid_cells

    Np, S = cfg.Np, _block_len(cfg)
    r, b = int(sched[0]), int(sched[1 + j])
    lo = cell_range(cfg, mesh)[0]
    hi = lo + valid_cells(cfg, mesh)
    start, L = (b * S + r) % Np, max(min(S, Np - b * S), 0)
    runs = [(start, min(start + L, Np))] + ([(0, start + L - Np)] if start + L > Np else [])
    runs = [(max(a, lo), min(e, hi)) for a, e in runs]
    return torch.cat([torch.arange(a, max(a, e), dtype=torch.int64) - lo for a, e in runs])


def sharded_rotate_update_round(
    cfg: HarmonyConfig,
    mesh,
    Z: torch.Tensor,  # (d, n) the rank's columns, L2-normalised
    Y: torch.Tensor,  # (d, K) replicated
    R: torch.Tensor,  # (K, n)
    E: torch.Tensor,  # (K, B) replicated
    O: torch.Tensor,
    codes: torch.Tensor,  # (ncov, n)
    Pr_b: torch.Tensor,
    sigma: torch.Tensor,
    theta: torch.Tensor,
    sched: Sequence[int],  # the round's row of the schedule table, on the host
) -> RoundResult:
    """:func:`rotate_update_round` on a mesh (the JAX package's XLA round
    on the sharded state, harmony_tpu/engine.py:449-451), plain PyTorch on
    each rank. The schedule table is global, drawn alike on every rank, and
    read to the host once a phase (gloo's collectives are not captured, so
    a mesh round runs on the host loop); each block is the global slice of
    the mirror layout, cut to the rank's real cells
    (:func:`rotate_block_cells`; pad cells are in no block), and its
    statistics are summed over the ranks as
    :func:`sharded_block_update_round` sums them. R comes back in the
    rank's columns, pad cells 0."""
    blocks = [rotate_block_cells(cfg, mesh, sched, j).to(R.device)
              for j in range(len(sched) - 1)]
    cuts = [0]
    for c in blocks:
        cuts.append(cuts[-1] + c.shape[0])
    cells = torch.cat(blocks)
    res = _sharded_blocks(cfg, mesh, Z, Y, R.index_select(1, cells), E, O, codes, cells, cuts,
                          Pr_b, sigma, theta)
    return res._replace(R=torch.zeros_like(R).index_copy_(1, cells, res.R))


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
