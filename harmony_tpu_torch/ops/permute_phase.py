"""The fused permute phase in plain PyTorch: the twin of K2 and K3.

Counterpart of ``harmony_tpu/ops/permute_phase.py`` (``xla_permute_phase``
without the mesh) and of ``harmony_tpu/ops/pallas_estep.py``
(``pallas_permute_phase``). During a clustering phase Y and Z are fixed
(src/harmony.cpp:236-238), so a cell's current assignment is a function of
(Y, its Z column, the penalty table in force when its block was last
committed). The phase carries those per-block tables, (K, (nb+1)·B) with
the all-ones row nb as the sentinel for the assignments made before the
phase, and each cell's last block id, instead of R. The cells' distances
are the same in every round of the phase, so they are computed once, by
:func:`phase_head`, into G (N, K), and each round takes its cells' rows
through the permutation. Each round recomputes the previous round's
assignments from the tables and removes them block by block, freezes each
block's penalty, assigns and adds; R is materialised once at the end, in
natural order, with pad cells exactly 0.

:func:`permute_rounds` is the plain version of K2 (the head and the rounds),
which hands G on, and :func:`materialize` of K3 (the final R from G's rows,
with the M-step's joint-batch moments when a :class:`MomentsSpec` is given);
``ops/cuda_permute.py`` holds the kernels. On the card this module's
one-device functions are used only by the tests and ``chip_smoke.py``;
:func:`sharded_permute_phase`, the phase on a mesh, is plain PyTorch as
the JAX package's is.

Blocks are contiguous ranges of the permutation (``block_bounds``), so the
round needs no pad slots. The first L1 normalisation is guarded against a
zero column, as in the port's other E-step functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import HarmonyConfig
from .assign import block_bounds
from .normalize import l1_normalize_columns
from .objective import xlogx

_F32 = torch.float32


class PermutePhaseResult(NamedTuple):
    R: torch.Tensor  # (K, Np) natural order, the final round's assignments
    E: torch.Tensor  # (K, B) after the last round
    O: torch.Tensor
    E_rounds: torch.Tensor  # (rounds, K, B) after each round
    O_rounds: torch.Tensor
    kmeans_error: torch.Tensor  # (rounds,)
    entropy: torch.Tensor  # (rounds,)
    M: Optional[torch.Tensor] = None  # (n_joint+1, K, d+1) fused moments


class MomentsSpec(NamedTuple):
    """The M-step's joint-batch moments, fused into the materialisation:
    M[j] = sum over the layout tiles t of joint j of R_t [Z_orig_t; 1]^T,
    the mixed and pad tiles in the trash row n_joint."""

    Z_orig: torch.Tensor  # (d, Np) float32
    tile_joint: np.ndarray  # (ceil(Np / tile),) int32, trash tiles n_joint
    n_joint: int
    tile: int


class PhaseTables(NamedTuple):
    """The context the rounds carry instead of R."""

    pen: torch.Tensor  # (K, (nb+1)·B) per-block penalty tables, ones row nb
    blk: torch.Tensor  # (Np,) int64 block of each cell's last assignment


class RoundsResult(NamedTuple):
    E: torch.Tensor
    O: torch.Tensor
    E_rounds: torch.Tensor
    O_rounds: torch.Tensor
    kmeans_error: torch.Tensor
    entropy: torch.Tensor
    tables: PhaseTables
    G: Optional[torch.Tensor] = None  # (N, K) the phase's distances, for materialize


def slot_blocks(cfg: HarmonyConfig, device) -> torch.Tensor:
    """(N,) block of each position of a permutation."""
    out = torch.empty(cfg.N, dtype=torch.int64, device=device)
    for i, (start, size) in enumerate(block_bounds(cfg)):
        out[start : start + size] = i
    return out


def phase_head(cfg: HarmonyConfig, Z: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The phase's distances G (N, K), cell-major: G[n, k] = 2 (1 - Y[:, k]
    . Z[:, n]) for the N cells (plain version of K2's head)."""
    g = Z[:, : cfg.N].to(_F32).t() @ Y.to(_F32)
    return 2.0 * (1.0 - g)


def _softmax_head(Yt, Z, sigma) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, L1(exp(-dist / sigma))) for the columns of Z."""
    dist = 2.0 * (1.0 - Yt @ Z)
    return dist, l1_normalize_columns(torch.exp(-dist / sigma[:, None]))


def _penalised(cfg, R1, pen, blk, codes) -> torch.Tensor:
    """L1(R1 * pc), pc[k, n] = sum_c pen[k, blk_n * B + off_c + code_c(n)]."""
    pc = None
    for c, off in enumerate(cfg.covariate_offsets):
        t = pen.index_select(1, blk * cfg.B + codes[c].long() + off)
        pc = t if pc is None else pc + t
    return l1_normalize_columns(R1 * pc)


def permute_rounds(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np) L2-normalised
    Y: torch.Tensor,  # (d, K)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,
    codes: torch.Tensor,  # (ncov, Np)
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    perms: torch.Tensor,  # (rounds, N)
) -> RoundsResult:
    """The phase's head and rounds (plain K2). Pre-condition: (E, O) are the
    statistics of the current assignments softmax(-dist / sigma), as right
    after init or the re-entry re-estimation (src/harmony.cpp:214-228)."""
    dev = Z.device
    K = sigma.shape[0]
    B, nb = cfg.B, cfg.n_blocks
    bounds = block_bounds(cfg)
    G = phase_head(cfg, Z, Y)
    sig, Pr, th = sigma.to(_F32), Pr_b.to(_F32)[None, :], theta.to(_F32)[None, :]
    E_c, O_c = E.to(_F32).clone(), O.to(_F32).clone()
    # every cell on the all-ones sentinel row: the assignment an all-ones
    # penalty gives is the softmax (E, O) were computed from
    pen_prev = torch.ones((K, (nb + 1) * B), dtype=_F32, device=dev)
    blk_nat = torch.full((cfg.Np,), nb, dtype=torch.int64, device=dev)
    slot_blk = slot_blocks(cfg, dev)
    ones = torch.ones((K, B), dtype=_F32, device=dev)
    b_ids = torch.arange(B, device=dev)
    E_st, O_st, kerr_st, ent_st = [], [], [], []
    for r in range(perms.shape[0]):
        perm = torch.as_tensor(perms[r], device=dev).long()
        dist = G.index_select(0, perm).t()  # (K, N) in block order
        R1 = l1_normalize_columns(torch.exp(-dist / sig[:, None]))
        c_lay = codes.index_select(1, perm).long()
        oh = torch.zeros((perm.shape[0], B), dtype=_F32, device=dev)
        for c, off in enumerate(cfg.covariate_offsets):
            oh += (c_lay[c][:, None] + off == b_ids).to(_F32)

        # removal: the previous round's assignments, recomputed from the tables
        R_prev = _penalised(cfg, R1, pen_prev, blk_nat.index_select(0, perm), c_lay)
        rm_r = [R_prev[:, s : s + n].sum(dim=1) for s, n in bounds]
        rm_O = [R_prev[:, s : s + n] @ oh[s : s + n] for s, n in bounds]

        pens, acc_d, acc_e = [], 0.0, 0.0
        for i, (s, n) in enumerate(bounds):
            E_c = E_c - rm_r[i][:, None] * Pr
            O_c = O_c - rm_O[i]
            pen = ((2.0 * E_c + 1.0) / (O_c + E_c + 1.0)) ** th
            pens.append(pen)
            R_n = l1_normalize_columns(R1[:, s : s + n] * (pen @ oh[s : s + n].t()))
            E_c = E_c + R_n.sum(dim=1)[:, None] * Pr
            O_c = O_c + R_n @ oh[s : s + n]
            acc_d = acc_d + (R_n * dist[:, s : s + n]).sum()
            acc_e = acc_e + (sig[:, None] * xlogx(R_n)).sum()
        pen_prev = torch.cat(pens + [ones], dim=1)
        blk_nat = blk_nat.clone()
        blk_nat[perm] = slot_blk
        E_st.append(E_c)
        O_st.append(O_c)
        kerr_st.append(torch.as_tensor(acc_d, dtype=_F32, device=dev))
        ent_st.append(torch.as_tensor(acc_e, dtype=_F32, device=dev))
    return RoundsResult(E=E_c, O=O_c, E_rounds=torch.stack(E_st), O_rounds=torch.stack(O_st),
                        kmeans_error=torch.stack(kerr_st), entropy=torch.stack(ent_st),
                        tables=PhaseTables(pen=pen_prev, blk=blk_nat), G=G)


def materialize(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np)
    Y: torch.Tensor,  # (d, K)
    codes: torch.Tensor,  # (ncov, Np)
    sigma: torch.Tensor,  # (K,)
    tables: PhaseTables,
    moments: Optional[MomentsSpec] = None,
    G: Optional[torch.Tensor] = None,  # (N, K) the phase's distances
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The final round's R (K, Np) in natural order, pad cells 0, and with
    ``moments`` the joint-batch moment table (plain K3). The distances are
    G's rows, as the rounds read them; without G they are formed from Y
    and Z."""
    from .cuda_ridge import tile_moments_twin

    K, N = sigma.shape[0], cfg.N
    if G is None:
        _, R1 = _softmax_head(Y.to(_F32).t(), Z.to(_F32), sigma.to(_F32))
        R = _penalised(cfg, R1, tables.pen, tables.blk, codes)
        if cfg.Np != N:
            R[:, N:] = 0.0
    else:
        if G.shape != (N, K) or G.device != Z.device:
            raise ValueError(f"materialize: G must be ({N}, {K}) on {Z.device}, got "
                             f"{tuple(G.shape)} on {G.device}")
        R1 = l1_normalize_columns(torch.exp(-G.to(_F32).t() / sigma.to(_F32)[:, None]))
        R = torch.zeros((K, cfg.Np), dtype=_F32, device=Z.device)
        R[:, :N] = _penalised(cfg, R1, tables.pen, tables.blk[:N], codes[:, :N])
    if moments is None:
        return R, None
    M = tile_moments_twin(R, moments.Z_orig.to(_F32), moments.tile, moments.tile_joint,
                          moments.n_joint)
    return R, M


def permute_phase(
    cfg: HarmonyConfig,
    Z: torch.Tensor,
    Y: torch.Tensor,
    E: torch.Tensor,
    O: torch.Tensor,
    codes: torch.Tensor,
    Pr_b: torch.Tensor,
    sigma: torch.Tensor,
    theta: torch.Tensor,
    perms: torch.Tensor,
    moments: Optional[MomentsSpec] = None,
) -> PermutePhaseResult:
    """All of a clustering phase's rounds, R-gather-free, then R once."""
    rr = permute_rounds(cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms)
    R, M = materialize(cfg, Z, Y, codes, sigma, rr.tables, moments, G=rr.G)
    return PermutePhaseResult(R=R, E=rr.E, O=rr.O, E_rounds=rr.E_rounds,
                              O_rounds=rr.O_rounds, kmeans_error=rr.kmeans_error,
                              entropy=rr.entropy, M=M)


def rank_blocks(cfg: HarmonyConfig, mesh, perm: torch.Tensor):
    """This rank's part of the global blocks of the permutation ``perm``
    (N,): the positions of the permutation whose cells are the rank's real
    cells, ascending, those cells as the rank's column ids, and the cuts:
    block i is ``cells[cuts[i]:cuts[i + 1]]`` (maybe empty). Blocks are
    contiguous ranges of the permutation (``block_bounds``), so they are
    contiguous ranges of the rank's positions too."""
    from ..sharding import cell_range, valid_cells

    lo = cell_range(cfg, mesh)[0]
    nv = valid_cells(cfg, mesh)
    starts = torch.tensor([s for s, _ in block_bounds(cfg)] + [cfg.N], device=perm.device)
    pos = ((perm >= lo) & (perm < lo + nv)).nonzero().squeeze(1)  # ascending
    cells = perm.index_select(0, pos) - lo
    return pos, cells, torch.searchsorted(pos, starts).tolist()


def sharded_permute_phase(
    cfg: HarmonyConfig,
    mesh,
    Z: torch.Tensor,  # (d, n) the rank's columns, L2-normalised
    Y: torch.Tensor,  # (d, K) replicated
    E: torch.Tensor,  # (K, B) replicated
    O: torch.Tensor,
    codes: torch.Tensor,  # (ncov, n) the rank's columns
    Pr_b: torch.Tensor,
    sigma: torch.Tensor,
    theta: torch.Tensor,
    perms: torch.Tensor,  # (rounds, N) global permutations, replicated
) -> PermutePhaseResult:
    """The fused permute phase on a mesh (``xla_permute_phase`` with a
    mesh, harmony_tpu/ops/permute_phase.py:52), in plain PyTorch on each
    rank, as the JAX package runs it in XLA outside any kernel.

    The blocks are global, cut from the replicated global permutation
    (``block_bounds``), so the trajectory does not depend on the mesh size.
    Each rank holds the positions of the permutation whose cells are its
    own, in order, so a block is a contiguous range of them. Per round one
    all-reduce sums every block's removal (the previous round's assignments
    recomputed from the carried tables); then per block commit one
    all-reduce of the block's new K row sums and K x B O (src/harmony.cpp:
    309-331), after which every rank adds the same sums to the replicated
    E and O. The objective terms are summed once for the phase. R comes
    back as the rank's columns, pad cells 0, and no moment table: as in the
    JAX package (harmony_tpu/engine.py:280-282) the M-step sums the moments
    itself, K8 on the rank's layout tiles (``cuda_ridge.sharded_tile_moments``)."""
    from ..sharding import all_reduce_many, cell_range, valid_cells

    dev = Z.device
    K = sigma.shape[0]
    B, nb = cfg.B, cfg.n_blocks
    lo, hi = cell_range(cfg, mesh)
    nv = valid_cells(cfg, mesh)
    # the phase's distances of the rank's real cells, once
    G = 2.0 * (1.0 - Z[:, :nv].to(_F32).t() @ Y.to(_F32))  # (nv, K)
    sig, Pr, th = sigma.to(_F32), Pr_b.to(_F32)[None, :], theta.to(_F32)[None, :]
    E_c, O_c = E.to(_F32).clone(), O.to(_F32).clone()
    pen_prev = torch.ones((K, (nb + 1) * B), dtype=_F32, device=dev)
    blk_nat = torch.full((hi - lo,), nb, dtype=torch.int64, device=dev)
    slot_blk = slot_blocks(cfg, dev)
    ones = torch.ones((K, B), dtype=_F32, device=dev)
    b_ids = torch.arange(B, device=dev)
    E_st, O_st, kerr_st, ent_st = [], [], [], []
    for r in range(perms.shape[0]):
        pos, cells, cuts = rank_blocks(cfg, mesh, torch.as_tensor(perms[r], device=dev).long())
        dist = G.index_select(0, cells).t()  # (K, m) in block order
        R1 = l1_normalize_columns(torch.exp(-dist / sig[:, None]))
        c_lay = codes.index_select(1, cells).long()
        oh = torch.zeros((cells.shape[0], B), dtype=_F32, device=dev)
        for c, off in enumerate(cfg.covariate_offsets):
            oh += (c_lay[c][:, None] + off == b_ids).to(_F32)

        # removal: the previous round's assignments, recomputed from the
        # tables, every block's sums in one all-reduce
        R_prev = _penalised(cfg, R1, pen_prev, blk_nat.index_select(0, cells), c_lay)
        rm_r = torch.stack([R_prev[:, a:b].sum(dim=1) for a, b in zip(cuts, cuts[1:])])
        rm_O = torch.stack([R_prev[:, a:b] @ oh[a:b] for a, b in zip(cuts, cuts[1:])])
        rm_r, rm_O = all_reduce_many([rm_r, rm_O], mesh)

        pens = []
        acc_d = torch.zeros((), dtype=_F32, device=dev)
        acc_e = torch.zeros((), dtype=_F32, device=dev)
        for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
            E_c = E_c - rm_r[i][:, None] * Pr
            O_c = O_c - rm_O[i]
            pen = ((2.0 * E_c + 1.0) / (O_c + E_c + 1.0)) ** th
            pens.append(pen)
            R_n = l1_normalize_columns(R1[:, a:b] * (pen @ oh[a:b].t()))
            rs, Op = all_reduce_many([R_n.sum(dim=1), R_n @ oh[a:b]], mesh)
            E_c = E_c + rs[:, None] * Pr
            O_c = O_c + Op
            acc_d = acc_d + (R_n * dist[:, a:b]).sum()
            acc_e = acc_e + (sig[:, None] * xlogx(R_n)).sum()
        pen_prev = torch.cat(pens + [ones], dim=1)
        blk_nat = blk_nat.clone()
        blk_nat[cells] = slot_blk.index_select(0, pos)
        E_st.append(E_c)
        O_st.append(O_c)
        kerr_st.append(acc_d)
        ent_st.append(acc_e)
    kerr, ent = all_reduce_many([torch.stack(kerr_st), torch.stack(ent_st)], mesh)
    R = torch.zeros((K, hi - lo), dtype=_F32, device=dev)
    R1 = l1_normalize_columns(torch.exp(-G.t() / sig[:, None]))
    R[:, :nv] = _penalised(cfg, R1, pen_prev, blk_nat[:nv], codes[:, :nv])
    return PermutePhaseResult(R=R, E=E_c, O=O_c, E_rounds=torch.stack(E_st),
                              O_rounds=torch.stack(O_st), kmeans_error=kerr, entropy=ent)
