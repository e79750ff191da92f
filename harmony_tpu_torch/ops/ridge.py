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
the CUDA kernels on the card and run their plain twins on the CPU. Both
kernels visit each tile's cells batch by batch through ``cells``, the
per-tile index of the codes that ``engine.mstep_layout`` builds once a run.
That branch drops the cell mask: with one covariate a cell is dropped iff
its only batch is, so keep-masking the per-batch moments is the cell mask,
and a dropped batch's beta rows are exactly zero, so no cell receives a
correction from it (src/harmony.cpp:368-410). Runs with more covariates
stay on the dense PyTorch contractions, as the JAX package keeps them on
XLA.

With a batch-tiled layout (``tiled``, ops/tiled.py; the rotate schedule's
ingest order) the moments and the correction take the O(K·N·d) tiled
path of ``harmony_tpu/ops/ridge.py:384-547``: K8 gives the per-joint-batch
moment table over the batch-pure layout tiles and K9 the correction per
pure tile (``ops/cuda_ridge.py``); the trailing mixed/pad region goes
through dense one-hot products. Segment sums over joint levels are one-hot
products, not ``index_add_``, whose CUDA version sums with float atomics.

With ``segments`` (ops/segments.py: per covariate, the cells grouped by
level into batch-pure tiles) the moments and the correction take the
O(K·N·d) segmented path of ``harmony_tpu/ops/ridge.py:663-730``: gathers
into (tiles, T, ·) arrays and batched products. It is XLA in the JAX
package, so it is plain PyTorch here, on the card too; the K4/K5 kernels
do not run where segments are given (``harmony_tpu/ops/ridge.py:105-110``).

On a mesh (``mesh``, a ``sharding.CellMesh``; harmony_tpu/ops/ridge.py:86,
396-547) the arrays with a cell axis are the rank's columns: K8 and K9 run
on the rank's layout tiles (``cuda_ridge.sharded_tile_moments``, one
all-reduce of the moment table, and ``sharded_tiled_correction``), the
mixed tail's moments are the rank's part of the tail summed by one more
all-reduce, and the ridge solve runs replicated on every rank from the
summed moments. The dense and segmented M-steps take the rank's columns
as they are (``cells`` and ``segments`` are the rank's,
``engine.mstep_layout(mesh=)``): K4 sums its moments
(``cuda_ridge.sharded_moments``) and the plain contractions theirs, one
all-reduce of the (K, B, d+1) moments and the cross blocks before the
masks, and K5 or the plain correction writes the rank's columns with no
collective, as the JAX package partitions its XLA M-step
(harmony_tpu/ops/ridge.py:105-110).

Under virtual R (``virtual``, a :class:`~harmony_tpu_torch.ops.rotate.VirtualR`;
harmony_tpu/ops/ridge.py:145-154, 550-654) the state's R is stale: the
moments come fused from the E-step's final round, the tail's assignments
are recomputed from the penalty tables in plain PyTorch, and K10 applies
the correction with R recomputed per pure tile from the tables and the
phase's Gram table.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import graphs
from ..config import HarmonyConfig
from .normalize import l2_normalize_columns

_F32 = torch.float32


def _covariate_of_batch(cfg: HarmonyConfig, device) -> torch.Tensor:
    """(B,) covariate id of each global batch row (src/harmony.cpp:96-97)."""
    ids = [c for c, b in enumerate(cfg.B_vec) for _ in range(b)]
    return graphs.device_table(ids, np.int64, device)


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
    tiled=None,  # ops.tiled.TiledCells -> the batch-tiled O(K N d) path
    segments=None,  # tuple of ops.segments.CovariateSegments -> segmented path
    tiled_moments=None,  # (n_joint+1, K, d+1) table the E-step fused (K3, K7)
    virtual=None,  # ops.rotate.VirtualR: R is stale, recompute it (needs tiled)
    cells=None,  # ops.cuda_ridge.CellIndex of codes[0]: K4/K5 visit cells by batch
    mesh=None,  # sharding.CellMesh: cell arrays are the rank's columns
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (Z_corr, Y_new, W); W is (K, B+1, d) with intercept rows zeroed.
    Z_corr is recomputed from Z_orig (src/harmony.cpp:347). With ``tiled``,
    ``tiled_moments`` hands over the per-joint moment table of R that the
    E-step's last round accumulated, and K8's pass never runs
    (harmony_tpu/ops/ridge.py:404-417). ``virtual`` (with ``tiled`` and
    ``tiled_moments``) corrects without reading R. ``cells`` is the run's
    per-tile batch index of the codes that the K4/K5 branch hands to both
    kernels (they build one for the call without it). ``mesh`` runs the
    M-step on the rank's cells (module docstring)."""
    K, B = cfg.K, cfg.B
    dev = Z_orig.device
    keep, any_active = compute_masks(cfg, O, batch_sizes)
    keepf = keep.to(_F32)
    use_kernel = (cfg.mstep_impl == "kernel" and cfg.n_covariates == 1
                  and tiled is None and segments is None)
    # moments and solve in float32 (harmony_tpu/ops/ridge.py:103-112); under
    # virtual R only the mixed/pad tail is read here (K10 reads Z_orig in
    # its storage dtype), so no float32 copy of the whole Z_orig is made
    Zf = Z_orig if virtual is not None else Z_orig.to(_F32).contiguous()
    cross_blocks: Dict[Tuple[int, int], torch.Tensor] = {}

    if tiled is not None:
        # raw R, keep-masked moments: a cell is kept iff ANY of its batches
        # is, and every cell of a kept batch is kept, so kept batches'
        # blocks equal their raw-R values; only the intercept moments see
        # the union cell mask, constant within a joint level
        # (harmony_tpu/ops/ridge.py:130-211)
        R_eff = None if virtual is not None else R.to(_F32).contiguous()
        n_pure = _pure_end(cfg, tiled, mesh)
        tail_R = (None if virtual is None
                  else _virtual_tail_r(cfg, virtual, n_pure, mesh))
        O_all, rhs_all, cross_blocks, ctx = _moments_tiled(
            cfg, R_eff, Zf, codes, tiled, tiled_moments, tail_R, mesh
        )
        O_eff = O_all * keepf
        rhs_batches = rhs_all * keepf[:, :, None]
        if cfg.n_covariates == 1:
            r_tot = O_eff.sum(dim=1)
            rhs0 = rhs_batches.sum(dim=1)
        else:
            r_tot, rhs0 = _intercept_moments_tiled(cfg, keep, Zf, codes, tiled, ctx, mesh)
    elif use_kernel:
        from .cuda_ridge import moments, sharded_moments

        Rf = R.to(_F32).contiguous()
        M = (moments(Rf, Zf, codes[0].contiguous(), B, cells) if mesh is None
             else sharded_moments(mesh, Rf, Zf, codes[0].contiguous(), B, cells))  # (K, B, d+1)
        O_eff = M[:, :, -1] * keepf
        rhs_batches = M[:, :, :-1] * keepf[:, :, None]
        r_tot = O_eff.sum(dim=1)
        rhs0 = rhs_batches.sum(dim=1)
    elif cfg.n_covariates == 1:
        # keep-masking the moments is the cell mask (see module docstring)
        R_eff = R.to(_F32)
        if segments is None:
            O_all, rhs_all, _, onehots = _moments_dense(cfg, R_eff, Zf, codes, onehots)
        else:
            O_all, rhs_all, _, R_s = _moments_segmented(cfg, R_eff, Zf, codes, segments)
        O_all, rhs_all, _ = _sum_over_ranks(mesh, O_all, rhs_all, {})
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
        if segments is None:
            O_eff, rhs_batches, cross_blocks, onehots = _moments_dense(
                cfg, R_eff, Zf, codes, onehots
            )
        else:
            O_eff, rhs_batches, cross_blocks, R_s = _moments_segmented(
                cfg, R_eff, Zf, codes, segments
            )
        O_eff, rhs_batches, cross_blocks = _sum_over_ranks(mesh, O_eff, rhs_batches,
                                                           cross_blocks)
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
    # skipped clusters keep their centroid. Y is kept row-major, as the
    # state's other buffers and the graph route's static copies are: a
    # product that reads Y then takes the same cuBLAS kernel in the host
    # loop as in a captured iteration (a transposed Y gave the cell-granular
    # round other bits on the card)
    Y_new = torch.where(any_active[None, :], W[:, 0, :].t().to(Y_old.dtype), Y_old)
    Y_new = l2_normalize_columns(Y_new).contiguous()
    W = W.clone()
    W[:, 0, :] = 0.0

    # ---- Correction: Z_corr = Z_orig - sum_k W_k^T Phi_Rk ----------------
    if virtual is not None:
        Z_corr = _correction_virtual(cfg, W, ctx, tiled, virtual, mesh)
        return Z_corr.to(Z_orig.dtype), Y_new, W
    if tiled is not None:
        Z_corr = _correction_tiled(cfg, W, R_eff, Zf, ctx, tiled, mesh)
        return Z_corr.to(Z_orig.dtype), Y_new, W
    if use_kernel:
        from .cuda_ridge import correction

        # on a mesh K5 on the rank's columns with their index: no collective
        Z_corr = correction(W[:, 1:, :].contiguous(), Rf, Zf, codes[0].contiguous(), cells)
        return Z_corr.to(Z_orig.dtype), Y_new, W
    if segments is None:
        corr = _correction_dense(cfg, W, R_eff, onehots)
    else:
        corr = _correction_segmented(cfg, W, R_s, segments)
    return (Zf - corr).to(Z_orig.dtype), Y_new, W


def _sum_over_ranks(mesh, O, rhs, cross):
    """The dense or segmented moments of the rank's cells summed over the
    ranks in one all-reduce (as given without a mesh): every rank then
    solves from the same sums."""
    if mesh is None:
        return O, rhs, cross
    from ..sharding import all_reduce_many

    keys = list(cross)
    red = all_reduce_many([O, rhs] + [cross[k] for k in keys], mesh)
    return red[0], red[1], dict(zip(keys, red[2:]))


def full_tile_joint(cfg: HarmonyConfig, tiled) -> np.ndarray:
    """(ceil(Np / tile),) layout tile -> joint id over the whole padded cell
    axis; mixed/pad tiles map to the trash slot n_joint
    (harmony_tpu/ops/ridge.py:384)."""
    n_joint = tiled.joint_codes.shape[1]
    tj = np.full(-(-cfg.Np // tiled.tile), n_joint, np.int32)
    tj[: len(tiled.tile_joint)] = tiled.tile_joint
    return tj


def _segment_sum(x: torch.Tensor, ids, n: int) -> torch.Tensor:
    """sum of the rows of x (m, ...) into n segments, as a one-hot product;
    ``ids`` a host array or a tensor."""
    if not isinstance(ids, torch.Tensor):
        ids = graphs.device_table(ids, np.int64, x.device)
    ids = ids.to(device=x.device, dtype=torch.int64)
    oh = torch.nn.functional.one_hot(ids, n).to(_F32).t()  # (n, m)
    return (oh @ x.reshape(x.shape[0], -1)).reshape((n,) + tuple(x.shape[1:]))


def _moments_segmented(cfg, R_eff, Zf, codes, segments):
    """Batch-pure tile products, O(K·N·d) (harmony_tpu/ops/ridge.py:663-709):
    per covariate, R and Z gathered into (nt, T, ·) tiles through the
    layout (the sentinel gathers an appended zero cell), one batched
    product per tile and segment sums over the tiles' levels; the cross
    blocks from the tiles of the first covariate against one-hots of the
    second. Returns (O_eff, rhs_batches, cross_blocks, the gathered R tiles
    of each covariate)."""
    Rt_p = torch.cat([R_eff.t(), R_eff.new_zeros((1, cfg.K))])  # (Np+1, K)
    Zt_p = torch.cat([Zf.t(), Zf.new_zeros((1, cfg.d))])  # (Np+1, d)
    O_parts, S_parts, R_s_all = [], [], []
    for c, seg in enumerate(segments):
        Bc = cfg.B_vec[c]
        R_s = Rt_p[seg.tile_cells]  # (nt, T, K)
        Z_s = Zt_p[seg.tile_cells]  # (nt, T, d)
        R_s_all.append(R_s)
        O_parts.append(_segment_sum(R_s.sum(dim=1), seg.tile_batch, Bc).t())  # (K, Bc)
        S_t = torch.bmm(R_s.transpose(1, 2), Z_s)  # (nt, K, d)
        S_parts.append(_segment_sum(S_t, seg.tile_batch, Bc).transpose(0, 1))
    cross_blocks: Dict[Tuple[int, int], torch.Tensor] = {}
    codes_p = torch.cat([codes, codes.new_zeros((codes.shape[0], 1))], dim=1).long()
    for c1 in range(cfg.n_covariates):
        seg = segments[c1]
        for c2 in range(c1 + 1, cfg.n_covariates):
            b1, b2 = cfg.B_vec[c1], cfg.B_vec[c2]
            oh2 = torch.nn.functional.one_hot(codes_p[c2][seg.tile_cells], b2).to(_F32)
            X_t = torch.bmm(R_s_all[c1].transpose(1, 2), oh2)  # (nt, K, b2)
            cross_blocks[(c1, c2)] = _segment_sum(X_t, seg.tile_batch, b1).transpose(0, 1)
    return (torch.cat(O_parts, dim=1), torch.cat(S_parts, dim=1), cross_blocks,
            R_s_all)


def _correction_segmented(cfg, W, R_s_all, segments):
    """corr (d, Np) from the gathered R tiles (harmony_tpu/ops/ridge.py:
    712-730): each tile's level's betas applied by one batched product,
    scattered back through each cell's tile slot (none for pad cells)."""
    corr = None
    for c, seg in enumerate(segments):
        o = cfg.covariate_offsets[c]
        Wc = W[:, 1 + o : 1 + o + cfg.B_vec[c], :].to(_F32)  # (K, Bc, d)
        W_t = Wc.index_select(1, seg.tile_batch).transpose(0, 1)  # (nt, K, d)
        corr_t = torch.bmm(R_s_all[c], W_t)  # (nt, T, d)
        nt, T = seg.tile_cells.shape
        corr_flat = torch.cat([corr_t.reshape(nt * T, cfg.d), corr_t.new_zeros((1, cfg.d))])
        t = corr_flat[seg.pos[:-1]]  # (Np, d)
        corr = t if corr is None else corr + t
    return corr.t()


def _pure_end(cfg, tiled, mesh) -> int:
    """Where the pure layout tiles end on the cell axis a call holds: the
    layout's ``n_pure``, or on a mesh its place in the rank's columns
    (0 where the rank holds only tail, the rank's length where only pure
    tiles)."""
    if mesh is None:
        return tiled.n_pure
    from ..sharding import cell_range

    lo, hi = cell_range(cfg, mesh)
    return min(max(tiled.n_pure - lo, 0), hi - lo)


def _moments_tiled(cfg, R_eff, Zf, codes, tiled, precomputed=None, tail_R=None, mesh=None):
    """Batch-tiled moments, O(K·N·d) (harmony_tpu/ops/ridge.py:396-488):
    the per-joint table from K8 over the layout tiles (or ``precomputed``,
    the table fused into the E-step), segment sums over joint levels, and
    dense one-hot products on the trailing mixed/pad region, whose R is
    ``tail_R`` where given (virtual R) and R_eff's otherwise. On a mesh K8
    runs on the rank's tiles with one all-reduce of the table, and the
    tail's products are the rank's part of the tail (maybe none), summed by
    one more all-reduce wherever the global axis has a tail. Returns
    (O_eff, rhs_batches, cross_blocks, (R_tail, tail one-hots, per-joint
    table, where the pure tiles end on the call's cell axis))."""
    from . import cuda_ridge

    K = cfg.K
    n_joint = tiled.joint_codes.shape[1]
    if precomputed is None:
        if R_eff is None:
            raise ValueError("virtual R needs the moments its final round fused")
        if mesh is None:
            moments = (cuda_ridge.tile_moments if cfg.mstep_impl == "kernel"
                       else cuda_ridge.tile_moments_twin)
            precomputed = moments(R_eff, Zf, tiled.tile, full_tile_joint(cfg, tiled), n_joint)
        else:
            precomputed = cuda_ridge.sharded_tile_moments(
                cfg, mesh, R_eff, Zf, tiled.tile, full_tile_joint(cfg, tiled), n_joint)
    seg = precomputed[:n_joint]  # (nj, K, d+1); the trash row dropped

    n_pure = _pure_end(cfg, tiled, mesh)
    # every rank takes part in the tail's all-reduce where the global axis
    # has a tail, with zeros where its own columns hold none of it
    tail = Zf.shape[1] - n_pure if mesh is None else cfg.Np - tiled.n_pure
    R_t = tail_oh = tail_M = None
    if tail:
        R_t = tail_R if tail_R is not None else R_eff[:, n_pure:]
        Z_t = Zf[:, n_pure:].to(_F32)
        Za_t = torch.cat([Z_t, Z_t.new_ones((1, Z_t.shape[1]))], dim=0)
        tail_oh = [
            torch.nn.functional.one_hot(codes[c, n_pure:].long(), b).to(_F32)
            for c, b in enumerate(cfg.B_vec)
        ]
        tail_M = [
            torch.stack([(R_t * oh[:, b]) @ Za_t.t() for b in range(oh.shape[1])], 1)
            for oh in tail_oh
        ]
    cross_t: Dict[Tuple[int, int], torch.Tensor] = {}
    if tail:
        for c1 in range(cfg.n_covariates):
            for c2 in range(c1 + 1, cfg.n_covariates):
                b1, b2 = cfg.B_vec[c1], cfg.B_vec[c2]
                joint_t = codes[c1, n_pure:].long() * b2 + codes[c2, n_pure:].long()
                ohj = torch.nn.functional.one_hot(joint_t, b1 * b2).to(_F32)
                cross_t[(c1, c2)] = (R_t @ ohj).reshape(K, b1, b2)
        if mesh is not None:
            from ..sharding import all_reduce_many

            keys = list(cross_t)
            red = all_reduce_many(tail_M + [cross_t[k] for k in keys], mesh)
            tail_M, cross_t = red[: len(tail_M)], dict(zip(keys, red[len(tail_M):]))
    O_parts, rhs_parts = [], []
    for c, b in enumerate(cfg.B_vec):
        Mc = _segment_sum(seg, tiled.joint_codes[c], b).transpose(0, 1)  # (K, b, d+1)
        if tail:
            Mc = Mc + tail_M[c]
        O_parts.append(Mc[:, :, -1])
        rhs_parts.append(Mc[:, :, :-1])
    cross_blocks: Dict[Tuple[int, int], torch.Tensor] = {}
    for c1 in range(cfg.n_covariates):
        for c2 in range(c1 + 1, cfg.n_covariates):
            b1, b2 = cfg.B_vec[c1], cfg.B_vec[c2]
            jidx = tiled.joint_codes[c1].astype(np.int64) * b2 + tiled.joint_codes[c2]
            cross = _segment_sum(seg[:, :, -1], jidx, b1 * b2).t().reshape(K, b1, b2)
            if tail:
                cross = cross + cross_t[(c1, c2)]
            cross_blocks[(c1, c2)] = cross
    return (torch.cat(O_parts, dim=1), torch.cat(rhs_parts, dim=1),
            cross_blocks, (R_t, tail_oh, seg, n_pure))


def _intercept_moments_tiled(cfg, keep, Zf, codes, tiled, ctx, mesh=None):
    """Several covariates: intercept moments under the union cell mask, at
    joint-level granularity on the pure tiles and per cell on the tail
    (harmony_tpu/ops/ridge.py:170-211); on a mesh the tail's part summed
    over the ranks."""
    seg = ctx[2]
    mask_j = None
    for c, off in enumerate(cfg.covariate_offsets):
        jc = graphs.device_table(tiled.joint_codes[c], np.int64, keep.device)
        kc = keep[:, off : off + cfg.B_vec[c]].index_select(1, jc)  # (K, nj)
        mask_j = kc if mask_j is None else (mask_j | kc)
    mj = mask_j.to(_F32).t()[:, :, None]  # (nj, K, 1)
    r_tot = (seg[:, :, -1:] * mj).sum(dim=0)[:, 0]
    rhs0 = (seg[:, :, :-1] * mj).sum(dim=0)
    n_pure = ctx[3]
    if ctx[0] is not None:
        mask_t = None
        for c, off in enumerate(cfg.covariate_offsets):
            kc = keep[:, off : off + cfg.B_vec[c]].index_select(1, codes[c, n_pure:].long())
            mask_t = kc if mask_t is None else (mask_t | kc)
        R_tm = ctx[0] * mask_t.to(_F32)
        r_t, rhs_t = R_tm.sum(dim=1), R_tm @ Zf[:, n_pure:].to(_F32).t()
        if mesh is not None:
            from ..sharding import all_reduce_many

            r_t, rhs_t = all_reduce_many([r_t, rhs_t], mesh)
        r_tot = r_tot + r_t
        rhs0 = rhs0 + rhs_t
    return r_tot, rhs0


def _joint_betas(cfg, W, tiled) -> torch.Tensor:
    """(n_joint + 1, d, K) per-joint betas, the sum over covariates of each
    one's beta block at the joint's level (a cell's correction sums over
    covariates, src/harmony.cpp:613-616); the trash row n_joint is zero."""
    W_joint = None
    for c, off in enumerate(cfg.covariate_offsets):
        jc = graphs.device_table(tiled.joint_codes[c], np.int64, W.device)
        Wc = W[:, 1 + off : 1 + off + cfg.B_vec[c], :].index_select(1, jc)  # (K, nj, d)
        W_joint = Wc if W_joint is None else W_joint + Wc
    W_joint = W_joint.permute(1, 2, 0).to(_F32)  # (nj, d, K)
    return torch.cat([W_joint, W_joint.new_zeros((1,) + W_joint.shape[1:])]).contiguous()


def _patch_tail(cfg, W, ctx, tiled, Z_corr):
    """The trailing mixed/pad region's correction, dense on its R (ctx)."""
    R_t, tail_oh = ctx[0], ctx[1]
    if R_t is None:
        return Z_corr
    corr_t = None
    for c, oh in enumerate(tail_oh):
        off = cfg.covariate_offsets[c]
        for b in range(oh.shape[1]):
            t = W[:, 1 + off + b, :].t() @ (R_t * oh[:, b])
            corr_t = t if corr_t is None else corr_t + t
    Z_corr[:, ctx[3]:] -= corr_t
    return Z_corr


def _correction_tiled(cfg, W, R_eff, Zf, ctx, tiled, mesh=None):
    """Batch-tiled correction (harmony_tpu/ops/ridge.py:491-547): K9 applies
    each pure tile's joint betas (on a mesh to the rank's tiles); the
    tail's correction is dense."""
    from . import cuda_ridge

    W_joint, tj = _joint_betas(cfg, W, tiled), full_tile_joint(cfg, tiled)
    if mesh is not None:
        Z_corr = cuda_ridge.sharded_tiled_correction(cfg, mesh, W_joint, tj, R_eff, Zf,
                                                     tiled.tile)
    else:
        correct = (cuda_ridge.tiled_correction if cfg.mstep_impl == "kernel"
                   else cuda_ridge.tiled_correction_twin)
        Z_corr = correct(W_joint, tj, R_eff, Zf, tiled.tile)
    return _patch_tail(cfg, W, ctx, tiled, Z_corr)


def _virtual_tail_r(cfg, virt, n_pure, mesh=None):
    """(K, tail) assignments of the trailing mixed/pad cells, recomputed
    from the final round's penalty tables in K7's op order of
    ``cfg.estep_variant`` (harmony_tpu/ops/ridge.py:550-585): pc sums the
    covariates' penalty rows in covariate order, zero on pad cells. On a
    mesh the tail's part in the rank's columns (``n_pure`` where the pure
    tiles end there), read through the rank's own block ids."""
    T = cfg.estep_sub_tile
    if mesh is None:
        Np, blkmap = cfg.Np, virt.blkmap
    else:
        from .rotate import local_blocks

        Np, blkmap = virt.Zn_pad.shape[1], local_blocks(mesh, virt.pen, virt.blkmap)
    Zn_t = virt.Zn_pad[:, n_pure:Np].to(_F32)
    tiles = torch.arange(n_pure, Np, device=Zn_t.device) // T
    blk = blkmap.long()[tiles]
    valid = (virt.codes_pad[0, n_pure:Np] >= 0).to(_F32)
    pc = None
    for c, off in enumerate(cfg.covariate_offsets):
        code = (virt.codes_pad[c, n_pure:Np].long() + off).clamp(0, cfg.B - 1)
        pcc = virt.pen[blk, :, code].t()  # (K, tail)
        pc = pcc if pc is None else pc + pcc
    pc = pc * valid[None, :]
    Yt = virt.Y.t().to(_F32)
    if cfg.bf16_products:
        # g as K7's rounds read it (K6's bf16 product form)
        from .rotate import bf16_operand

        Yt, Zn_t = bf16_operand(Yt), bf16_operand(Zn_t)
    g = Yt @ Zn_t
    sigma = virt.sigma.to(_F32)[:, None]
    if cfg.estep_variant == "legacy":
        e = torch.exp(-(2.0 * (1.0 - g)) / sigma)
        w = (e / e.sum(dim=0, keepdim=True)) * pc
    else:
        w = torch.exp((g - 1.0) * (2.0 / sigma)) * pc
    colsum = w.sum(dim=0, keepdim=True)
    return w * (1.0 / torch.where(colsum == 0.0, torch.ones_like(colsum), colsum))


def _correction_virtual(cfg, W, ctx, tiled, virt, mesh=None):
    """Correction with R recomputed from the penalty tables
    (harmony_tpu/ops/ridge.py:588-654): the pure layout tiles by
    :func:`virtual_tile_correction`, then the dense patch of the tail from
    its recomputed assignments (ctx carries them from _moments_tiled)."""
    Z_corr = virtual_tile_correction(cfg, _joint_betas(cfg, W, tiled),
                                     full_tile_joint(cfg, tiled), tiled.tile, virt, mesh)
    if mesh is None:
        Z_corr = Z_corr[:, : cfg.Np]
    return _patch_tail(cfg, W, ctx, tiled, Z_corr)


def virtual_tile_correction(cfg: HarmonyConfig, W_joint: torch.Tensor, tile_joint,
                            tile: int, virt, mesh=None) -> torch.Tensor:
    """Z_orig - W_joint[joint(tile)] R on the padded layout (d, Npt), R the
    final round's, recomputed from ``virt`` (a VirtualR): K10 where it
    reads the phase's Gram table ``virt.G`` and (on the card) takes the
    shape; else K11 writes R, from Y and Zn, and K9 applies it: a state
    without G (built from the JAX package's arrays) or K, d, B past K10's
    shared memory. Both give the same bits (K11's R is K7's; K10 and K9 run
    one fmaf order). On CPU tensors the kernels' plain versions. K10 reads
    Z_orig in its storage dtype and returns Z_corr in it; K11 and K9 run on
    float32 (a copy of a bf16 Z_orig) and return float32. On a mesh the
    same per rank, through the sharded wrappers: ``virt`` holds the rank's
    columns, its penalty tables and its map in global block ids, and
    ``tile_joint`` is the global table."""
    from . import cuda_ridge, cuda_rotate, rotate

    rargs = (virt.Y.to(_F32), virt.sigma.to(_F32), virt.pen, virt.blkmap, virt.Zn_pad,
             virt.codes_pad)
    d, L = virt.Zn_pad.shape
    if virt.G is not None and (not virt.Zn_pad.is_cuda
                               or cuda_rotate.k10_fits(cfg, d, L // tile, virt.Zn_pad.device)):
        if mesh is not None:
            return rotate.sharded_virtual_correction(cfg, mesh, W_joint, tile_joint, tile,
                                                     *rargs, virt.Z_orig_pad, virt.G,
                                                     fn=cuda_rotate.virtual_correction)
        return cuda_rotate.virtual_correction(cfg, W_joint, tile_joint, tile, *rargs,
                                              virt.Z_orig_pad, virt.G)
    Zo = virt.Z_orig_pad.to(_F32).contiguous()
    if mesh is not None:
        from ..sharding import shard_tile_table

        R = rotate.sharded_materialize_r(cfg, mesh, *rargs, fn=cuda_rotate.materialize_r)
        return cuda_ridge.tiled_correction(W_joint, shard_tile_table(cfg, mesh, tile_joint, tile),
                                           R, Zo, tile)
    R = cuda_rotate.materialize_r(cfg, *rargs)
    return cuda_ridge.tiled_correction(W_joint, tile_joint, R, Zo, tile)


def _solve_ridge(cfg: HarmonyConfig, G: torch.Tensor, rhs: torch.Tensor):
    """Batched solve of G W = rhs, G symmetric positive definite.

    'auto' mirrors the reference: the closed-form arrowhead inverse for one
    covariate (src/harmony.cpp:574-586), a general solve otherwise
    (``arma::inv``, src/harmony.cpp:572-573, here Cholesky). The batch of a
    G that is not positive definite (Cholesky) or singular (LU) gets NaN.
    """
    solver = cfg.ridge_solver
    if solver == "auto":
        solver = "arrowhead" if cfg.n_covariates == 1 else "cholesky"
    if solver == "arrowhead":
        if cfg.n_covariates != 1:
            raise ValueError("arrowhead solver requires a single covariate")
        return _arrowhead_solve(G, rhs)
    if solver == "solve":
        with _cusolver(G.device):
            W, info = torch.linalg.solve_ex(G, rhs, check_errors=False)
    elif solver == "cholesky":
        L, info = torch.linalg.cholesky_ex(G, check_errors=False)
        # cholesky_solve's two triangular solves, written out (the same bits
        # on the CPU): on the card torch runs them with cuBLAS's batched
        # trsm, which a CUDA graph captures, where its batched
        # cholesky_solve takes MAGMA, which allocates as it runs
        W = torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(L, rhs, upper=False), upper=True)
    else:
        raise ValueError(f"unknown ridge_solver {solver!r}")
    # a failed factorisation gives its batch NaN, as jnp.linalg.cholesky
    # does, on the device: the _ex forms make no host read, so the solve
    # can be captured into a CUDA graph
    return torch.where(info[:, None, None] != 0, torch.full_like(W, float("nan")), W)


@contextlib.contextmanager
def _cusolver(device):
    """On the card, torch's cuSOLVER/cuBLAS backend for the enclosed
    linear algebra: its default takes MAGMA for a batched LU solve, which a
    CUDA graph cannot capture. Nothing changes on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


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
