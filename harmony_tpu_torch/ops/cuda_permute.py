"""K2 and K3: the wrappers of the fused permute phase kernels.

Counterpart of ``harmony_tpu/ops/pallas_estep.py`` (``pallas_permute_phase``),
drop-ins for :mod:`harmony_tpu_torch.ops.permute_phase`, which holds their
plain versions. The CUDA source is ``csrc/permute_phase.cu``.

* :func:`permute_rounds` (K2): the phase's rounds. One head launch
  (:func:`phase_head`) writes the phase's distances G (N, K), one
  contiguous row per cell, which every round reads: Y and Z are fixed
  within the phase. Per round, one removal launch over the round's cells
  and, per block, an assign launch and a commit launch, with nothing in
  between (2 * n_blocks + 2 launches a round); the cell passes read each
  cell's row of G, its codes and its previous block id through the
  round's permutation, and the removal stores the new block ids. The
  penalty tables live as (n_blocks+1)·B rows of K floats, two of them
  swapped between rounds; the result hands them back as the
  (K, (n_blocks+1)·B) view the plain version carries.
* :func:`materialize` (K3): R (K, Np) in natural order, pad cells 0, and
  with a :class:`MomentsSpec` the joint-batch moment table over a plan of
  equal tile ranges, one a CTA (:func:`_k3_moments_plan`). It reads the
  distances from the head's G, which :func:`permute_rounds` hands on
  (``RoundsResult.G``), so its R is the last round's R bit for bit; G
  lives until K3 has run.

For CPU tensors each wrapper runs its plain version; any other device,
dtype or shape raises. ``launches`` counts calls into a kernel's C entry
points (the head is K2's).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build, graphs
from ..config import HarmonyConfig
from . import permute_phase as twin
from .cuda_estep import _sm_count
from .cuda_ridge import sum_joint_rows
from .cuda_rotate import _offsets_on
from .permute_phase import MomentsSpec, PermutePhaseResult, PhaseTables, RoundsResult

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_SMEM_SM = 233_472  # bytes of shared memory an SM holds, 1,024 of them reserved a CTA
_WARPS = 8  # kWarps in permute_phase.cu
_THREADS = 256
_K3_THREADS = 512  # kK3Threads: a K3 CTA
_MR, _ME = 4, 8  # kMR x kME: the (cluster x dim) register tile of K3's moment tail
_K3_GROUPS = 4  # the most groups of K3 threads that split a step's cells for the moments
_CHUNK = 256  # kChunk: cells whose ids and codes a cell-pass CTA stages at once
_RING = 4  # kRing: rows of G a cell-pass warp holds in shared memory
_MAX_KJ_K = 256  # the register chain: a lane holds up to 8 of a cell's K values
_SIGNATURES = {
    "k2_occupancy": [_build.INT] * 5,
    "k2_head": [_build.PTR] * 3 + [_build.I64, _build.I64] + [_build.INT] * 5 + [_build.PTR],
    "k2_cells": [_build.INT] * 2 + [_build.PTR] * 7 + [_build.INT] * 12 + [_build.PTR],
    "k2_commit": [_build.PTR, _build.INT, _build.PTR, _build.INT, _build.INT]
    + [_build.PTR] * 5 + [_build.INT, _build.PTR] + [_build.INT] * 4 + [_build.PTR],
    "k3_occupancy": [_build.INT] * 3,
    "k3_materialize": [_build.PTR] * 10 + [_build.I64, _build.I64] + [_build.INT] * 12
    + [_build.PTR],
}


def head_smem_bytes(K: int, d: int, T: int) -> int:
    """Shared memory of one head CTA (layout in the .cu)."""
    return 4 * (K * d + d * (T + 1) + K * (T + 1))


def cells_smem_bytes(K: int, B: int, ncov: int, warps: int, shared: bool) -> int:
    """Shared memory of one K2 cell-pass CTA of ``warps`` warps, with a
    (B x K) batch-sum table a warp and the assign pass's table rows, or
    (``shared``) one table a CTA and two rows of K a warp (layout in the
    .cu)."""
    if shared:
        floats = B * K + warps * (K + 2 + _RING * K + 2 * K)
    else:
        floats = warps * (B * K + K + 2 + _RING * K) + B * K
    return 4 * (floats + _CHUNK * (ncov + 2))


def moment_tiles(K: int, d: int) -> int:
    """K3's register tiles of the (K x d+1) moment table, kMR x kME each."""
    return -(-K // _MR) * -(-(d + 1) // _ME)


def moment_groups(K: int, d: int) -> int:
    """Groups of K3 threads that split a step's cells for the moment tail,
    each with one tile a thread and a partials row of its own."""
    return max(1, min(_K3_GROUPS, _K3_THREADS // moment_tiles(K, d)))


def _kr(K: int) -> int:
    """Row stride of K3's cell-major R: whole kMR tiles, off multiples of 32."""
    n = _MR * -(-K // _MR)
    return n + 4 if n % 32 == 0 else n


def _d1p(d: int) -> int:
    """Rows of K3's dim-major [Z_orig; 1] stage: whole kME tiles."""
    return _ME * -(-(d + 1) // _ME)


def materialize_smem_bytes(K: int, d: int, ncov: int, T: int, moments: bool,
                           span: int = 0) -> int:
    """Shared memory of one K3 CTA at T cells a step (layout in the .cu):
    two steps' rows of G and two of R cluster-major; with moments two of R
    cell-major, three of [Z_orig; 1] dim-major (rows of T + 4), and the
    CTA's plan of ``span`` tiles; two steps' codes and block ids."""
    floats = 2 * T * K + 2 * (-(-K * (T + 1) // 4) * 4)
    ints = 2 * ncov * T + 2 * T
    if moments:
        floats += 2 * T * _kr(K) + 3 * _d1p(d) * (T + 4)
        ints += 2 * span  # the CTA's plan: tile ids and segments
    return 4 * (floats + ints)


def materialize_tile(K: int, d: int, ncov: int, moments: bool) -> int:
    """Cells of a K3 step: 64, or 32 or 16 where 64 does not fit."""
    for T in (64, 32, 16):
        if materialize_smem_bytes(K, d, ncov, T, moments) <= _SMEM_MAX:
            return T
    raise ValueError(
        f"materialize: K={K}, d={d}, {ncov} covariate(s) need "
        f"{materialize_smem_bytes(K, d, ncov, 16, moments)} bytes of shared memory at 16 "
        f"cells a step, over the {_SMEM_MAX} a CTA may use"
    )


def cell_tile(K: int, d: int, B: int, ncov: int) -> int:
    """Cells per staged tile of the head: 64, or 32 where 64 does not
    fit."""
    for T in (64, 32):
        if head_smem_bytes(K, d, T) <= _SMEM_MAX:
            return T
    raise ValueError(
        f"permute phase kernels: K={K}, d={d}, B={B}, {ncov} covariate(s) need more "
        f"than the {_SMEM_MAX} bytes of shared memory a CTA may use at 32 cells"
    )


def cell_layout(K: int, B: int, ncov: int) -> Tuple[int, bool]:
    """(warps, shared) of a K2 cell-pass CTA: 8 warps with a (B x K)
    batch-sum table each where K <= 256 and two such CTAs fit on an SM
    (B <= 26 at K = 100); else one table a CTA (``shared``), with the most
    warps, up to 8, that fit."""
    if K <= _MAX_KJ_K and 2 * (cells_smem_bytes(K, B, ncov, _WARPS, False) + 1024) <= _SMEM_SM:
        return _WARPS, False
    for w in range(_WARPS, 0, -1):
        if cells_smem_bytes(K, B, ncov, w, True) <= _SMEM_MAX:
            return w, True
    raise ValueError(f"K2: K={K}, B={B} need {cells_smem_bytes(K, B, ncov, 1, True)} bytes "
                     f"of shared memory for one (B x K) table of batch sums, over the "
                     f"{_SMEM_MAX} a CTA may use")


def moments_fit(K: int, d: int) -> bool:
    """Does K3's moment fusion hold a (K x d+1) table in its register
    tiles, one a thread in one pass?"""
    return moment_tiles(K, d) <= _K3_THREADS


def _check(where: str, cfg: HarmonyConfig, floats: dict, codes: torch.Tensor) -> bool:
    """True for CUDA tensors that the kernels take, False for CPU tensors
    (the plain version runs); raises for anything else."""
    dev = codes.device
    for name, t in floats.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, codes on {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{where}: unsupported device {dev}")
    for name, t in floats.items():
        if t.dtype != _F32:
            raise TypeError(f"{where}: {name} must be float32, got {t.dtype}")
    if (codes.dtype != torch.int32 or codes.shape != (cfg.n_covariates, cfg.Np)
            or not codes.is_contiguous()):
        raise TypeError(f"{where}: codes must be a contiguous (ncov, Np) int32 tensor")
    Z = floats["Z"]
    if Z.shape != (cfg.d, cfg.Np) or floats["Y"].shape != (cfg.d, cfg.K):
        raise ValueError(f"{where}: Z {tuple(Z.shape)} and Y {tuple(floats['Y'].shape)} "
                         f"disagree with the config (d={cfg.d}, K={cfg.K}, Np={cfg.Np})")
    return True


class _Plan(NamedTuple):
    """Launch geometry of a phase (see :func:`_plan`)."""

    warps: int
    shared: bool  # one batch-sum table a cell-pass CTA (cell_layout)
    smem: int  # bytes a cell-pass CTA
    span_rm: int  # positions a removal CTA covers
    cta_rm: int  # removal CTAs of a full block
    span: int  # positions an assign CTA covers
    cta: int  # assign CTAs of a full block
    head_grid: int


def _occupancy(lib, which: int, K: int, shared: bool, threads: int, smem: int) -> int:
    n = lib.k2_occupancy(which, K, int(shared), threads, smem)
    if n <= 0:
        raise RuntimeError(f"k2_occupancy: kernel {which} fits no CTA on an SM (CUDA error "
                           f"{-n})")
    return n


@functools.lru_cache(maxsize=16)
def _plan(K: int, d: int, B: int, ncov: int, cpb: int, nb: int, n_sm: int, T: int) -> _Plan:
    """The grids that fill the card: an assign launch covers a block in one
    even wave of the CTAs an SM holds (a warp at least one cell); the
    removal launch is one such wave over the whole round, each CTA looping
    over a span of one block, so the partials it writes stay few; the head
    is one wave of CTAs that loop over the tiles."""
    lib = _build.load("permute_phase", _SIGNATURES)
    warps, shared = cell_layout(K, B, ncov)
    smem = cells_smem_bytes(K, B, ncov, warps, shared)
    res_a = n_sm * _occupancy(lib, 2, K, shared, 32 * warps, smem)
    res_r = n_sm * _occupancy(lib, 1, K, shared, 32 * warps, smem)
    span = max(warps, -(-cpb // res_a))
    span_rm = max(warps, -(-cpb // max(1, res_r // nb)))
    head_grid = n_sm * _occupancy(lib, 0, K, False, _THREADS, head_smem_bytes(K, d, T))
    return _Plan(warps, shared, smem, span_rm, -(-cpb // span_rm), span, -(-cpb // span),
                 head_grid)


def phase_head(cfg: HarmonyConfig, Z: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """K2's head: the phase's distances G (N, K), G[n, k] = 2 (1 - Y[:, k]
    . Z[:, n]), with K3's product loop; the plain version on CPU tensors."""
    dev = Z.device
    if dev.type == "cpu":
        return twin.phase_head(cfg, Z, Y)
    if dev.type != "cuda" or Y.device != dev or Z.dtype != _F32 or Y.dtype != _F32:
        raise ValueError("phase_head: Z and Y must be float32 on one CUDA device")
    K, d, N, Np = cfg.K, cfg.d, cfg.N, cfg.Np
    if Z.shape != (d, Np) or Y.shape != (d, K):
        raise ValueError(f"phase_head: Z {tuple(Z.shape)} and Y {tuple(Y.shape)} disagree "
                         f"with the config (d={d}, K={K}, Np={Np})")
    T = cell_tile(K, d, cfg.B, cfg.n_covariates)
    plan = _plan(K, d, cfg.B, cfg.n_covariates, cfg.cells_per_block, cfg.n_blocks,
                 _sm_count(dev), T)
    G = torch.empty((N, K), dtype=_F32, device=dev)
    Yt, Zc = Y.t().contiguous(), Z.contiguous()  # held until the launch is queued
    lib = _build.load("permute_phase", _SIGNATURES)
    _build.check(lib.k2_head(
        Yt.data_ptr(), Zc.data_ptr(), G.data_ptr(), N, Np, K, d,
        T, min(plan.head_grid, -(-N // T)), head_smem_bytes(K, d, T),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "k2_head")
    graphs.count(permute_rounds)
    return G


def permute_rounds(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np) L2-normalised
    Y: torch.Tensor,  # (d, K)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,
    codes: torch.Tensor,  # (ncov, Np) int32
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    perms: torch.Tensor,  # (rounds, N)
) -> RoundsResult:
    """K2: the phase's head and rounds; the plain version on CPU tensors."""
    floats = {"Z": Z, "Y": Y, "E": E, "O": O, "Pr_b": Pr_b, "sigma": sigma, "theta": theta}
    if not _check("permute_rounds", cfg, floats, codes):
        return twin.permute_rounds(cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms)
    K, B, ncov, nb = cfg.K, cfg.B, cfg.n_covariates, cfg.n_blocks
    N, Np, dev = cfg.N, cfg.Np, Z.device
    if E.shape != (K, B) or O.shape != (K, B) or perms.shape[1:] != (N,):
        raise ValueError("permute_rounds: E/O or perms disagree with the config")
    rounds = perms.shape[0]
    cpb, last = cfg.cells_per_block, cfg.last_block_size
    plan = _plan(K, cfg.d, B, ncov, cpb, nb, _sm_count(dev),
                 cell_tile(K, cfg.d, B, ncov))
    grid0 = (nb - 1) * plan.cta_rm + -(-last // plan.span_rm)
    P = K + K * B + 2

    G = phase_head(cfg, Z, Y)
    perms = torch.as_tensor(perms, device=dev).to(torch.int64).contiguous()
    off = _offsets_on(cfg.covariate_offsets, str(dev))
    gn = (codes + off[:, None]).t().contiguous()  # (Np, ncov) global batch rows
    sig, Pr, th = sigma.contiguous(), Pr_b.contiguous(), theta.contiguous()
    pens = [torch.ones(((nb + 1) * B, K), dtype=_F32, device=dev) for _ in range(2)]
    blk_nat = torch.full((Np,), nb, dtype=torch.int32, device=dev)
    E_w, O_w = E.contiguous().clone(), O.contiguous().clone()
    E_st = torch.empty((rounds, K, B), dtype=_F32, device=dev)
    O_st = torch.empty_like(E_st)
    acc = torch.zeros((rounds, 2), dtype=_F32, device=dev)
    part0 = torch.empty((grid0, P), dtype=_F32, device=dev)
    part1 = torch.empty((-(-max(cpb, last, 1) // plan.span), P), dtype=_F32, device=dev)
    lib = _build.load("permute_phase", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the launches' pointer arguments, read once: a round issues 2 * nb + 2
    # launches, and the host builds each one
    p_G, p_gn, p_blk, p_sig = G.data_ptr(), gn.data_ptr(), blk_nat.data_ptr(), sig.data_ptr()
    p_part = (part0.data_ptr(), part1.data_ptr())  # the removal's, the assign's
    c_tail = (E_w.data_ptr(), O_w.data_ptr(), Pr.data_ptr(), th.data_ptr())
    p_pens = [t.data_ptr() for t in pens]
    p_acc = [acc[r].data_ptr() for r in range(rounds)]
    threads = 32 * plan.warps
    issued = 0  # the launches, counted in one add after the rounds

    def cells(assign, p_perm, p_pen, grid, cta_per, span, first):
        nonlocal issued
        _build.check(lib.k2_cells(
            assign, int(plan.shared), p_G, p_perm, p_gn, p_blk, p_pen, p_sig, p_part[assign], grid,
            threads, cpb, last, nb, cta_per, span, first, K, B, ncov, plan.smem, stream,
        ), "k2_cells")
        issued += 1

    def commit(n1, rm, p_pen, store_row, p_acc_r):
        nonlocal issued
        rm_first, rm_n = 0, 0
        if rm >= 0:
            size = cpb if rm < nb - 1 else last
            rm_first, rm_n = rm * plan.cta_rm, -(-size // plan.span_rm)
        _build.check(lib.k2_commit(
            p_part[1], n1, p_part[0], rm_first, rm_n, *c_tail, p_pen, store_row, p_acc_r,
            K, B, int(n1 >= 0), int(rm >= 0), stream,
        ), "k2_commit")
        issued += 1

    for r in range(rounds):
        p_perm = perms[r].data_ptr()
        pen_prev, pen_new = p_pens[r % 2], p_pens[(r + 1) % 2]
        # the removal also stores each cell's block id of this round
        cells(0, p_perm, pen_prev, grid0, plan.cta_rm, plan.span_rm, 0)
        commit(-1, 0, pen_new, 0, p_acc[r])
        for i in range(nb):
            size = cpb if i < nb - 1 else last
            n1 = -(-size // plan.span)
            if n1:  # a tiny block_size can leave blocks empty; a 0-CTA launch is refused
                cells(1, p_perm, pen_new, n1, plan.cta, plan.span, i * plan.cta)
            commit(n1, i + 1 if i + 1 < nb else -1, pen_new,
                   i + 1 if i + 1 < nb else -1, p_acc[r])
        E_st[r].copy_(E_w)
        O_st[r].copy_(O_w)
    # where the rounds' launches were issued (a captured phase adds them on
    # the device once, not once a launch)
    graphs.count(permute_rounds, issued)
    return RoundsResult(
        E=E_w, O=O_w, E_rounds=E_st, O_rounds=O_st, kmeans_error=acc[:, 0],
        entropy=acc[:, 1],
        tables=PhaseTables(pen=pens[rounds % 2].t(), blk=blk_nat), G=G,
    )


permute_rounds.launches = 0


@graphs.device_cache(maxsize=4)
def _k3_moments_plan(tj_bytes: bytes, n_joint: int, device: str, groups: int, ctas: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """K3's work with moments: the layout tiles, joint by joint (ascending
    within a joint), cut into ``ctas`` ranges of equal length, one a CTA,
    and each range again where the joint changes; a segment adds into a
    partials row a cell group. Returns (plan (ctas, 2, span) int32: a
    range's tile ids, then each one's segment, -1 past the range; the
    first row of each joint (n_joint + 2,); span; rows), on the card once
    per table."""
    tj = np.frombuffer(tj_bytes, dtype=np.int32)
    order = np.argsort(tj, kind="stable").astype(np.int32)
    joint = tj[order]
    n = len(order)
    bounds = np.arange(ctas + 1, dtype=np.int64) * n // ctas
    new = np.zeros(n, bool)
    new[bounds[:-1][bounds[:-1] < n]] = True
    new[1:] |= joint[1:] != joint[:-1]
    seg = (np.cumsum(new) - 1).astype(np.int32)
    span = max(1, int(np.diff(bounds).max()))
    plan = np.full((ctas, 2, span), -1, np.int32)
    for b in range(ctas):
        lo, hi = bounds[b], bounds[b + 1]
        plan[b, 0, : hi - lo] = order[lo:hi]
        plan[b, 1, : hi - lo] = seg[lo:hi]
    start = groups * np.searchsorted(joint[new], np.arange(n_joint + 2))
    return (torch.as_tensor(plan, device=device),
            torch.as_tensor(start.astype(np.int32), device=device), span,
            groups * int(new.sum()))


@functools.lru_cache(maxsize=16)
def _k3_grid(moments: bool, K: int, smem: int, n_sm: int) -> int:
    """The CTAs of K3 the card holds at once."""
    lib = _build.load("permute_phase", _SIGNATURES)
    n = lib.k3_occupancy(int(moments), K, smem)
    if n <= 0:
        raise RuntimeError(f"k3_occupancy: K3 fits no CTA on an SM (CUDA error {-n})")
    return n_sm * n


def materialize(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np)
    Y: torch.Tensor,  # (d, K)
    codes: torch.Tensor,  # (ncov, Np) int32
    sigma: torch.Tensor,  # (K,)
    tables: PhaseTables,
    moments: Optional[MomentsSpec] = None,
    G: Optional[torch.Tensor] = None,  # (N, K) the phase's distances (K2's head)
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3: the final R (K, Np) and, with ``moments``, the (n_joint+1, K,
    d+1) moment table, from the phase's distances G; the plain version on
    CPU tensors (which forms them from Y and Z when G is None)."""
    floats = {"Z": Z, "Y": Y, "sigma": sigma, "pen": tables.pen}
    if G is not None:
        floats["G"] = G
    if moments is not None:
        floats["Z_orig"] = moments.Z_orig
    if not _check("materialize", cfg, floats, codes):
        return twin.materialize(cfg, Z, Y, codes, sigma, tables, moments, G)
    K, d, B, ncov, nb = cfg.K, cfg.d, cfg.B, cfg.n_covariates, cfg.n_blocks
    N, Np, dev = cfg.N, cfg.Np, Z.device
    if G is None or G.shape != (N, K) or not G.is_contiguous():
        raise ValueError(f"materialize: the kernel reads the phase's distances G, a "
                         f"contiguous float32 ({N}, {K}) tensor on {dev} (permute_rounds "
                         f"returns it), got {None if G is None else tuple(G.shape)}")
    if tables.pen.shape != (K, (nb + 1) * B) or tables.blk.shape != (Np,):
        raise ValueError("materialize: the phase tables disagree with the config")
    mom = moments is not None
    if mom and not moments_fit(K, d):
        raise ValueError(f"materialize: K={K}, d={d} give {moment_tiles(K, d)} register "
                         f"tiles of the moments, over the {_K3_THREADS} threads of a CTA")
    T = materialize_tile(K, d, ncov, mom)
    smem = materialize_smem_bytes(K, d, ncov, T, mom)
    pen_rows = tables.pen.t().contiguous()  # (nbp*B, K); a view of K2's tables
    blk = tables.blk.to(torch.int32).contiguous()
    sig = sigma.contiguous()
    R = torch.empty((K, Np), dtype=_F32, device=dev)
    lib = _build.load("permute_phase", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    off = _offsets_on(cfg.covariate_offsets, str(dev))
    M, groups = None, 1
    if not mom:
        grid = min(-(-Np // T), _k3_grid(False, K, smem, _sm_count(dev)))
        span, tw = 0, T
        ptrs = (None, None, None)
    else:
        tj = np.asarray(moments.tile_joint, dtype=np.int32)
        nj, tw = int(moments.n_joint), int(moments.tile)
        if (moments.Z_orig.shape != (d, Np) or tj.shape != (-(-Np // tw),)
                or tj.max(initial=0) > nj):
            raise ValueError("materialize: the moments spec disagrees with the config")
        groups = moment_groups(K, d)
        # a CTA a range, one wave: the ranges are at most ceil(tiles / SMs) long
        n_sm = _sm_count(dev)
        smem = materialize_smem_bytes(K, d, ncov, T, True, -(-len(tj) // n_sm))
        if smem > _SMEM_MAX:
            raise ValueError(f"materialize: the moments' plan of {len(tj)} tiles needs "
                             f"{smem} bytes of shared memory a CTA, over {_SMEM_MAX}")
        grid = _k3_grid(True, K, smem, n_sm)
        plan, start, span, rows = _k3_moments_plan(tj.tobytes(), nj, str(dev), groups, grid)
        Zo = moments.Z_orig.contiguous()
        part = torch.empty((rows, K, d + 1), dtype=_F32, device=dev)
        M = torch.empty((nj + 1, K, d + 1), dtype=_F32, device=dev)
        ptrs = (Zo, plan, part)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(lib.k3_materialize(
        G.data_ptr(), codes.data_ptr(), off.data_ptr(), blk.data_ptr(), pen_rows.data_ptr(),
        sig.data_ptr(), R.data_ptr(), *[ptr(t) for t in ptrs], Np, N, K, d, B, ncov, T,
        grid, span, tw, _kr(K), _d1p(d), groups, smem, stream,
    ), "k3_materialize")
    if M is not None:
        sum_joint_rows(part, start, M)
    graphs.count(materialize)
    return R, M


materialize.launches = 0


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
    """The fused phase through K2 and K3 (their plain versions on CPU)."""
    Zf = Z.to(_F32).contiguous()
    rr = permute_rounds(cfg, Zf, Y.to(_F32), E.to(_F32), O.to(_F32), codes, Pr_b.to(_F32),
                        sigma.to(_F32), theta.to(_F32), perms)
    R, M = materialize(cfg, Zf, Y.to(_F32), codes, sigma.to(_F32), rr.tables, moments, G=rr.G)
    return PermutePhaseResult(R=R, E=rr.E, O=rr.O, E_rounds=rr.E_rounds,
                              O_rounds=rr.O_rounds, kmeans_error=rr.kmeans_error,
                              entropy=rr.entropy, M=M)
