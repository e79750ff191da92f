"""K2 and K3: the wrappers of the fused permute phase kernels.

Counterpart of ``harmony_tpu/ops/pallas_estep.py`` (``pallas_permute_phase``),
drop-ins for :mod:`harmony_tpu_torch.ops.permute_phase`, which holds their
plain versions. The CUDA source is ``csrc/permute_phase.cu``.

* :func:`permute_rounds` (K2): the phase's rounds. Per round PyTorch
  gathers the cells into block order from cell-major tables (one
  contiguous row per cell) and scatters the new block ids; then one
  removal launch over the round's cells and, per block, an assign launch
  and a commit launch, with nothing in between (2 * n_blocks + 2 launches
  a round). The penalty tables live as (n_blocks+1)·B rows of K floats,
  two of them swapped between rounds; the result hands them back as the
  (K, (n_blocks+1)·B) view the plain version carries.
* :func:`materialize` (K3): R (K, Np) in natural order, pad cells 0, and
  with a :class:`MomentsSpec` the joint-batch moment table over K8's chunk
  plan.

For CPU tensors each wrapper runs its plain version; any other device,
dtype or shape raises. ``launches`` counts calls into a kernel's C entry
points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..config import HarmonyConfig
from . import permute_phase as twin
from .cuda_ridge import _CHUNK_TILES, _ceil4, _moments_plan, sum_joint_rows
from .cuda_rotate import _offsets_on
from .permute_phase import MomentsSpec, PermutePhaseResult, PhaseTables, RoundsResult

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_WARPS = 8  # kWarps in permute_phase.cu
_MAX_MT = 2  # kMaxMT in permute_phase.cu
_THREADS = 256
_REMOVE_TILES = 4  # cell tiles a removal CTA covers (nsub)
_SIGNATURES = {
    "k2_cells": [_build.INT] + [_build.PTR] * 7 + [_build.INT] * 13 + [_build.PTR],
    "k2_commit": [_build.PTR, _build.INT, _build.PTR, _build.INT, _build.INT]
    + [_build.PTR] * 5 + [_build.INT, _build.PTR] + [_build.INT] * 4 + [_build.PTR],
    "k3_materialize": [_build.PTR] * 11 + [_build.I64, _build.I64] + [_build.INT] * 10
    + [_build.PTR],
}


def cells_smem_bytes(K: int, d: int, B: int, ncov: int, T: int) -> int:
    """Shared memory of one K2 cell-pass CTA (layout in the .cu)."""
    floats = K * d + d * (T + 1) + K * (T + 1) + K + K * B + K + 2 * _WARPS
    return 4 * (floats + ncov * T + T)


def materialize_smem_bytes(K: int, d: int, ncov: int, T: int, moments: bool) -> int:
    """Shared memory of one K3 CTA (layout in the .cu)."""
    K4 = -(-K // 4) * 4
    floats = (T * _ceil4(d + 1) if moments else 0) + K * d + d * (T + 1) + K4 * (T + 1) + K
    return 4 * (floats + ncov * T + T)


def cell_tile(K: int, d: int, B: int, ncov: int) -> int:
    """Cells per staged tile: 64, or 32 where 64 does not fit."""
    for T in (64, 32):
        if max(cells_smem_bytes(K, d, B, ncov, T),
               materialize_smem_bytes(K, d, ncov, T, True)) <= _SMEM_MAX:
            return T
    raise ValueError(
        f"permute phase kernels: K={K}, d={d}, B={B}, {ncov} covariate(s) need more "
        f"than the {_SMEM_MAX} bytes of shared memory a CTA may use at 32 cells"
    )


def moments_fit(K: int, d: int) -> bool:
    """Does K3's moment fusion hold a (K x d+1) table in its register tiles?"""
    return -(-K // 4) * -(-(d + 1) // 4) <= _MAX_MT * _THREADS


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
    """K2: the phase's rounds; the plain version on CPU tensors."""
    floats = {"Z": Z, "Y": Y, "E": E, "O": O, "Pr_b": Pr_b, "sigma": sigma, "theta": theta}
    if not _check("permute_rounds", cfg, floats, codes):
        return twin.permute_rounds(cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms)
    K, d, B, ncov, nb = cfg.K, cfg.d, cfg.B, cfg.n_covariates, cfg.n_blocks
    N, Np, dev = cfg.N, cfg.Np, Z.device
    if E.shape != (K, B) or O.shape != (K, B) or perms.shape[1:] != (N,):
        raise ValueError("permute_rounds: E/O or perms disagree with the config")
    rounds = perms.shape[0]
    T = cell_tile(K, d, B, ncov)
    smem = cells_smem_bytes(K, d, B, ncov, T)
    cpb, last = cfg.cells_per_block, cfg.last_block_size
    span0 = T * _REMOVE_TILES
    cta0 = -(-cpb // span0)  # removal CTAs of a full block
    grid0 = (nb - 1) * cta0 + -(-last // span0)
    cta1 = -(-cpb // T)
    P = K + K * B + 2

    off = _offsets_on(cfg.covariate_offsets, str(dev))
    Zt = Z.t().contiguous()  # (Np, d): a gathered cell is one row
    gn = (codes + off[:, None]).t().contiguous()  # (Np, ncov) global batch rows
    Yt = Y.t().contiguous()
    sig, Pr, th = sigma.contiguous(), Pr_b.contiguous(), theta.contiguous()
    pens = [torch.ones(((nb + 1) * B, K), dtype=_F32, device=dev) for _ in range(2)]
    blk_nat = torch.full((Np,), nb, dtype=torch.int32, device=dev)
    slot_blk = twin.slot_blocks(cfg, dev).to(torch.int32)
    E_w, O_w = E.contiguous().clone(), O.contiguous().clone()
    E_st = torch.empty((rounds, K, B), dtype=_F32, device=dev)
    O_st = torch.empty_like(E_st)
    acc = torch.zeros((rounds, 2), dtype=_F32, device=dev)
    part0 = torch.empty((grid0, P), dtype=_F32, device=dev)
    part1 = torch.empty((max(cpb, last, 1) + T - 1) // T, P, dtype=_F32, device=dev)
    lib = _build.load("permute_phase", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def cells(assign, Zl, gl, bl, pen, part, grid, cta_per, nsub, first):
        _build.check(lib.k2_cells(
            assign, Yt.data_ptr(), Zl.data_ptr(), gl.data_ptr(), bl.data_ptr(),
            pen.data_ptr(), sig.data_ptr(), part.data_ptr(), grid, cpb, last, nb, cta_per,
            nsub, first, K, d, B, ncov, T, smem, stream,
        ), "k2_cells")
        permute_rounds.launches += 1

    def commit(n1, rm, pen, store_row, acc_r):
        rm_first, rm_n = 0, 0
        if rm >= 0:
            size = cpb if rm < nb - 1 else last
            rm_first, rm_n = rm * cta0, -(-size // span0)
        _build.check(lib.k2_commit(
            part1.data_ptr(), n1, part0.data_ptr(), rm_first, rm_n, E_w.data_ptr(),
            O_w.data_ptr(), Pr.data_ptr(), th.data_ptr(), pen.data_ptr(), store_row,
            acc_r.data_ptr(), K, B, int(n1 >= 0), int(rm >= 0), stream,
        ), "k2_commit")
        permute_rounds.launches += 1

    for r in range(rounds):
        perm = torch.as_tensor(perms[r], device=dev).long()
        Zl = Zt.index_select(0, perm)
        gl = gn.index_select(0, perm)
        bl = blk_nat.index_select(0, perm)
        blk_nat.index_copy_(0, perm, slot_blk)
        pen_prev, pen_new = pens[r % 2], pens[(r + 1) % 2]
        cells(0, Zl, gl, bl, pen_prev, part0, grid0, cta0, _REMOVE_TILES, 0)
        commit(-1, 0, pen_new, 0, acc[r])
        for i in range(nb):
            size = cpb if i < nb - 1 else last
            n1 = -(-size // T)
            if n1:  # a tiny block_size can leave blocks empty; a 0-CTA launch is refused
                cells(1, Zl, gl, bl, pen_new, part1, n1, cta1, 1, i * cta1)
            commit(n1, i + 1 if i + 1 < nb else -1, pen_new,
                   i + 1 if i + 1 < nb else -1, acc[r])
        E_st[r].copy_(E_w)
        O_st[r].copy_(O_w)
    return RoundsResult(
        E=E_w, O=O_w, E_rounds=E_st, O_rounds=O_st, kmeans_error=acc[:, 0],
        entropy=acc[:, 1],
        tables=PhaseTables(pen=pens[rounds % 2].t(), blk=blk_nat),
    )


permute_rounds.launches = 0


def materialize(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, Np)
    Y: torch.Tensor,  # (d, K)
    codes: torch.Tensor,  # (ncov, Np) int32
    sigma: torch.Tensor,  # (K,)
    tables: PhaseTables,
    moments: Optional[MomentsSpec] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3: the final R (K, Np) and, with ``moments``, the (n_joint+1, K,
    d+1) moment table; the plain version on CPU tensors."""
    floats = {"Z": Z, "Y": Y, "sigma": sigma, "pen": tables.pen}
    if moments is not None:
        floats["Z_orig"] = moments.Z_orig
    if not _check("materialize", cfg, floats, codes):
        return twin.materialize(cfg, Z, Y, codes, sigma, tables, moments)
    K, d, B, ncov, nb = cfg.K, cfg.d, cfg.B, cfg.n_covariates, cfg.n_blocks
    Np, dev = cfg.Np, Z.device
    if tables.pen.shape != (K, (nb + 1) * B) or tables.blk.shape != (Np,):
        raise ValueError("materialize: the phase tables disagree with the config")
    T = cell_tile(K, d, B, ncov)
    pen_rows = tables.pen.t().contiguous()  # (nbp*B, K); a view of K2's tables
    blk = tables.blk.to(torch.int32).contiguous()
    Zc, Yt, sig = Z.contiguous(), Y.t().contiguous(), sigma.contiguous()
    R = torch.empty((K, Np), dtype=_F32, device=dev)
    lib = _build.load("permute_phase", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    off = _offsets_on(cfg.covariate_offsets, str(dev))
    d1p = _ceil4(d + 1)
    M = None
    if moments is None:
        grid, chunk, tw = -(-Np // T), 0, T
        ptrs = (None, None, None)
    else:
        tj = np.asarray(moments.tile_joint, dtype=np.int32)
        nj, tw = int(moments.n_joint), int(moments.tile)
        if (moments.Z_orig.shape != (d, Np) or tj.shape != (-(-Np // tw),)
                or tj.max(initial=0) > nj):
            raise ValueError("materialize: the moments spec disagrees with the config")
        if not moments_fit(K, d):
            raise ValueError(f"materialize: K={K}, d={d} need more than {_MAX_MT} "
                             "register tiles a thread for the moments")
        chunks, start, grid = _moments_plan(tj.tobytes(), nj, str(dev))
        chunk = _CHUNK_TILES
        Zo = moments.Z_orig.contiguous()
        part = torch.empty((max(grid, 1), K, d + 1), dtype=_F32, device=dev)
        M = torch.empty((nj + 1, K, d + 1), dtype=_F32, device=dev)
        ptrs = (Zo, chunks, part)
    smem = materialize_smem_bytes(K, d, ncov, T, moments is not None)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(lib.k3_materialize(
        Yt.data_ptr(), Zc.data_ptr(), codes.data_ptr(), off.data_ptr(), blk.data_ptr(),
        pen_rows.data_ptr(), sig.data_ptr(), R.data_ptr(),
        *[ptr(t) for t in ptrs], Np, cfg.N, K, d, B, ncov, T, grid, chunk, tw, d1p, smem,
        stream,
    ), "k3_materialize")
    if M is not None:
        sum_joint_rows(part, start, M)
    materialize.launches += 1
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
    R, M = materialize(cfg, Zf, Y.to(_F32), codes, sigma.to(_F32), rr.tables, moments)
    return PermutePhaseResult(R=R, E=rr.E, O=rr.O, E_rounds=rr.E_rounds,
                              O_rounds=rr.O_rounds, kmeans_error=rr.kmeans_error,
                              entropy=rr.entropy, M=M)
