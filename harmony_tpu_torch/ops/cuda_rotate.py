"""K6 and K7: the wrappers of the rotate schedule's kernels.

Counterpart of ``harmony_tpu/ops/pallas_rotate.py`` (``pallas_reassign``,
``pallas_rotate_update_round_v2``), drop-ins for the plain versions in
:mod:`harmony_tpu_torch.ops.rotate`. The CUDA source is ``csrc/rotate.cu``.

* :func:`reassign` (K6): one C call, an assign launch over the padded
  layout's 64-cell pieces and a reduction launch that builds tile_O, O
  and E.
* :func:`rotate_update_round_v2` (K7): a host loop over the blocks in the
  round's order. One commit launch removes the first block's old O; then
  each block gets an assign launch over its cells and a commit launch
  that folds its partials into tile_O and E/O, removes the next block's
  old O and writes the next penalty tables. A block's old O is the
  fixed-order sum of its tiles in the previous round's table, computed
  in the commit kernel: the loop issues launches only, with no PyTorch
  operation or host copy between them.

For CPU tensors each wrapper runs its plain version; anything else
raises. ``launches`` counts calls into the kernel's C entry points
(1 per K6 call, 1 + 2 * n_blocks per K7 round).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from ..config import HarmonyConfig
from . import rotate
from .rotate import CodesLayout, RoundState

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_CT = 64  # cells per assign CTA (kCT in rotate.cu)
_WARPS = 8
_SIGNATURES = {
    "k7_assign": [_build.PTR] * 9 + [_build.I64] + [_build.INT] * 9 + [_build.PTR],
    "k7_commit": [_build.PTR, _build.INT, _build.INT, _build.INT, _build.INT,
                  _build.INT, _build.PTR, _build.PTR, _build.INT, _build.INT]
    + [_build.PTR] * 9 + [_build.INT] * 4 + [_build.PTR],
    "k6_reassign": [_build.PTR] * 11 + [_build.I64] + [_build.INT] * 7 + [_build.PTR],
}


def assign_smem_bytes(K: int, d: int, B: int, ncov: int) -> int:
    """Shared memory of one K7 assign CTA (layout in rotate.cu); K6 needs
    less."""
    floats = K * d + d * _CT + K * (_CT + 1) + 3 * K * B + 2 * K + 2 * _WARPS
    return 4 * (floats + ncov * _CT)


def _check(where: str, cfg: HarmonyConfig, floats: dict, codes: torch.Tensor):
    dev = codes.device
    for name, t in {**floats, "codes": codes}.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, codes on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{where}: unsupported device {dev}")
    if dev.type == "cpu":
        return
    for name, t in floats.items():
        # Y may be a strided view: the wrappers copy Y^T for the kernel
        if t.dtype != _F32 or not (t.is_contiguous() or name == "Y"):
            raise TypeError(f"{where}: {name} must be contiguous float32")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise TypeError(f"{where}: codes must be contiguous int32")
    T = cfg.estep_sub_tile
    if T % _CT or codes.shape[1] % T:
        raise ValueError(f"{where}: the layout ({codes.shape[1]} cells) must be "
                         f"whole tiles of {T} cells, a multiple of {_CT}")
    smem = assign_smem_bytes(cfg.K, cfg.d, cfg.B, cfg.n_covariates)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"{where}: K={cfg.K}, d={cfg.d}, B={cfg.B} need {smem} bytes of shared "
            f"memory a CTA, over the {_SMEM_MAX} a CTA may use"
        )


@functools.lru_cache(maxsize=4)
def _offsets_on(offsets: Tuple[int, ...], device: str) -> torch.Tensor:
    """The covariate offsets as an int32 tensor on the device, made once:
    a host copy inside the round loop would synchronise the stream."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def reassign(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    sigma: torch.Tensor,  # (K,)
    Pr_b: torch.Tensor,  # (B,)
    Z_raw: torch.Tensor,  # (d, NT*T)
    codes_pad: torch.Tensor,  # (ncov, NT*T) int32; pads -B-1
):
    """K6; returns (Zn (d, NT*T), tile_O (NT, K, B), O (K, B), E (K, B))."""
    _check("reassign", cfg, {"Y": Y, "sigma": sigma, "Pr_b": Pr_b, "Z_raw": Z_raw},
           codes_pad)
    if Z_raw.device.type == "cpu":
        return rotate.reassign(cfg, Y, sigma, Pr_b, Z_raw, codes_pad)
    d, L = Z_raw.shape
    K, B, T = cfg.K, cfg.B, cfg.estep_sub_tile
    NT = L // T
    dev = Z_raw.device
    Yt = Y.t().contiguous()
    Zn = torch.empty_like(Z_raw)
    part = torch.empty((L // _CT, K * B), dtype=_F32, device=dev)
    tile_O = torch.empty((NT, K, B), dtype=_F32, device=dev)
    O = torch.empty((K, B), dtype=_F32, device=dev)
    E = torch.empty((K, B), dtype=_F32, device=dev)
    lib = _build.load("rotate", _SIGNATURES)
    _build.check(lib.k6_reassign(
        Yt.data_ptr(), Z_raw.data_ptr(), codes_pad.data_ptr(),
        _offsets_on(cfg.covariate_offsets, str(dev)).data_ptr(), sigma.data_ptr(),
        Pr_b.data_ptr(),
        Zn.data_ptr(), part.data_ptr(), tile_O.data_ptr(), O.data_ptr(),
        E.data_ptr(), L, NT, K, d, B, cfg.n_covariates, cfg.B_vec[0],
        assign_smem_bytes(K, d, B, cfg.n_covariates),
        torch.cuda.current_stream(dev).cuda_stream,
    ), "k6_reassign")
    reassign.launches += 1
    return Zn, tile_O, O, E


reassign.launches = 0


def rotate_update_round_v2(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    rs: RoundState,
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    rt: int,
    order: Sequence[int],
    layout: CodesLayout,
    write_r: bool = True,
) -> RoundState:
    """K7: one stats-carrying round for the schedule (rt, order)."""
    floats = {"Y": Y, "R": rs.R, "E": rs.E, "O": rs.O, "tile_O": rs.tile_O,
              "Pr_b": Pr_b, "sigma": sigma, "theta": theta, "Z_pad": layout.Z_pad}
    _check("rotate_update_round_v2", cfg, floats, layout.codes_pad)
    if Y.device.type == "cpu":
        return rotate.rotate_update_round_v2(cfg, Y, rs, Pr_b, sigma, theta, rt,
                                             order, layout, write_r)
    d, L = layout.Z_pad.shape
    K, B, T = cfg.K, cfg.B, cfg.estep_sub_tile
    NT, cpt = L // T, T // _CT
    if rs.tile_O.shape != (NT, K, B) or rs.R.shape != (K, L):
        raise ValueError("rotate_update_round_v2: tile_O/R shapes disagree with the layout")
    szs, vstart = rotate.block_sizes(cfg)
    dev = Y.device
    Yt = Y.t().contiguous()
    E_w = torch.empty((K, B), dtype=_F32, device=dev)
    O_w = torch.empty((K, B), dtype=_F32, device=dev)
    pen = torch.empty((K, B), dtype=_F32, device=dev)
    logpen = torch.empty((K, B), dtype=_F32, device=dev)
    acc = torch.empty(2, dtype=_F32, device=dev)
    tile_O = torch.empty_like(rs.tile_O)
    R_out = torch.empty_like(rs.R) if write_r else None
    part = torch.empty((max(szs) * cpt, K * B + 2), dtype=_F32, device=dev)
    offsets = _offsets_on(cfg.covariate_offsets, str(dev))
    smem = assign_smem_bytes(K, d, B, cfg.n_covariates)
    lib = _build.load("rotate", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ncov, b0 = cfg.n_covariates, cfg.B_vec[0]

    def commit(add_blk: int, rm_blk: int, first: bool) -> None:
        v0, nt = ((vstart[add_blk] + rt) % NT, szs[add_blk]) if add_blk >= 0 else (0, 0)
        rv0, rn = ((vstart[rm_blk] + rt) % NT, szs[rm_blk]) if rm_blk >= 0 else (0, 0)
        E_in, O_in = (rs.E, rs.O) if first else (E_w, O_w)
        _build.check(lib.k7_commit(
            part.data_ptr(), int(add_blk >= 0), v0, nt, cpt, NT,
            tile_O.data_ptr(), rs.tile_O.data_ptr(), rv0, rn, E_in.data_ptr(),
            O_in.data_ptr(), E_w.data_ptr(), O_w.data_ptr(), Pr_b.data_ptr(),
            theta.data_ptr(), pen.data_ptr(), logpen.data_ptr(), acc.data_ptr(),
            int(first), K, B, b0, stream,
        ), "k7_commit")
        rotate_update_round_v2.launches += 1

    order = [int(b) for b in order]
    commit(-1, order[0], True)
    for i, blk in enumerate(order):
        _build.check(lib.k7_assign(
            Yt.data_ptr(), layout.Z_pad.data_ptr(), layout.codes_pad.data_ptr(),
            offsets.data_ptr(), pen.data_ptr(), logpen.data_ptr(),
            sigma.data_ptr(), R_out.data_ptr() if write_r else None,
            part.data_ptr(), L, (vstart[blk] + rt) % NT, szs[blk], NT, cpt,
            K, d, B, ncov, smem, stream,
        ), "k7_assign")
        rotate_update_round_v2.launches += 1
        commit(blk, order[i + 1] if i + 1 < len(order) else -1, False)
    return RoundState(R=R_out if write_r else rs.R, E=E_w, O=O_w, tile_O=tile_O,
                      kmeans_error=acc[0], entropy=acc[1])


rotate_update_round_v2.launches = 0
