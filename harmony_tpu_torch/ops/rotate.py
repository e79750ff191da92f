"""The rotate schedule: its host side and the plain twins of K6 and K7.

Counterpart of the parts of ``harmony_tpu/ops/pallas_rotate.py`` that are
not kernels (the padded code layout, the schedule and the block-old
statistics), and the plain PyTorch versions of its two kernels on the
stats-carrying path:

* :func:`reassign`, the twin of K6 (``_reassign_kernel``, :1261): the
  cluster phase's re-entry. It L2-normalises the padded Z_corr, recomputes
  the assignments from the centroids and returns the per-tile O table,
  O and E, and the phase's Gram table G = (Y^T Zn)^T, one row per cell. It
  writes no R.
* :func:`rotate_update_round_v2`, the twin of K7 (``_round_kernel_v2``,
  :594): one stats-carrying round, g taken from the layout's G (Y and Zn
  are fixed within the phase). Each block's old contribution comes
  from the previous round's per-tile table, never from R. On the phase's
  last round it can also return the M-step's joint-batch moments of its R
  (``moments``) and its per-block penalty tables with the tile -> block
  map (``emit_pen``), from which the virtual-R functions below reproduce
  every assignment without R having been written.
* :func:`virtual_correction`, the twin of K10 (``_virtual_correction_kernel``,
  :1451): R recomputed per tile from those tables and the phase's Gram
  table G where given, then Z_orig - W_joint R.
* :func:`materialize_r`, the twin of K11 (``_materialize_r_kernel``,
  :1621): the run-end R from the same tables.
* :func:`rotate_update_round_v1`, the twin of K12 (``_round_kernel``,
  :223): the round without the stats carry, which reads each block's old
  statistics from the input R (phase 0) before it assigns the block and
  writes its R (phase 1). Its op order is K1's (``estep.py``), not K7's.

K7's, K10's and K11's twins compute R with one function (:func:`_assign_r`)
from g, as the three kernels run one routine's operations; K7's and
K10's read g from G where given (their kernels always do), K11's forms it
from Zn, as its kernel does.

Under :attr:`HarmonyConfig.bf16_products` (a reduced-precision engine
under the resolved 'bfloat16') g = Y^T Zn and K10's W R take the bf16
product form, as their kernels do: both operands rounded to bf16
(:func:`bf16_operand`), then an fp32 product, so a twin and its kernel
differ only in the order of the fp32 sums.

Schedule: cells were shuffled once at ingest; virtual tile v holds
physical tile (v + rt) mod NT for a per-round rotation rt, and the nb
blocks are contiguous runs of virtual tiles processed in a per-round
random order. Per-block semantics are the reference's: every cell of a
block sees E/O with the whole block removed (src/harmony.cpp:309-331).

Op orders (``_assign_tile`` :403-479), by ``cfg.estep_variant``:

* ``fused_vpu`` (and ``fused_mxu``, the same function): per cell
  ``w = exp((g - 1) * 2/sigma) * pen[code]``, one guarded normalise
  ``R = w * (1 / colsum)``; the k-means error as ``2 n_valid - 2 sum R g``.
* ``legacy`` (:452-458, the reference's two normalisations,
  src/harmony.cpp:319-323): ``d = 2 (1 - g)``, ``e = exp(-d / sigma)``,
  ``w = (e / colsum(e)) * pen[code]``, then the same guarded normalise;
  the k-means error as ``sum R d`` (:773-774).

The entropy is in the factorised form for one covariate (:781-805, whose
column term is ``log colsum``, under ``legacy`` ``log(colsum(e) colsum)``),
``sum sigma R log R`` for several.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import graphs
from ..config import HarmonyConfig
from .cuda_ridge import tile_moments_twin, tiled_correction_twin
from .estep import RoundResult
from .objective import xlogx
from .permute_phase import MomentsSpec  # the same record on both paths

_F32 = torch.float32


class CodesLayout(NamedTuple):
    """Phase constants of the rounds: the normalised embedding and the
    codes, both padded to whole tiles (pad cells carry the sentinel code),
    and the phase's Gram table. K7 reads g from ``G``; without it the plain
    round forms g = Y^T Z_pad itself, block by block."""

    Z_pad: torch.Tensor  # (d, NT*T) float32
    codes_pad: torch.Tensor  # (ncov, NT*T) int32; pads -B-1
    G: Optional[torch.Tensor] = None  # (NT*T, K) float32, (Y^T Z_pad)^T from K6


class RoundState(NamedTuple):
    """Carry of the stats-carrying rounds."""

    R: torch.Tensor  # (K, Np)
    E: torch.Tensor  # (K, B)
    O: torch.Tensor  # (K, B)
    tile_O: torch.Tensor  # (NT, K, B) per-tile O contributions of R
    kmeans_error: torch.Tensor
    entropy: torch.Tensor
    # the extras of a phase's last round (None otherwise)
    M: Optional[torch.Tensor] = None  # (n_joint+1, K, d+1) fused moments
    pen: Optional[torch.Tensor] = None  # (nb, K, B) per-block penalties
    blkmap: Optional[torch.Tensor] = None  # (NT,) int32 physical tile -> block


class VirtualR(NamedTuple):
    """What the virtual-R correction and the run-end materialisation need
    to reproduce the final round's assignments (pallas_rotate.py:493)."""

    pen: torch.Tensor  # (nb, K, B) per-block penalties of the final round
    blkmap: torch.Tensor  # (NT,) int32 physical tile -> block
    Zn_pad: torch.Tensor  # (d, Npt) the phase's normalised layout
    codes_pad: torch.Tensor  # (ncov, Npt)
    Y: torch.Tensor  # (d, K) centroids the final round used
    Z_orig_pad: torch.Tensor  # (d, Npt)
    sigma: torch.Tensor  # (K,)
    # the final phase's Gram table (Npt, K), K6's; None on a state that
    # crossed from the JAX package (the correction then writes R with K11
    # and applies it with K9: ops.ridge.virtual_tile_correction)
    G: Optional[torch.Tensor] = None


def bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even) and held in float32:
    an operand of the bf16 product form. The product of two such values is
    exact in float32."""
    return t.to(torch.bfloat16).to(_F32)


def n_tiles(cfg: HarmonyConfig) -> int:
    return -(-cfg.Np // cfg.estep_sub_tile)


def make_codes_pad(cfg: HarmonyConfig, codes: torch.Tensor, mesh=None) -> torch.Tensor:
    """(ncov, NT*T) int32 codes with pad cells set to -B-1, below every
    level even after a covariate offset is added (pallas_rotate.py:75). On
    a mesh ``codes`` are this rank's columns and so is the result: the
    shard's slice of the global array, pad cells those at global index N
    and past."""
    if mesh is None:
        Npt, n = n_tiles(cfg) * cfg.estep_sub_tile, cfg.N
    else:
        from ..sharding import cell_range, valid_cells

        lo, hi = cell_range(cfg, mesh)
        Npt, n = hi - lo, valid_cells(cfg, mesh)
    sentinel = -cfg.B - 1
    cp = torch.full((codes.shape[0], Npt), sentinel, dtype=torch.int32,
                    device=codes.device)
    cp[:, :n] = codes[:, :n].to(torch.int32)
    return cp


def pad_cells_to_tile(cfg: HarmonyConfig, Z: torch.Tensor) -> torch.Tensor:
    """Zero-pad the cell axis to whole tiles (pallas_rotate.py:201)."""
    Npt = n_tiles(cfg) * cfg.estep_sub_tile
    if Z.shape[1] == Npt:
        return Z
    return torch.cat([Z, Z.new_zeros((Z.shape[0], Npt - Z.shape[1]))], dim=1)


def block_sizes(cfg: HarmonyConfig, NT: Optional[int] = None) -> Tuple[List[int], List[int]]:
    """(tiles per block, first virtual tile of each block): nb = min(n_blocks,
    NT) blocks of near-equal tile counts, the first NT mod nb one larger.
    ``NT`` is the tiles of the layout the round walks: the whole padded
    axis (the default) or, on a mesh, one shard's."""
    NT = n_tiles(cfg) if NT is None else NT
    nb = min(cfg.n_blocks, NT)
    base, rem = divmod(NT, nb)
    szs = [base + (i < rem) for i in range(nb)]
    vstart = [sum(szs[:i]) for i in range(nb)]
    return szs, vstart


def block_tiles(cfg: HarmonyConfig, rt: int, blk: int, NT: Optional[int] = None) -> List[int]:
    """Physical tiles of block ``blk`` under rotation ``rt``, in order."""
    NT = n_tiles(cfg) if NT is None else NT
    szs, vstart = block_sizes(cfg, NT)
    return [(vstart[blk] + j + rt) % NT for j in range(szs[blk])]


def block_table(cfg: HarmonyConfig, NT: Optional[int] = None, device="cpu") -> torch.Tensor:
    """(2, nb) int32 on ``device``: the tiles of each block, then its first
    virtual tile (:func:`block_sizes` over ``NT`` tiles), the table K7's
    launches read with the round's schedule; on the card built once per
    layout (``graphs.device_table``)."""
    return graphs.device_table(np.array(block_sizes(cfg, NT)), np.int32, device)


def block_of_tiles(cfg: HarmonyConfig, rt, device, NT: Optional[int] = None
                   ) -> torch.Tensor:
    """(NT,) int32 block of each physical tile under rotation ``rt``
    (blk_of_phys, pallas_rotate.py:1053): tile p sits at virtual slot
    (p - rt) mod NT, and the first NT mod nb blocks hold one tile more.
    ``rt`` is an int or the schedule table's 0-d entry on ``device``; built
    on the device, so no copy waits for the stream."""
    NT = n_tiles(cfg) if NT is None else NT
    base, rem = divmod(NT, len(block_sizes(cfg, NT)[0]))
    v = torch.remainder(torch.arange(NT, device=device) - rt, NT)
    big = rem * (base + 1)
    return torch.where(v < big, v // (base + 1), rem + (v - big) // base).to(torch.int32)


def draw_schedules(
    cfg: HarmonyConfig, generator: torch.Generator, rounds: int, NT: Optional[int] = None
) -> torch.Tensor:
    """``rounds`` rounds' schedules over ``NT`` tiles (default: the whole
    padded axis) from the generator: the rotations by one ``randint``, then
    one ``randperm`` of the blocks a round, as a (rounds, 1 + nb) int32
    table on the generator's device, row r the rotation of round r and then
    its block order. The table stays there: K7's launches read their round's
    row from it, so a round needs no host read and a captured round replays
    any schedule (the plain twin reads its row with ``.tolist()``)."""
    NT = n_tiles(cfg) if NT is None else NT
    nb = len(block_sizes(cfg, NT)[0])
    dev = generator.device
    rts = torch.randint(0, NT, (rounds,), generator=generator, device=dev)
    orders = torch.stack(
        [torch.randperm(nb, generator=generator, device=dev) for _ in range(rounds)]
    )
    return torch.cat([rts[:, None], orders], dim=1).to(torch.int32)


def schedule_table(pairs: Sequence[Tuple[int, Sequence[int]]], device="cpu") -> torch.Tensor:
    """The schedule table of injected (rotation, block order) pairs, one
    row a round (:func:`draw_schedules`' layout)."""
    return torch.tensor([[int(rt), *[int(b) for b in order]] for rt, order in pairs],
                        dtype=torch.int32, device=device)


def schedule_pairs(table: torch.Tensor) -> List[Tuple[int, List[int]]]:
    """The (rotation, block order) pairs of a schedule table, on the host
    (one read)."""
    return [(row[0], row[1:]) for row in table.tolist()]


def block_old_stats(
    cfg: HarmonyConfig, tile_O: torch.Tensor, rt: int, order: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round's step table and each block's old O (pallas_rotate.py:550).

    Returns (steps (4, NT) int64 on the CPU, rows: physical tile, block,
    first step of the block, last step of the block; blk_O (nb, K, B)
    indexed by block id). blk_O is a difference of an exclusive cumsum
    over the table in virtual order, as in the JAX function.
    """
    NT = tile_O.shape[0]
    szs, vstart = block_sizes(cfg, NT)
    szs_t = torch.tensor(szs, dtype=torch.int64)
    vs_t = torch.tensor(vstart, dtype=torch.int64)
    order_t = torch.as_tensor(list(order), dtype=torch.int64)
    sz_o = szs_t[order_t]
    blk = torch.repeat_interleave(order_t, sz_o)
    offs = torch.cumsum(sz_o, 0) - sz_o
    within = torch.arange(NT) - torch.repeat_interleave(offs, sz_o)
    tile = (vs_t[blk] + within + rt) % NT
    steps = torch.stack([tile, blk, (within == 0).long(),
                         (within == szs_t[blk] - 1).long()])

    virt = ((torch.arange(NT) + rt) % NT).to(tile_O.device)
    cs = torch.cumsum(tile_O.index_select(0, virt), dim=0, dtype=_F32)
    cs_ex = torch.cat([torch.zeros_like(cs[:1]), cs])
    dev = tile_O.device
    blk_O = cs_ex[(vs_t + szs_t).to(dev)] - cs_ex[vs_t.to(dev)]
    return steps, blk_O


def v1_steps(cfg: HarmonyConfig, rt: int, order: Sequence[int]) -> torch.Tensor:
    """(5, 2 NT) int64 step table of K12's two-phase walk (``_schedule``,
    pallas_rotate.py:330): per block in ``order``, its tiles once in phase
    0 and once in phase 1. Rows: physical tile, block, phase, first step
    of the block's phase, last step of the block (phase 1 only)."""
    cols = []
    for blk in order:
        tiles = block_tiles(cfg, rt, int(blk))
        for phase in (0, 1):
            cols += [(t, int(blk), phase, int(j == 0), int(phase == 1 and j == len(tiles) - 1))
                     for j, t in enumerate(tiles)]
    return torch.tensor(cols, dtype=torch.int64).t()


def _one_hot_tiles(cfg: HarmonyConfig, codes: torch.Tensor) -> torch.Tensor:
    """(..., B) stacked one-hot of padded codes (ncov, ...); pads are zero."""
    oh = None
    for c, off in enumerate(cfg.covariate_offsets):
        cc = codes[c].long()
        idx = torch.where(cc >= 0, cc + off, torch.full_like(cc, cfg.B))
        t = torch.nn.functional.one_hot(idx, cfg.B + 1)[..., : cfg.B].to(_F32)
        oh = t if oh is None else oh + t
    return oh


def tile_stats_from_R(
    cfg: HarmonyConfig, R: torch.Tensor, codes_pad: torch.Tensor
) -> torch.Tensor:
    """(NT, K, B) per-tile O contributions of R (pallas_rotate.py:531)."""
    K = R.shape[0]
    T, NT = cfg.estep_sub_tile, n_tiles(cfg)
    R3 = pad_cells_to_tile(cfg, R.to(_F32)).reshape(K, NT, T).permute(1, 0, 2)
    oh = _one_hot_tiles(cfg, codes_pad.reshape(-1, NT, T))  # (NT, T, B)
    return torch.bmm(R3, oh)


def reassign(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    sigma: torch.Tensor,  # (K,)
    Pr_b: torch.Tensor,  # (B,)
    Z_raw: torch.Tensor,  # (d, NT*T) un-normalised corrected embedding
    codes_pad: torch.Tensor,  # (ncov, NT*T) int32; pads -B-1
):
    """Plain version of K6 (``pallas_reassign``, pallas_rotate.py:1354).

    Returns (Zn (d, NT*T), tile_O (NT, K, B), O (K, B), E (K, B), G (NT*T,
    K)); E is rowsums(R) Pr_b^T with the row sums from covariate 0's block
    of O; G is (Y^T Zn)^T, cell-major, in the bf16 product form under
    ``cfg.bf16_products``."""
    d, Npt = Z_raw.shape
    T = cfg.estep_sub_tile
    NT = Npt // T
    Zf = Z_raw.to(_F32)
    nrm = torch.sqrt((Zf * Zf).sum(dim=0, keepdim=True))
    Zn = Zf / torch.where(nrm == 0.0, torch.ones_like(nrm), nrm)
    Yt, Zg = Y.t().to(_F32), Zn
    if cfg.bf16_products:
        Yt, Zg = bf16_operand(Yt), bf16_operand(Zn)
    g = Yt @ Zg  # (K, Npt)
    e = torch.exp((g - 1.0) * (2.0 / sigma.to(_F32))[:, None])
    R_n = e * (codes_pad[0] >= 0).to(_F32)[None, :]
    colsum = R_n.sum(dim=0, keepdim=True)
    R_n = R_n * (1.0 / torch.where(colsum == 0.0, torch.ones_like(colsum), colsum))
    K = R_n.shape[0]
    oh = _one_hot_tiles(cfg, codes_pad.reshape(-1, NT, T))
    tile_O = torch.bmm(R_n.reshape(K, NT, T).permute(1, 0, 2), oh)
    O = tile_O.sum(dim=0)
    E = O[:, : cfg.B_vec[0]].sum(dim=1)[:, None] * Pr_b.to(_F32)[None, :]
    return Zn, tile_O, O, E, g.t().contiguous()


def _gram_tiles(Yt, Z3, bf16: bool = False):
    """g = Y^T z (K, n, T) of ``n`` tiles Z3 (d, n, T); ``bf16``: in the
    bf16 product form (:func:`bf16_operand`)."""
    d, n, T = Z3.shape
    if bf16:
        Yt, Z3 = bf16_operand(Yt), bf16_operand(Z3)
    return (Yt @ Z3.reshape(d, n * T)).reshape(-1, n, T)


def _assign_r(cfg, g, codes3, pen, sigma):
    """The assignments of ``n`` tiles (g (K, n, T), codes3 (ncov, n, T))
    against one block-removed penalty table (K, B) in the op order of
    ``cfg.estep_variant``: R (K, n, T), with the guarded column sums and,
    under ``legacy``, the first normalisation's column sums (else None),
    which the objective terms reuse."""
    K, B = pen.shape
    _, n, T = g.shape
    pen_pad = torch.cat([pen, pen.new_zeros((K, 1))], dim=1)
    pc = None
    for c, off in enumerate(cfg.covariate_offsets):
        cc = codes3[c].reshape(-1).long()
        idx = torch.where(cc >= 0, cc + off, torch.full_like(cc, B))
        t = pen_pad.index_select(1, idx).reshape(K, n, T)
        pc = t if pc is None else pc + t
    colsum1 = None
    if cfg.estep_variant == "legacy":
        e = torch.exp(-(2.0 * (1.0 - g)) / sigma[:, None, None])
        colsum1 = e.sum(dim=0)
        w = (e / colsum1) * pc
    else:
        w = torch.exp((g - 1.0) * (2.0 / sigma)[:, None, None]) * pc
    colsum = w.sum(dim=0)
    colsum_g = torch.where(colsum == 0.0, torch.ones_like(colsum), colsum)
    return w * (1.0 / colsum_g), colsum_g, colsum1


def _assign_tiles(cfg, g, codes3, pen, logpen, sigma):
    """Assign ``n`` tiles (g (K, n, T)) against one block-removed penalty
    table. Returns (R (K, n, T), tO (n, K, B), kmeans error and entropy per
    tile (n,))."""
    R_n, colsum_g, colsum1 = _assign_r(cfg, g, codes3, pen, sigma)
    oh = _one_hot_tiles(cfg, codes3)  # (n, T, B)
    tO = torch.bmm(R_n.permute(1, 0, 2), oh)  # (n, K, B)
    b0 = cfg.B_vec[0]
    if colsum1 is not None:
        s_rd = (R_n * (2.0 * (1.0 - g))).sum(dim=(0, 2))
    else:
        n_valid = tO[:, :, :b0].sum(dim=(1, 2))
        s_rd = 2.0 * n_valid - 2.0 * (R_n * g).sum(dim=(0, 2))
    if cfg.n_covariates == 1:
        # sigma R log R with log R = (g-1) 2/sigma + logpen - log colsum
        # (legacy: - log(colsum1 colsum)): the first term contracts to
        # -R*d, the penalty term against tO
        sR = (sigma[:, None, None] * R_n).sum(dim=0)  # (n, T)
        logc = torch.log(colsum_g if colsum1 is None else colsum1 * colsum_g)
        ent = (-s_rd - (logc * sR).sum(dim=1)
               + (sigma[None, :, None] * tO * logpen[None]).sum(dim=(1, 2)))
    else:
        ent = (sigma[:, None, None] * xlogx(R_n)).sum(dim=(0, 2))
    return R_n, tO, s_rd, ent


def rotate_update_round_v2(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    rs: RoundState,
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    sched: torch.Tensor,  # (1 + nb,) int32 the round's row of the schedule table
    layout: CodesLayout,
    write_r: bool = True,
    moments: Optional[MomentsSpec] = None,
    emit_pen: bool = False,
) -> RoundState:
    """Plain version of K7 (``pallas_rotate_update_round_v2``,
    pallas_rotate.py:851) for the round's row ``sched`` of the schedule
    table (:func:`draw_schedules`: the rotation rt, then the block order),
    read on the host, g taken from ``layout.G`` (formed from
    ``layout.Z_pad`` block by block without it).

    ``write_r=False`` leaves the returned R the (stale) input R: no round
    reads R, so only the phase's last round has to write it. ``moments``
    (layout tiles of ``moments.tile`` cells, ``moments.Z_orig`` the padded
    original embedding) returns the joint-batch moment table of this
    round's R in ``M``; ``emit_pen`` returns the per-block penalty tables
    in ``pen`` and the tile -> block map in ``blkmap``."""
    K, Np = rs.R.shape
    d, Npt = layout.Z_pad.shape
    T = cfg.estep_sub_tile
    NT = Npt // T
    b0 = cfg.B_vec[0]
    rt, *order = sched.tolist()
    _, blk_O = block_old_stats(cfg, rs.tile_O, rt, order)
    Yt = Y.t().to(_F32)
    sig = sigma.to(_F32)
    Pr = Pr_b.to(_F32)[None, :]
    th = theta.to(_F32)[None, :]
    Z3 = layout.Z_pad.reshape(d, NT, T)
    G3 = None if layout.G is None else layout.G.reshape(NT, T, K)
    c3 = layout.codes_pad.reshape(-1, NT, T)
    E, O = rs.E.to(_F32), rs.O.to(_F32)
    tile_O = torch.empty_like(rs.tile_O)
    keep_r = write_r or moments is not None
    R_new = torch.empty((K, NT, T), dtype=_F32, device=Y.device) if keep_r else None
    pen_out = torch.empty((blk_O.shape[0], K, cfg.B), dtype=_F32,
                          device=Y.device) if emit_pen else None
    acc_d = torch.zeros((), dtype=_F32, device=Y.device)
    acc_e = torch.zeros((), dtype=_F32, device=Y.device)
    for blk in order:
        # remove the block (src/harmony.cpp:312-313) and build its penalty
        Ob = blk_O[blk]
        E = E - Ob[:, :b0].sum(dim=1, keepdim=True) * Pr
        O = O - Ob
        ratio = (2.0 * E + 1.0) / (O + E + 1.0)
        pen = ratio ** th
        logpen = torch.log(ratio) * th
        if emit_pen:
            pen_out[blk] = pen
        tiles = torch.as_tensor(block_tiles(cfg, rt, blk, NT), device=Y.device)
        g = (_gram_tiles(Yt, Z3.index_select(1, tiles), cfg.bf16_products) if G3 is None
             else G3.index_select(0, tiles).permute(2, 0, 1))
        R_n, tO, s_rd, ent = _assign_tiles(cfg, g, c3.index_select(1, tiles), pen, logpen,
                                           sig)
        tile_O[tiles] = tO
        acc_d = acc_d + s_rd.sum()
        acc_e = acc_e + ent.sum()
        if keep_r:
            R_new[:, tiles] = R_n
        # commit the block's new contribution (src/harmony.cpp:329-330)
        Opend = tO.sum(dim=0)
        E = E + Opend[:, :b0].sum(dim=1, keepdim=True) * Pr
        O = O + Opend
    M = None
    if moments is not None:
        M = tile_moments_twin(R_new.reshape(K, Npt), moments.Z_orig.to(_F32),
                              moments.tile, moments.tile_joint, moments.n_joint)
    R_out = R_new.reshape(K, Npt)[:, :Np].to(rs.R.dtype) if write_r else rs.R
    return RoundState(R=R_out, E=E.to(rs.E.dtype), O=O.to(rs.O.dtype),
                      tile_O=tile_O, kmeans_error=acc_d, entropy=acc_e, M=M,
                      pen=pen_out,
                      blkmap=block_of_tiles(cfg, rt, Y.device, NT) if emit_pen else None)


def rotate_update_round_v1(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    R: torch.Tensor,  # (K, Np) the previous round's assignments
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    rt,
    order: Optional[Sequence[int]],
    layout: CodesLayout,
) -> RoundResult:
    """Plain version of K12 (``pallas_rotate_update_round``,
    pallas_rotate.py:1752) for the schedule (rt, order), or with ``order``
    None for ``rt`` the round's row of the schedule table (read with
    ``.tolist()``), as the kernel takes it; step by step along
    :func:`v1_steps`. Phase 0 sums the block's old row sums and O
    from the input R, tile by tile; the first phase-1 step removes them
    and builds the penalty; each phase-1 step assigns one tile as K1's
    chain does (``exp(-d / sigma)``, an unguarded normalise, the penalty,
    a guarded one) and the block's last step adds its new statistics
    back. Pad cells have all-zero one-hot rows, so their R is 0."""
    if order is None:
        rt, *order = rt.tolist()
    K, Np = R.shape
    d, Npt = layout.Z_pad.shape
    T = cfg.estep_sub_tile
    NT = Npt // T
    R3 = pad_cells_to_tile(cfg, R.to(_F32)).reshape(K, NT, T)
    Z3 = layout.Z_pad.to(_F32).reshape(d, NT, T)
    oh = _one_hot_tiles(cfg, layout.codes_pad.reshape(-1, NT, T))  # (NT, T, B)
    Yt = Y.t().to(_F32)
    sig = sigma.to(_F32)[:, None]
    Pr = Pr_b.to(_F32)[None, :]
    th = theta.to(_F32)[None, :]
    E_s, O_s = E.to(_F32), O.to(_F32)
    R_new = torch.empty((K, NT, T), dtype=_F32, device=R.device)
    acc_d = torch.zeros((), dtype=_F32, device=R.device)
    acc_e = torch.zeros((), dtype=_F32, device=R.device)
    for tile, _, phase, first, last in v1_steps(cfg, rt, order).t().tolist():
        oh_t = oh[tile]
        if phase == 0:
            if first:
                rold = torch.zeros((K, 1), dtype=_F32, device=R.device)
                Oold = torch.zeros_like(E_s)
            R_t = R3[:, tile]
            rold = rold + R_t.sum(dim=1, keepdim=True)
            Oold = Oold + R_t @ oh_t
            continue
        if first:
            # remove the block (src/harmony.cpp:312-313), then its penalty
            E_s = E_s - rold * Pr
            O_s = O_s - Oold
            pen = ((2.0 * E_s + 1.0) / (O_s + E_s + 1.0)) ** th
            rpend = torch.zeros((K, 1), dtype=_F32, device=R.device)
            Opend = torch.zeros_like(E_s)
        d_t = 2.0 * (1.0 - Yt @ Z3[:, tile])
        R_n = torch.exp(-d_t / sig)
        R_n = R_n / R_n.sum(dim=0, keepdim=True)
        R_n = R_n * (pen @ oh_t.t())
        colsum = R_n.sum(dim=0, keepdim=True)
        R_n = R_n / torch.where(colsum == 0.0, torch.ones_like(colsum), colsum)
        rpend = rpend + R_n.sum(dim=1, keepdim=True)
        Opend = Opend + R_n @ oh_t
        acc_d = acc_d + (R_n * d_t).sum()
        acc_e = acc_e + (sig * xlogx(R_n)).sum()
        R_new[:, tile] = R_n
        if last:
            # commit the block's new contribution (src/harmony.cpp:329-330)
            E_s = E_s + rpend * Pr
            O_s = O_s + Opend
    return RoundResult(R=R_new.reshape(K, Npt)[:, :Np].to(R.dtype), E=E_s.to(E.dtype),
                       O=O_s.to(O.dtype), kmeans_error=acc_d, entropy=acc_e)


def _virtual_r(cfg, Y, sigma, pen, blk_of_phys, Zn_pad, codes_pad, out_dtype=None, G=None):
    """(K, Npt) assignments of the round whose per-block penalties are
    ``pen``: each block's tiles through :func:`_assign_r`, g read from the
    phase's Gram table ``G`` (Npt, K) or formed from Y and Zn without it,
    cast per block to ``out_dtype`` (default float32)."""
    d, Npt = Zn_pad.shape
    T = cfg.estep_sub_tile
    NT, K = Npt // T, pen.shape[1]
    Yt, sig = Y.t().to(_F32), sigma.to(_F32)
    Z3 = Zn_pad.to(_F32).reshape(d, NT, T)
    G3 = None if G is None else G.to(_F32).reshape(NT, T, K)
    c3 = codes_pad.reshape(-1, NT, T)
    R = torch.empty((K, NT, T), dtype=out_dtype or _F32, device=Zn_pad.device)
    blkmap = blk_of_phys.long()
    for b in range(pen.shape[0]):
        tiles = (blkmap == b).nonzero().squeeze(1)
        if tiles.numel():
            g = (_gram_tiles(Yt, Z3.index_select(1, tiles), cfg.bf16_products) if G3 is None
                 else G3.index_select(0, tiles).permute(2, 0, 1))
            R[:, tiles] = _assign_r(cfg, g, c3.index_select(1, tiles), pen[b].to(_F32),
                                    sig)[0].to(R.dtype)
    return R.reshape(K, Npt)


def virtual_correction(
    cfg: HarmonyConfig,
    W_joint: torch.Tensor,  # (n_joint + 1, d, K); trash row zero
    tile_joint,  # (Npt // layout_tile,) int32, trash tiles n_joint
    layout_tile: int,
    Y: torch.Tensor,  # (d, K) centroids the final round used
    sigma: torch.Tensor,  # (K,)
    pen: torch.Tensor,  # (nb, K, B)
    blk_of_phys: torch.Tensor,  # (NT,)
    Zn_pad: torch.Tensor,  # (d, Npt) the final phase's layout
    codes_pad: torch.Tensor,  # (ncov, Npt)
    Z_orig_pad: torch.Tensor,  # (d, Npt)
    G: Optional[torch.Tensor] = None,  # (Npt, K) the phase's Gram table
) -> torch.Tensor:
    """Plain version of K10 (``pallas_virtual_correction``,
    pallas_rotate.py:1493): Z_orig - W_joint[joint(tile)] R per layout
    tile, R recomputed from the penalty tables, g read from ``G`` where
    given (formed from Y and Zn without it). Mixed and pad tiles meet the
    zero trash row and pass Z_orig through. Z_orig may be stored in bf16
    or float16: the correction runs in float32 and Z_corr comes back in
    Z_orig's dtype, one round-to-nearest-even of the float32 value. Under
    ``cfg.bf16_products`` W R takes the bf16 product form."""
    if G is not None and tuple(G.shape) != (Zn_pad.shape[1], pen.shape[1]):
        raise ValueError(f"virtual_correction: G must be ({Zn_pad.shape[1]}, {pen.shape[1]}), "
                         f"one row of g a cell of the layout, got {tuple(G.shape)}")
    R = _virtual_r(cfg, Y, sigma, pen, blk_of_phys, Zn_pad, codes_pad, G=G)
    W = W_joint.to(_F32)
    if cfg.bf16_products:
        W, R = bf16_operand(W), bf16_operand(R)
    return tiled_correction_twin(W, tile_joint, R, Z_orig_pad.to(_F32),
                                 layout_tile).to(Z_orig_pad.dtype)


def materialize_r(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K) centroids the final round used
    sigma: torch.Tensor,  # (K,)
    pen: torch.Tensor,  # (nb, K, B)
    blk_of_phys: torch.Tensor,  # (NT,)
    Zn_pad: torch.Tensor,  # (d, Npt)
    codes_pad: torch.Tensor,  # (ncov, Npt)
    out_dtype=None,
) -> torch.Tensor:
    """Plain version of K11 (``pallas_materialize_r``, pallas_rotate.py:
    1648): the (K, Np) assignments of the last round, as that round would
    have written them, in ``out_dtype`` (default float32)."""
    R = _virtual_r(cfg, Y, sigma, pen, blk_of_phys, Zn_pad, codes_pad, out_dtype)
    return R[:, : cfg.Np]


# --------------------------------------------------------------------------
# Sharded wrappers (harmony_tpu/ops/pallas_rotate.py:1060-1250, 1571-1750):
# each rank runs the kernels (here their plain versions) on its own cells
# and the collectives sit where the JAX package's psums do. Each shard runs
# the reference's whole block structure over its own tiles, with its own
# rotation and block order, against E/O that are global at the round's
# start; the shards' E/O deltas merge once per round. The layout arguments
# (Z, codes, the per-tile table, R) are the rank's columns; Y, E, O and the
# per-cluster and per-batch vectors are replicated.
# --------------------------------------------------------------------------


def local_blocks(mesh, pen: torch.Tensor, blk_of_phys: torch.Tensor) -> torch.Tensor:
    """A shard's tile -> block map in its own block ids: the global ids less
    ``rank * nb`` (``pen`` holds the shard's nb tables)."""
    return (blk_of_phys - mesh.rank * pen.shape[0]).to(torch.int32)


def sharded_reassign(cfg: HarmonyConfig, mesh, Y, sigma, Pr_b, Z_raw, codes_pad, fn=None):
    """K6 on the rank's cells (``fn``, the one-device function:
    :func:`reassign` by default, ``cuda_rotate.reassign`` for the kernel),
    then one all-reduce of O (``sharded_reassign``, pallas_rotate.py:
    1078-1106): E from the summed O's covariate-0 row sums. Zn, tile_O and
    G stay the rank's."""
    from ..sharding import all_reduce_sum

    Zn, tile_O, O, _, G = (fn or reassign)(cfg, Y, sigma, Pr_b, Z_raw, codes_pad)
    O = all_reduce_sum(O.to(_F32).contiguous(), mesh)
    E = O[:, : cfg.B_vec[0]].sum(dim=1)[:, None] * Pr_b.to(_F32)[None, :]
    return Zn, tile_O, O, E, G


def sharded_rotate_round_v2(cfg: HarmonyConfig, mesh, Y, rs: RoundState, Pr_b, sigma, theta,
                            sched: torch.Tensor, layout: CodesLayout,
                            write_r: bool = True, moments: Optional[MomentsSpec] = None,
                            emit_pen: bool = False, fn=None) -> RoundState:
    """K7 on the rank's cells for the rank's own schedule row ``sched``
    (``fn``: :func:`rotate_update_round_v2` by default,
    ``cuda_rotate.rotate_update_round_v2`` for the kernel), then one
    all-reduce (``sharded_rotate_round_v2``, pallas_rotate.py:1127-1216):
    E and O as ``E + sum(E_rank - E)`` (the deltas, not the sum of the
    ranks' E), the objective accumulators and the fused moment table
    summed; the penalty tables stay the rank's and the tile -> block map
    takes global block ids (shard s's blocks are s*nb .. s*nb+nb-1). A
    bf16 engine's E and O enter the round as float32 and the merge stays
    in float32, cast to their dtype once after it (pallas_rotate.py:
    1196-1252)."""
    from ..sharding import all_reduce_many

    E0, O0 = rs.E.to(_F32), rs.O.to(_F32)
    res = (fn or rotate_update_round_v2)(cfg, Y, rs._replace(E=E0, O=O0), Pr_b, sigma, theta,
                                         sched, layout, write_r, moments, emit_pen)
    parts = [res.O.to(_F32) - O0, res.E.to(_F32) - E0, res.kmeans_error.reshape(1),
             res.entropy.reshape(1)]
    if res.M is not None:
        parts.append(res.M)
    red = all_reduce_many(parts, mesh)
    blkmap = res.blkmap
    if blkmap is not None:
        blkmap = (blkmap + mesh.rank * res.pen.shape[0]).to(torch.int32)
    return res._replace(O=(O0 + red[0]).to(rs.O.dtype), E=(E0 + red[1]).to(rs.E.dtype),
                        kmeans_error=red[2][0], entropy=red[3][0],
                        M=red[4] if res.M is not None else None, blkmap=blkmap)


def sharded_virtual_correction(cfg: HarmonyConfig, mesh, W_joint, tile_joint, layout_tile: int,
                               Y, sigma, pen, blk_of_phys, Zn_pad, codes_pad, Z_orig_pad,
                               G=None, fn=None) -> torch.Tensor:
    """K10 on the rank's tiles (``fn``: :func:`virtual_correction` by
    default, ``cuda_rotate.virtual_correction`` for the kernel;
    ``sharded_virtual_correction``, pallas_rotate.py:1571): ``tile_joint``
    is the global table, ``pen`` the rank's tables, ``blk_of_phys`` its map
    in global block ids; no collective, Z_corr comes back as the rank's
    columns."""
    from ..sharding import shard_tile_table

    return (fn or virtual_correction)(
        cfg, W_joint, shard_tile_table(cfg, mesh, tile_joint, layout_tile), layout_tile, Y,
        sigma, pen, local_blocks(mesh, pen, blk_of_phys), Zn_pad, codes_pad, Z_orig_pad, G)


def sharded_materialize_r(cfg: HarmonyConfig, mesh, Y, sigma, pen, blk_of_phys, Zn_pad,
                          codes_pad, out_dtype=None, fn=None) -> torch.Tensor:
    """K11 on the rank's tiles (``fn``: :func:`materialize_r` by default,
    ``cuda_rotate.materialize_r`` for the kernel; ``sharded_materialize_r``,
    pallas_rotate.py:1710); no collective."""
    return (fn or materialize_r)(cfg, Y, sigma, pen, local_blocks(mesh, pen, blk_of_phys),
                                 Zn_pad, codes_pad, out_dtype)
