"""K6, K7, K10 and K11: the wrappers of the rotate schedule's kernels.

Counterpart of ``harmony_tpu/ops/pallas_rotate.py`` (``pallas_reassign``,
``pallas_rotate_update_round_v2``, ``pallas_virtual_correction``,
``pallas_materialize_r``), drop-ins for the plain versions in
:mod:`harmony_tpu_torch.ops.rotate`. The CUDA source is ``csrc/rotate.cu``.

* :func:`reassign` (K6): one C call, an assign launch of persistent CTAs
  over the padded layout's 64-cell pieces (:func:`reassign_plan`) and a
  reduction launch over (tile, column chunk) that builds tile_O, O and E.
  It also returns the phase's Gram table G (L, K) = (Y^T Zn)^T, which the
  phase's K7 rounds read instead of forming Y^T Z again.
* :func:`rotate_update_round_v2` (K7): a host loop over the positions of
  the round's block order, g read from ``layout.G``; each launch reads the
  round's row of the schedule table (rotation, block order) and the block
  table from the card, so the host issues the same launches for every
  schedule (a captured round replays any: ``engine.run_rounds``). One
  commit launch removes the first block's old O; then each block gets an
  assign launch over its cells and a commit launch that folds its partials
  into tile_O and E/O, removes the next block's old O and writes the next
  penalty tables. A
  block's old O is the fixed-order sum of its tiles in the previous
  round's table, computed in the commit kernel: the loop issues launches
  only, with no PyTorch
  operation or host copy between them. On a phase's last round the
  commits can also store each block's penalty table (``emit_pen``), and
  the assign launches can accumulate the M-step's moments, one row per
  layout tile (the last of its pieces' CTAs to finish sums their rows),
  summed per joint by one more launch, tiled.cu's ``sum_joint_rows``
  (``moments``).
* :func:`virtual_correction` (K10): one launch of persistent CTAs, one
  an SM, each over an equal range of the layout tiles in K8's plan order,
  R recomputed from the penalty tables and the phase's Gram table G (K6's,
  which the state keeps until the correction) with K7's per-cell
  operations, then Z_orig - W_joint R.
* :func:`materialize_r` (K11): one launch of persistent CTAs, two an SM
  where they fit, each over an equal range of the padded layout's 64-cell
  pieces (:func:`materialize_r_plan`, :func:`materialize_r_grid`), g formed
  again from Zn with K6's register tiles, R with K10's four-cell chain (K7's
  routine past 256 clusters).

K7, K10 and K11 take the config's ``estep_variant``: ``legacy`` runs the
reference's two-normalise op order (:func:`legacy`), the others the
single normalise; K6 has one op sequence.

A reduced-precision engine's storage goes to the kernels as it lies
(:data:`STORAGE`: float32, bf16, float16): K6 reads Z_raw, K7's moments
Z_orig and K10 Z_orig in it, K10 writes Z_corr and K11 R in it; each
kernel is one instance per storage type, chosen by an int argument
(:func:`storage_code`), whose arithmetic is the float32 form's on the upcast
values, so a 2-byte output is the float32 form's value rounded to nearest
even. G, Zn, the penalty tables, sigma and the betas stay float32; K7's E
and O come in and go out in their own dtype (float32 copies at the
boundary), as its R does where it writes one.

Under ``cfg.bf16_products`` (a reduced-precision engine under the
resolved 'bfloat16') K6 and K11 form g = Y^T Zn, and K10 its W R, in the
bf16 product form (rotate.cu's kMma instances): both operands rounded to
bf16, products on the tensor cores, sums in fp32; the wrappers hand over
Y^T (:func:`y_bf16`) and the betas (:func:`w_bf16`) rounded to bf16 in the
layout the fragments load. K11 shares K6's routine, so its g keeps G's
bits and its R stays K7's. rotate.cu's instances lie in six libraries
(its ROTATE_PART; :func:`_lib_for`, :func:`_k10_lib`, :func:`_k11_lib`).

For CPU tensors each wrapper runs its plain version; anything else
raises. ``launches`` counts calls into the kernels' C entry points (1 per
K6, K10 or K11 call, 1 + 2 * n_blocks per K7 round and 1 more with
moments).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build, graphs
from ..config import HarmonyConfig
from . import rotate
from .cuda_estep import _sm_count
from .cuda_ridge import _ceil4, _table_on, plan_order, sum_joint_rows
from .rotate import CodesLayout, MomentsSpec, RoundState

_F32 = torch.float32
# the storage dtypes the four kernels read and write, in the order of the
# storage code their C entry points take (:func:`storage_code`)
STORAGE = (torch.float32, torch.bfloat16, torch.float16)
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_CT = 64  # cells per piece (kCT in rotate.cu)
_WARPS = 8
_SIGNATURES = {
    "k7_assign": [_build.PTR] * 15 + [_build.I64] + [_build.INT] * 14 + [_build.PTR],
    "k7_commit": [_build.PTR] * 3 + [_build.INT] * 5 + [_build.PTR] * 11
    + [_build.INT, _build.PTR] + [_build.INT] * 3 + [_build.PTR],
    "k6_occupancy": [_build.INT] * 3,
    "k6_reassign": [_build.PTR] * 14 + [_build.I64] + [_build.INT] * 15 + [_build.PTR],
    "k10_virtual_correction": [_build.PTR] * 11 + [_build.I64] + [_build.INT] * 19
    + [_build.PTR],
    "k11_materialize_r": [_build.PTR] * 8 + [_build.I64] + [_build.INT] * 15 + [_build.PTR],
}
# the entry points of each library of rotate.cu's parts (its ROTATE_PART)
_PART_ENTRIES = {"rotate": ("k7_assign", "k7_commit", "k6_occupancy", "k6_reassign",
                            "k11_materialize_r"),
                 "rotate_tiles": ("k7_assign", "k10_virtual_correction"),
                 "rotate_k10": ("k10_virtual_correction",),
                 "rotate_mma": ("k10_virtual_correction",),
                 "rotate_mma_tiles": ("k10_virtual_correction",),
                 "rotate_k11_mma": ("k11_materialize_r",)}


def _lib(name: str):
    """One library of rotate.cu's parts, built at first use."""
    return _build.load(name, {k: _SIGNATURES[k] for k in _PART_ENTRIES[name]})


def _lib_for(tw: int):
    """The library whose K7 moments take layout tiles of ``tw`` cells:
    rotate.cu's where they are whole 64-cell pieces, else rotate_tiles.cu's."""
    return _lib("rotate" if tw % _CT == 0 else "rotate_tiles")


def _k10_lib(tw: int, mma: bool):
    """The library holding K10 on layout tiles of ``tw`` cells in the
    product form ``mma`` (rotate.cu's ROTATE_PART table)."""
    whole = tw % _V_CELLS == 0
    if mma:
        return _lib("rotate_mma" if whole else "rotate_mma_tiles")
    return _lib("rotate_k10" if whole else "rotate_tiles")


def _k11_lib(mma: bool):
    """The library holding K11 in the product form ``mma``."""
    return _lib("rotate_k11_mma" if mma else "rotate")


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def mma_stride(n: int) -> int:
    """The row stride, in bf16 values, of a product form's operand table of
    depth ``n``: n rounded up to 16, plus 8, so a row is 4 mod 8 words and
    an mma fragment's 8 rows x 4 words meet 32 banks (rotate.cu)."""
    return _ceil16(n) + 8


def y_bf16(Y: torch.Tensor, K8: int) -> torch.Tensor:
    """Y^T (K, d) rounded to bf16 (to nearest even) as K6 and K11 read it in
    the product form: (K8, mma_stride(d)), zero past K and d."""
    d, K = Y.shape
    Yb = torch.zeros((K8, mma_stride(d)), dtype=torch.bfloat16, device=Y.device)
    Yb[:K, :d] = Y.t()
    return Yb


def w_bf16(W_joint: torch.Tensor) -> torch.Tensor:
    """The betas (n_joint + 1, d, K) rounded to bf16 as K10 reads them in
    the product form: (n_joint + 1, d rounded up to 16, mma_stride(K)),
    zero past d and K."""
    nj1, d, K = W_joint.shape
    Wb = torch.zeros((nj1, _ceil16(d), mma_stride(K)), dtype=torch.bfloat16,
                     device=W_joint.device)
    Wb[:, :d, :K] = W_joint
    return Wb


def assign_smem_bytes(K: int, d: int, B: int, ncov: int, moments: bool = False) -> int:
    """Shared memory of one K7 assign CTA (layout in rotate.cu,
    assign_floats); with moments the [Z_orig; 1] stage comes on top."""
    K4 = -(-K // 4) * 4
    floats = K4 * (_CT + 1) + 3 * K * B + 2 * K + 2 * _WARPS + ncov * _CT
    floats = -(-floats // 4) * 4
    if moments:
        floats += _CT * _ceil4(d + 1)
    return 4 * floats


_LP = _CT + 4  # kLP: the row stride of K6's (K8 x 64) table
_SPLITS = (4, 2, 1)  # K6: cell splits of the design sums, the most that fit first


def reassign_smem_bytes(K: int, d: int, B: int, ncov: int, splits: int,
                        mma: bool = False) -> int:
    """Shared memory of one K6 assign CTA with ``splits`` cell splits of
    the design sums (layout in rotate.cu); ``mma``: the product form, whose
    Y^T and piece are bf16 tables (K8 and 64 rows of mma_stride(d))."""
    K8 = -(-K // 8) * 8
    S = mma_stride(d)
    floats = ((K8 * S // 2 + 32 * S if mma else d * K8) + 2 * d * _CT + K8 * _LP
              + 2 * ncov * _CT + splits * K * B + 4 * _CT + (K8 // 8 + 1) * _CT + K + ncov)
    return 4 * floats


def reassign_plan(K: int, d: int, B: int, ncov: int, mma: bool = False) -> Tuple[int, int]:
    """(splits, shared memory bytes) of a K6 assign CTA: the most cell
    splits (4, 2, 1) whose (cluster, split) threads a CTA's 256 hold and
    whose tables fit; raises where one split does not fit."""
    for h in _SPLITS:
        smem = reassign_smem_bytes(K, d, B, ncov, h, mma)
        if (h == 1 or h * K <= 256) and smem <= _SMEM_MAX:
            return h, smem
    raise ValueError(f"reassign: K={K}, d={d}, B={B} need {smem} bytes of shared memory "
                     f"a CTA, over the {_SMEM_MAX} a CTA may use")


def reduce_chunks(K: int, B: int) -> int:
    """Column chunks of K6's reduce: its grid is (tiles, chunks) CTAs of
    256 threads, one (k, b) column a thread."""
    return -(-K * B // 256)


@functools.lru_cache(maxsize=16)
def _k6_grid(smem: int, n_sm: int, code: int, mma: bool) -> int:
    """The K6 assign CTAs the card holds at once (the instance reading Z in
    the storage ``code``, in the product form ``mma``)."""
    n = _lib("rotate").k6_occupancy(smem, code, int(mma))
    if n <= 0:
        raise RuntimeError(f"k6_occupancy: K6 fits no CTA on an SM (CUDA error {-n})")
    return n_sm * n


def storage_code(t: torch.Tensor) -> int:
    """The storage argument of K6, K7, K10 and K11: the index in
    :data:`STORAGE` of the dtype of the tensor the kernel reads or writes
    in storage (0 float32, 1 bf16, 2 float16)."""
    return STORAGE.index(t.dtype)


def legacy(cfg: HarmonyConfig) -> int:
    """The variant argument of K7, K10 and K11: 1 for the legacy op order,
    0 for fused_vpu (fused_mxu is the same function)."""
    return int(cfg.estep_variant == "legacy")


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def chain_lanes(K: int) -> int:
    """The cluster values a lane of K10's and K11's four-cell chain holds
    (v_chain's KJ): 1, 2, 4 or 8; 0 past 256 clusters (assign_chain)."""
    return next((kj for kj in (1, 2, 4, 8) if K <= 32 * kj), 0)


def materialize_r_smem_bytes(K: int, d: int, B: int, ncov: int, kj: int,
                             ys_shared: bool, mma: bool = False) -> int:
    """Shared memory of one K11 CTA (layout in rotate.cu): the centroids
    (d x K8, if staged; the product form ``mma``: Y^T in bf16, K8 rows of
    mma_stride(d)), a piece's Zn (and with ``mma`` its (64 x mma_stride(d))
    bf16 table), then with v_chain (kj > 0) its g, a row of K a cell, and
    its (K x 68) R table, with assign_chain (kj == 0) one (K x 65) table
    and sigma and 2/sigma; the block's penalty table; the piece's codes;
    the offsets. Each part whole float4s."""
    K8, S = _ceil(K, 8), mma_stride(d)
    f = ((K8 * S // 2 if mma else d * K8) if ys_shared else 0) + d * _CT
    f += 32 * S if mma else 0
    f += _CT * K + K * _V_LP if kj else _ceil(K * (_CT + 1), 4) + _ceil(2 * K, 4)
    return 4 * (f + _ceil(K * B, 4) + ncov * _CT + _ceil(ncov, 4))


class K11Plan(NamedTuple):
    kj: int  # v_chain's cluster values a lane; 0: assign_chain
    ys_shared: bool  # the centroids staged in shared memory
    smem: int  # bytes of shared memory a CTA


def materialize_r_plan(K: int, d: int, B: int, ncov: int, mma: bool = False) -> K11Plan:
    """K11's form at K, d, B and covariates (in the product form ``mma``):
    v_chain (to 256 clusters) with the centroids staged where that fits,
    else assign_chain with them staged, else assign_chain reading them
    where they lie. Raises where none fits."""
    kj = chain_lanes(K)
    for c, ys in ([(kj, True)] if kj else []) + [(0, True), (0, False)]:
        smem = materialize_r_smem_bytes(K, d, B, ncov, c, ys, mma)
        if smem <= _SMEM_MAX:
            return K11Plan(c, ys, smem)
    raise ValueError(f"materialize_r: K={K}, d={d}, B={B} need {smem} bytes of shared memory "
                     f"a CTA, over the {_SMEM_MAX} a CTA may use")


_SM_SMEM, _CTA_RESERVED = 233_472, 1024  # bytes of shared memory an SM has; each CTA's reserve


def materialize_r_grid(n_pieces: int, smem: int, n_sm: int) -> int:
    """K11's persistent CTAs: two an SM where both CTAs' shared memory fits
    it (the kernel's launch bounds leave the registers for two), else one;
    no more than the layout has 64-cell pieces."""
    per_sm = 2 if 2 * (smem + _CTA_RESERVED) <= _SM_SMEM else 1
    return min(n_pieces, per_sm * n_sm)


# K10: cells a step, the row stride of its R tables, the most warps a
# correction group takes (of 16), the most groups, and the most clusters
# (a lane holds 8 of a cell's values in registers)
_V_CELLS, _V_LP, _V_CORR_WARPS, _V_GROUPS, _V_MAX_K = 64, 68, 12, 2, 256


def virtual_smem_bytes(K: int, d: int, B: int, ncov: int, span: int, groups: int,
                       mma: bool = False) -> int:
    """Shared memory of K10's CTA (layout in rotate.cu) with ``groups``
    correction groups: each group's betas (the product form ``mma``: a
    bf16 table of d rounded up to 16 rows of mma_stride(K)); two steps'
    rows of G, block tables and codes; one R table more than groups (K
    rows, K rounded up to 16 in the product form); its range of ``span``
    layout tiles (tile, joint, block)."""
    betas = _ceil16(d) * mma_stride(K) // 2 if mma else K * _ceil4(d)
    floats = (groups * betas + 2 * _V_CELLS * K + (groups + 1) * (_ceil16(K) if mma else K) * _V_LP
              + 2 * (-(-K * B // 4) * 4))
    return 4 * (floats + 2 * ncov * _V_CELLS + 3 * span + ncov)


def virtual_plan(K: int, d: int, B: int, ncov: int, span: int,
                 mma: bool = False) -> Optional[Tuple[int, int]]:
    """(correction groups, shared memory bytes) of K10's CTA: two groups
    where both leave the chain eight warps (d <= 64) and fit, else one;
    None where K10 cannot take the shape: K over 256, d over 192 (the dims
    12 warps cover in 4 x 8 tiles) or one group past shared memory."""
    warps = -(-8 * -(-d // 4) // 32)  # a group's warps
    if K > _V_MAX_K or warps > _V_CORR_WARPS:
        return None
    for groups in range(_V_GROUPS if _V_GROUPS * warps <= 8 else 1, 0, -1):
        smem = virtual_smem_bytes(K, d, B, ncov, span, groups, mma)
        if smem <= _SMEM_MAX:
            return groups, smem
    return None


def _k10_plan(cfg: HarmonyConfig, d: int, n_tiles: int, dev):
    """(grid, span, virtual_plan) of K10 over ``n_tiles`` layout tiles: one
    CTA an SM, each over an equal range of at most ``span`` tiles."""
    grid = min(n_tiles, _sm_count(dev))
    span = -(-n_tiles // grid)
    return grid, span, virtual_plan(cfg.K, d, cfg.B, cfg.n_covariates, span,
                                    cfg.bf16_products)


def k10_fits(cfg: HarmonyConfig, d: int, n_tiles: int, dev) -> bool:
    """Does K10 take d dims over ``n_tiles`` layout tiles on the card
    ``dev``? Where it does not, the correction writes R with K11 and
    applies it with K9 (``ops.ridge.virtual_tile_correction``)."""
    return _k10_plan(cfg, d, n_tiles, dev)[2] is not None


def tile_steps(tile: int) -> int:
    """The most 64-cell pieces a layout tile of ``tile`` cells meets (tiles
    and pieces both start at cell 0): ``tile / 64`` where tiles are whole
    pieces, else one or two more (3 for 160 cells). K10 walks a tile in
    this many steps; K7's moments split a piece across two tiles."""
    return max((a + tile - 1) // _CT - a // _CT + 1
               for a in range(0, _CT * tile, tile))


def _check(where: str, cfg: HarmonyConfig, floats: dict, codes: torch.Tensor,
           storage: Optional[dict] = None):
    """Same device; on the card ``floats`` contiguous float32 (Y may be a
    strided view: the wrappers copy Y^T for the kernel) and ``storage``
    contiguous in a dtype of :data:`STORAGE`; raises otherwise."""
    storage = storage or {}
    dev = codes.device
    for name, t in {**floats, **storage, "codes": codes}.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, codes on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{where}: unsupported device {dev}")
    if dev.type == "cpu":
        return
    for name, t in floats.items():
        if t.dtype != _F32 or not (t.is_contiguous() or name == "Y"):
            raise TypeError(f"{where}: {name} must be contiguous float32")
    for name, t in storage.items():
        if t.dtype not in STORAGE or not t.is_contiguous():
            raise TypeError(f"{where}: {name} must be contiguous float32, bfloat16 or "
                            f"float16, got {t.dtype}")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise TypeError(f"{where}: codes must be contiguous int32")
    T = cfg.estep_sub_tile
    if T % _CT or codes.shape[1] % T:
        raise ValueError(f"{where}: the layout ({codes.shape[1]} cells) must be "
                         f"whole tiles of {T} cells, a multiple of {_CT}")


def _check_smem(where: str, cfg: HarmonyConfig, smem: int) -> None:
    if smem > _SMEM_MAX:
        raise ValueError(
            f"{where}: K={cfg.K}, d={cfg.d}, B={cfg.B} need {smem} bytes of shared "
            f"memory a CTA, over the {_SMEM_MAX} a CTA may use"
        )


@graphs.device_cache(maxsize=4)
def _tile_slots(tj_bytes: bytes, n_joint: int, device: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's moment rows, one per layout tile, laid out joint by joint
    (tiles ascending within a joint): (slot (n_tiles,) row of each layout
    tile, start (n_joint + 2,) first row of each joint), on the card once
    per table."""
    tj = np.frombuffer(tj_bytes, dtype=np.int32)
    order = np.argsort(tj, kind="stable")
    slot = np.empty(len(tj), np.int32)
    slot[order] = np.arange(len(tj), dtype=np.int32)
    start = np.searchsorted(tj[order], np.arange(n_joint + 2)).astype(np.int32)
    return torch.as_tensor(slot, device=device), torch.as_tensor(start, device=device)


@graphs.device_cache(maxsize=4)
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
    """K6; returns (Zn (d, NT*T), tile_O (NT, K, B), O (K, B), E (K, B),
    G (NT*T, K)), all float32; Z_raw float32, bf16 or float16; G in the
    bf16 product form under ``cfg.bf16_products``."""
    _check("reassign", cfg, {"Y": Y, "sigma": sigma, "Pr_b": Pr_b}, codes_pad,
           {"Z_raw": Z_raw})
    if Z_raw.device.type == "cpu":
        return rotate.reassign(cfg, Y, sigma, Pr_b, Z_raw, codes_pad)
    d, L = Z_raw.shape
    K, B, T = cfg.K, cfg.B, cfg.estep_sub_tile
    NT = L // T
    dev = Z_raw.device
    if Z_raw.data_ptr() % 16 or codes_pad.data_ptr() % 16:
        raise ValueError("reassign: Z_raw and codes_pad must start on 16-byte boundaries "
                         "(the kernel copies 16 bytes at a time)")
    mma = cfg.bf16_products
    splits, smem = reassign_plan(K, d, B, cfg.n_covariates, mma)
    grid = min(L // _CT, _k6_grid(smem, _sm_count(dev), storage_code(Z_raw), mma))
    K8 = -(-K // 8) * 8
    Yt = Y.t().contiguous()
    Yb = y_bf16(Y, K8) if mma else None
    Zn = torch.empty((d, L), dtype=_F32, device=dev)
    G = torch.empty((L, K), dtype=_F32, device=dev)
    part = torch.empty((L // _CT, K * B), dtype=_F32, device=dev)
    tile_O = torch.empty((NT, K, B), dtype=_F32, device=dev)
    O = torch.empty((K, B), dtype=_F32, device=dev)
    E = torch.empty((K, B), dtype=_F32, device=dev)
    # the reduce's arrival counts, zeroed by the assign launch
    n_chunk = reduce_chunks(K, B)
    count = torch.empty(n_chunk + 1, dtype=torch.int32, device=dev)
    _build.check(_lib("rotate").k6_reassign(
        Yt.data_ptr(), None if Yb is None else Yb.data_ptr(), Z_raw.data_ptr(),
        codes_pad.data_ptr(), _offsets_on(cfg.covariate_offsets, str(dev)).data_ptr(),
        sigma.data_ptr(), Pr_b.data_ptr(),
        Zn.data_ptr(), G.data_ptr(), part.data_ptr(), tile_O.data_ptr(), O.data_ptr(),
        E.data_ptr(), count.data_ptr(), L, NT, K, d, B, cfg.n_covariates, cfg.B_vec[0],
        K8, splits, grid, n_chunk, storage_code(Z_raw), int(mma), mma_stride(d), _ceil16(d),
        smem, torch.cuda.current_stream(dev).cuda_stream,
    ), "k6_reassign")
    graphs.count(reassign)
    return Zn, tile_O, O, E, G


reassign.launches = 0


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
    """K7: one stats-carrying round for the round's row ``sched`` of the
    schedule table (``rotate.draw_schedules``: rotation, block order), g
    read from the phase's Gram table ``layout.G`` (K6's); with ``moments``
    and ``emit_pen`` the extras of a phase's last round. R, E and O come back
    in the dtypes of ``rs``'s (the kernel's float32 cast, as
    pallas_rotate.py:1036-1043 casts), and ``moments.Z_orig`` may be bf16
    or float16. The launches read the schedule where it lies: the host
    issues the same launches for every schedule and reads nothing."""
    floats = {"Y": Y, "tile_O": rs.tile_O, "Pr_b": Pr_b, "sigma": sigma, "theta": theta,
              "Z_pad": layout.Z_pad}
    storage = {"R": rs.R, "E": rs.E, "O": rs.O}
    if moments is not None:
        storage["Z_orig"] = moments.Z_orig
    _check("rotate_update_round_v2", cfg, floats, layout.codes_pad, storage)
    if Y.device.type == "cpu":
        return rotate.rotate_update_round_v2(cfg, Y, rs, Pr_b, sigma, theta, sched, layout,
                                             write_r, moments, emit_pen)
    d, L = layout.Z_pad.shape
    K, B, T = cfg.K, cfg.B, cfg.estep_sub_tile
    NT = L // T
    if rs.tile_O.shape != (NT, K, B) or rs.R.shape != (K, L):
        raise ValueError("rotate_update_round_v2: tile_O/R shapes disagree with the layout")
    G = layout.G
    if (G is None or G.shape != (L, K) or G.dtype != _F32 or not G.is_contiguous()
            or G.device != Y.device):
        raise ValueError("rotate_update_round_v2: the kernel reads g from the layout's "
                         f"Gram table, a contiguous float32 ({L}, {K}) tensor on {Y.device} "
                         "(K6 returns it)")
    szs, _ = rotate.block_sizes(cfg, NT)
    nb, big = len(szs), max(szs)
    dev = Y.device
    if (sched.shape != (1 + nb,) or sched.dtype != torch.int32 or sched.device != dev
            or not sched.is_contiguous()):
        raise ValueError(f"rotate_update_round_v2: sched must be the round's contiguous "
                         f"int32 row (1 + {nb},) of the schedule table on {dev}")
    blocks = rotate.block_table(cfg, NT, dev)
    ncov, b0 = cfg.n_covariates, cfg.B_vec[0]
    tw, M, mom = _CT, None, (None,) * 5
    if moments is not None:
        tw, nj = int(moments.tile), int(moments.n_joint)
        tj = np.asarray(moments.tile_joint, dtype=np.int32)
        if (tw < _CT or T % tw or tj.shape != (L // tw,)
                or tj.max(initial=0) > nj or moments.Z_orig.shape != (d, L)):
            raise ValueError("rotate_update_round_v2: the moments spec does not fit the "
                             "layout (layout tiles of at least 64 cells dividing the tile)")
        slot, start = _tile_slots(tj.tobytes(), nj, str(dev))
        mpart = torch.empty((L // tw, K * (d + 1)), dtype=_F32, device=dev)
        M = torch.empty((nj + 1, K, d + 1), dtype=_F32, device=dev)
        # one block's pieces' (K4 x d1p) tables (two a piece where layout
        # tiles are not whole pieces: its cells on each side of a tile
        # boundary), and a count per layout tile of a block
        mpiece = torch.empty((big * T // _CT * (1 if tw % _CT == 0 else 2),
                              -(-K // 4) * 4 * _ceil4(d + 1)), dtype=_F32, device=dev)
        count = torch.zeros(big * T // tw, dtype=torch.int32, device=dev)
        mom = (moments.Z_orig, slot, mpart, mpiece, count)
    smem = assign_smem_bytes(K, d, B, ncov, moments is not None)
    _check_smem("rotate_update_round_v2", cfg, smem)
    cpt = T // _CT  # assign CTAs per tile
    E_w = torch.empty((K, B), dtype=_F32, device=dev)
    O_w = torch.empty((K, B), dtype=_F32, device=dev)
    pen = torch.empty((K, B), dtype=_F32, device=dev)
    logpen = torch.empty((K, B), dtype=_F32, device=dev)
    acc = torch.empty(2, dtype=_F32, device=dev)
    tile_O = torch.empty_like(rs.tile_O)
    R_out = torch.empty((K, L), dtype=_F32, device=dev) if write_r else None
    E_in, O_in = rs.E.to(_F32), rs.O.to(_F32)
    pen_out = torch.empty((nb, K, B), dtype=_F32, device=dev) if emit_pen else None
    part = torch.empty((big * cpt, K * B + 2), dtype=_F32, device=dev)
    offsets = _offsets_on(cfg.covariate_offsets, str(dev))
    lib, alib = _lib("rotate"), _lib_for(tw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    # the launches' pointer arguments, read once: the loop below issues
    # 2 * n_blocks + 1 launches a round, and the host builds each one
    a_ptrs = (G.data_ptr(), layout.codes_pad.data_ptr(), offsets.data_ptr(), pen.data_ptr(),
              logpen.data_ptr(), sigma.data_ptr(), ptr(R_out), part.data_ptr(),
              *[ptr(t) for t in mom], sched.data_ptr(), blocks.data_ptr())
    c_head = (part.data_ptr(), sched.data_ptr(), blocks.data_ptr())
    c_tO = (tile_O.data_ptr(), rs.tile_O.data_ptr())
    c_in = ((E_in.data_ptr(), O_in.data_ptr()), (E_w.data_ptr(), O_w.data_ptr()))
    c_tail = (E_w.data_ptr(), O_w.data_ptr(), Pr_b.data_ptr(), theta.data_ptr(),
              pen.data_ptr(), logpen.data_ptr(), ptr(pen_out), int(emit_pen), acc.data_ptr(),
              K, B, b0, stream)
    d1p, lg = _ceil4(d + 1), legacy(cfg)
    zst = storage_code(moments.Z_orig) if moments is not None else 0

    def commit(pos: int) -> None:
        # after the block at position pos (-1: the round's first commit)
        _build.check(lib.k7_commit(*c_head, pos, nb, big, cpt, NT, *c_tO,
                                   *c_in[0 if pos < 0 else 1], *c_tail), "k7_commit")

    commit(-1)
    for pos in range(nb):
        _build.check(alib.k7_assign(
            *a_ptrs, L, pos, nb, big, NT, cpt, tw, K, d, B, ncov, d1p, lg, zst, smem, stream,
        ), "k7_assign")
        commit(pos)
    if moments is not None:
        sum_joint_rows(mpart, start, M)
    # the round's launches, counted where they were issued, in one add (a
    # captured round adds them on the device once, not once a launch)
    graphs.count(rotate_update_round_v2, 2 * nb + 1 + (moments is not None))
    return RoundState(R=R_out.to(rs.R.dtype) if write_r else rs.R, E=E_w.to(rs.E.dtype),
                      O=O_w.to(rs.O.dtype), tile_O=tile_O,
                      kmeans_error=acc[0], entropy=acc[1], M=M, pen=pen_out,
                      blkmap=rotate.block_of_tiles(cfg, sched[0], dev, NT) if emit_pen else None)


rotate_update_round_v2.launches = 0


def _check_virtual(where: str, cfg: HarmonyConfig, floats: dict, codes_pad: torch.Tensor,
                   blk_of_phys: torch.Tensor, storage: Optional[dict] = None) -> bool:
    """True for CUDA tensors that K10/K11 take, False for CPU tensors (the
    plain version runs); raises for anything else."""
    _check(where, cfg, floats, codes_pad, storage)
    if codes_pad.device.type == "cpu":
        return False
    d, L = floats["Zn_pad"].shape
    NT = L // cfg.estep_sub_tile
    pen = floats["pen"]
    if (floats["Y"].shape != (d, cfg.K) or pen.shape[1:] != (cfg.K, cfg.B)
            or blk_of_phys.shape != (NT,) or blk_of_phys.dtype != torch.int32
            or blk_of_phys.device != codes_pad.device):
        raise ValueError(f"{where}: Y, pen or the tile -> block map disagree with the "
                         "layout (the map must be int32 on the card)")
    return True


def virtual_correction(
    cfg: HarmonyConfig,
    W_joint: torch.Tensor,  # (n_joint + 1, d, K); trash row zero
    tile_joint,  # (Npt // layout_tile,) int32, trash tiles n_joint
    layout_tile: int,
    Y: torch.Tensor,  # (d, K)
    sigma: torch.Tensor,  # (K,)
    pen: torch.Tensor,  # (nb, K, B)
    blk_of_phys: torch.Tensor,  # (NT,) int32
    Zn_pad: torch.Tensor,  # (d, Npt)
    codes_pad: torch.Tensor,  # (ncov, Npt) int32
    Z_orig_pad: torch.Tensor,  # (d, Npt)
    G: Optional[torch.Tensor] = None,  # (Npt, K) the phase's Gram table (K6's)
) -> torch.Tensor:
    """K10: Z_corr (d, Npt) = Z_orig - W_joint[joint(tile)] R, R recomputed
    from the penalty tables and the phase's Gram table ``G``, which the
    kernel needs; the plain version forms g from Y and Zn without it.
    Z_orig float32, bf16 or float16; Z_corr comes back in its dtype. Under
    ``cfg.bf16_products`` W R takes the bf16 product form, which the
    kernel runs on 2-byte storage only (a float32 engine takes none)."""
    floats = {"Y": Y, "sigma": sigma, "pen": pen, "Zn_pad": Zn_pad, "W_joint": W_joint}
    if G is not None:
        floats["G"] = G
    if not _check_virtual("virtual_correction", cfg, floats, codes_pad, blk_of_phys,
                          {"Z_orig_pad": Z_orig_pad}):
        return rotate.virtual_correction(cfg, W_joint, tile_joint, layout_tile, Y, sigma,
                                         pen, blk_of_phys, Zn_pad, codes_pad, Z_orig_pad, G)
    K, B, T = cfg.K, cfg.B, cfg.estep_sub_tile
    d, L = Zn_pad.shape
    dev = Zn_pad.device
    nj1 = W_joint.shape[0]
    tj = np.asarray(tile_joint, dtype=np.int32)
    if (W_joint.shape != (nj1, d, K) or layout_tile < _CT or T % layout_tile
            or tj.shape != (L // layout_tile,) or tj.max(initial=0) >= nj1
            or Z_orig_pad.shape != (d, L)):
        raise ValueError("virtual_correction: W_joint, the tile table or the layout tile "
                         f"({layout_tile}) do not fit the layout and the kernel")
    if G is None or G.shape != (L, K):
        raise ValueError("virtual_correction: the kernel reads g from the phase's Gram "
                         f"table, a contiguous float32 ({L}, {K}) tensor on {dev} (K6 "
                         "returns it)")
    order = plan_order(tj, dev)
    n = order.shape[0]
    grid, span, plan = _k10_plan(cfg, d, n, dev)
    if plan is None:
        raise ValueError(
            f"virtual_correction: K={K}, d={d}, B={B} do not fit K10: it takes K <= "
            f"{_V_MAX_K}, d <= {16 * _V_CORR_WARPS} and one correction group's "
            f"{virtual_smem_bytes(K, d, B, cfg.n_covariates, span, 1)} bytes of shared "
            f"memory within {_SMEM_MAX} (K11 then K9 take the rest: k10_fits)")
    groups, smem = plan
    mma = cfg.bf16_products
    if mma and Z_orig_pad.dtype == _F32:
        raise TypeError("virtual_correction: the bf16 product form takes Z_orig in bf16 or "
                        "float16 (a reduced-precision engine's), got float32")
    Wk = w_bf16(W_joint) if mma else W_joint
    Zc = torch.empty_like(Z_orig_pad)
    if any(t.data_ptr() % 16 for t in (G, codes_pad, Z_orig_pad, Zc)):
        raise ValueError("virtual_correction: G, codes_pad and Z_orig_pad must start on "
                         "16-byte boundaries (the kernel copies 16 bytes at a time)")
    _build.check(_k10_lib(layout_tile, mma).k10_virtual_correction(
        G.data_ptr(), codes_pad.data_ptr(),
        _offsets_on(cfg.covariate_offsets, str(dev)).data_ptr(), pen.data_ptr(),
        blk_of_phys.data_ptr(), sigma.data_ptr(), Wk.data_ptr(), order.data_ptr(),
        _table_on(tj.tobytes(), str(dev)).data_ptr(), Z_orig_pad.data_ptr(), Zc.data_ptr(),
        L, n, span, T, layout_tile, tile_steps(layout_tile), nj1 - 1, K, d, _ceil4(d), B,
        cfg.n_covariates, groups, legacy(cfg), storage_code(Z_orig_pad), int(mma),
        mma_stride(K), _ceil16(d), grid, smem, torch.cuda.current_stream(dev).cuda_stream,
    ), "k10_virtual_correction")
    graphs.count(virtual_correction)
    return Zc


virtual_correction.launches = 0


def materialize_r(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    sigma: torch.Tensor,  # (K,)
    pen: torch.Tensor,  # (nb, K, B)
    blk_of_phys: torch.Tensor,  # (NT,) int32
    Zn_pad: torch.Tensor,  # (d, Npt)
    codes_pad: torch.Tensor,  # (ncov, Npt) int32
    out_dtype=None,
) -> torch.Tensor:
    """K11: the last round's R (K, Np), rebuilt from the penalty tables, in
    ``out_dtype`` (float32 by default, or bf16 or float16: the kernel
    stores each value rounded to nearest even, as pallas_rotate.py:
    1642-1645 casts); g in the bf16 product form under
    ``cfg.bf16_products``, K6's."""
    floats = {"Y": Y, "sigma": sigma, "pen": pen, "Zn_pad": Zn_pad}
    if not _check_virtual("materialize_r", cfg, floats, codes_pad, blk_of_phys):
        return rotate.materialize_r(cfg, Y, sigma, pen, blk_of_phys, Zn_pad, codes_pad,
                                    out_dtype)
    out_dtype = out_dtype or _F32
    if out_dtype not in STORAGE:
        raise TypeError(f"materialize_r: the kernel writes float32, bfloat16 or float16, not "
                        f"{out_dtype}")
    K, B, T = cfg.K, cfg.B, cfg.estep_sub_tile
    d, L = Zn_pad.shape
    dev = Zn_pad.device
    if Zn_pad.data_ptr() % 16 or codes_pad.data_ptr() % 16:
        raise ValueError("materialize_r: Zn_pad and codes_pad must start on 16-byte boundaries "
                         "(the kernel copies 16 bytes at a time)")
    mma = cfg.bf16_products
    plan = materialize_r_plan(K, d, B, cfg.n_covariates, mma)
    K8 = _ceil(K, 8)
    # the centroids as the kernel reads them: (d, K8), zero past K, or in
    # the product form Y^T in bf16 as K6 reads it
    Yp = y_bf16(Y, K8) if mma else torch.nn.functional.pad(Y, (0, K8 - K)).contiguous()
    R = torch.empty((K, L), dtype=out_dtype, device=dev)
    _build.check(_k11_lib(mma).k11_materialize_r(
        Yp.data_ptr(), Zn_pad.data_ptr(), codes_pad.data_ptr(),
        _offsets_on(cfg.covariate_offsets, str(dev)).data_ptr(), pen.data_ptr(),
        blk_of_phys.data_ptr(), sigma.data_ptr(), R.data_ptr(), L, T, K, d, B,
        cfg.n_covariates, K8, plan.kj, int(plan.ys_shared), legacy(cfg), storage_code(R),
        int(mma), mma_stride(d), _ceil16(d),
        materialize_r_grid(L // _CT, plan.smem, _sm_count(dev)), plan.smem,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "k11_materialize_r")
    graphs.count(materialize_r)
    return R[:, : cfg.Np]


materialize_r.launches = 0
