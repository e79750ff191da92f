"""K1 and K12: the wrappers of the E-step round kernels.

Counterparts of ``harmony_tpu/ops/pallas_estep.py``
(``pallas_block_update_round``) and ``harmony_tpu/ops/pallas_rotate.py``
(``pallas_rotate_update_round``), drop-ins for their plain versions
:func:`harmony_tpu_torch.ops.estep.block_update_round` and
:func:`harmony_tpu_torch.ops.rotate.rotate_update_round_v1`. The CUDA
source of both is ``csrc/estep_round.cu``.

For CUDA tensors the round is a host loop over the blocks. K1
(:func:`block_update_round`) makes a cell-major copy of Z; one launch
tables the block of each column of the input R and its batch rows, one
sums the old R, read once and coalesced, into a table of old statistics
(one row per block and span of columns), one commit removes block 0's;
then each block gets an assign launch over its positions of the
permutation (the kernel reads Z and the codes through the permutation and
writes the new R at the positions, coalesced: no gather, one-hot or
scatter in PyTorch) and a commit that folds the block's partials into E/O
in a fixed order and removes the next block's old contribution. R comes
in with its columns in any order (``order``) and goes out in the round's
block order; the engine carries it so through a phase and puts it back in
the cells' order once at its end. Blocks
are contiguous ranges of the permutation, so no pad slots exist. 2 *
n_blocks + 3 launches a round. For CPU tensors the wrapper runs the plain
version; anything else raises. ``launches`` counts calls into the
kernels' C entry points.

K12 (:func:`rotate_update_round_v1`) runs the same assign and commit
kernels on the rotate schedule's physical layout, with no gather or
scatter: one launch first sums the old R per span of cells into a table
of old statistics, then one commit removes the first block's, and each
block gets an assign launch over its tiles (which may wrap past the last
tile) and a commit that removes the next block's old statistics, the
sum of its tiles' rows. The launches read the round's row of the schedule
table on the device (the rotation, then the block order) and the block
table (``rotate.block_table``), as K7's do: each assign launch has the
largest block's CTAs, those past its block's cells return at once, and
each commit sums its block's CTAs' partials. 2 * nb + 2 launches a round.
In both rounds the new R is another buffer than the input R.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _build, graphs
from ..config import HarmonyConfig
from . import rotate
from .assign import block_bounds
from .estep import RoundResult, block_update_round as block_update_round_twin

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_SMEM_SM = 233_472  # bytes of shared memory an SM has for its CTAs
_WARPS = 8  # kWarps in estep_round.cu
_CT_OLD = 64  # kCT of old_stats_kernel
_BS_COLS, _BS_STAGES = 32, 4  # block_stats_kernel: columns a slice, slices in flight
_SIGNATURES = {
    "k1_assign": [_build.PTR] * 8 + [_build.I64, _build.I64] + [_build.INT] * 7
    + [_build.PTR],
    "k1_keys": [_build.PTR] * 6 + [_build.INT] * 4 + [_build.PTR],
    "k1_block_stats": [_build.PTR] * 4 + [_build.I64] + [_build.INT] * 8 + [_build.PTR],
    "k1_commit": [_build.PTR, _build.INT, _build.PTR, _build.PTR, _build.PTR]
    + [_build.INT] * 3 + [_build.PTR] * 4 + [_build.INT] * 3 + [_build.PTR],
    "k12_old_stats": [_build.PTR] * 3 + [_build.I64] + [_build.INT] * 5 + [_build.PTR],
    "k12_assign": [_build.PTR] * 7 + [_build.I64] + [_build.INT] * 7 + [_build.PTR] * 2
    + [_build.INT] * 4 + [_build.PTR],
    "k12_commit": [_build.PTR] * 8 + [_build.INT] * 2 + [_build.PTR] * 2 + [_build.INT] * 6
    + [_build.PTR],
}


def _reduced(*tensors: torch.Tensor) -> bool:
    """Does a reduced-precision engine's state (bf16, float16) reach this
    float32 kernel?"""
    return any(t.dtype in (torch.bfloat16, torch.float16) for t in tensors)


def f32(*tensors: torch.Tensor):
    """float32 copies of a reduced-precision engine's tensors (float32 ones
    as they are)."""
    return [t.to(_F32) for t in tensors]


def cast_back(res: RoundResult, R, E, O) -> RoundResult:
    """A round's R, E and O cast to the dtypes of its inputs."""
    return res._replace(R=res.R.to(R.dtype), E=res.E.to(E.dtype), O=res.O.to(O.dtype))


def assign_smem_bytes(K: int, d: int, B: int, ncov: int, T: int) -> int:
    """Shared memory of one assign CTA over T cells (layout in the .cu)."""
    dp, Bp = -(-d // 4) * 4, B | 1
    floats = (max((K + T) * dp, _WARPS * K * Bp) + K * (T + 1) + K * Bp + K
              + _WARPS * K + 2 * _WARPS)
    return 4 * (floats + T + ncov * T)


def block_stats_smem_bytes(K: int, B: int, ncov: int, nb: int, KS: int) -> int:
    """Shared memory of one K1 old-statistics CTA over KS cluster rows."""
    stage = KS * (_BS_COLS + 1) + (1 + ncov) * _BS_COLS
    return 4 * (nb * (B + 1) * KS + _BS_STAGES * stage)


def _stats_slice(K: int, B: int, ncov: int, nb: int) -> Tuple[int, int]:
    """Cluster rows of one old-statistics CTA (at most 128, a lane's four),
    the most whose table fits, and its shared memory."""
    for KS in range(min(K, 128), 0, -8):
        smem = block_stats_smem_bytes(K, B, ncov, nb, KS)
        if smem <= _SMEM_MAX:
            return KS, smem
    raise ValueError(f"block_update_round: {nb} blocks x B={B} need more than "
                     f"{_SMEM_MAX} bytes of shared memory at 8 clusters a CTA")


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def old_stats_smem_bytes(K: int, B: int, ncov: int) -> int:
    """Shared memory of one K12 old-statistics CTA."""
    return 4 * (K * (_CT_OLD + 1) + K * B + K + ncov * _CT_OLD)


@functools.lru_cache(maxsize=64)
def cell_tile(K: int, d: int, B: int, ncov: int, ncells: int, n_sm: int) -> int:
    """Cells per assign CTA (a multiple of 16, at most 128) for a block of
    ``ncells`` cells on a card of ``n_sm`` SMs: the least T whose CTAs fill
    the card in one wave (two CTAs an SM where shared memory allows), so
    every SM gets an even share; where no T does, the largest that fits,
    which takes the fewest waves."""
    fitting = [T for T in range(16, 129, 16) if assign_smem_bytes(K, d, B, ncov, T) <= _SMEM_MAX]
    if not fitting:
        raise ValueError(
            f"E-step kernel: K={K}, d={d}, B={B}, {ncov} covariate(s) need "
            f"{assign_smem_bytes(K, d, B, ncov, 16)} bytes of shared memory at 16 "
            f"cells a CTA, over the {_SMEM_MAX} a CTA may use"
        )
    for T in fitting:
        per_sm = min(2, _SMEM_SM // (assign_smem_bytes(K, d, B, ncov, T) + 1024))
        if -(-ncells // T) <= per_sm * n_sm:
            return T
    return fitting[-1]


def block_update_round(
    cfg: HarmonyConfig,
    Z: torch.Tensor,  # (d, N)
    Y: torch.Tensor,  # (d, K)
    R: torch.Tensor,  # (K, N)
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    codes: torch.Tensor,  # (ncov, N) int32
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    perm: torch.Tensor,  # (N,)
    order: Optional[torch.Tensor] = None,
) -> RoundResult:
    """One update_R round; the kernel on CUDA, the plain version with
    ``carry=True`` on CPU: R's columns hold the cells ``order`` (None: in
    order), and the new R comes back in the round's block order, as the
    kernels write it. A reduced-precision engine's round runs on float32
    copies made here, and R, E and O go back in their dtypes, as
    ``pallas_block_update_round`` casts (pallas_estep.py:160-251)."""
    if _reduced(Z, Y, R, E, O, Pr_b, sigma, theta):
        res = block_update_round(cfg, *f32(Z, Y, R, E, O), codes, *f32(Pr_b, sigma, theta),
                                 perm, order)
        return cast_back(res, R, E, O)
    dev = Z.device
    floats = {"Z": Z, "Y": Y, "R": R, "E": E, "O": O, "Pr_b": Pr_b,
              "sigma": sigma, "theta": theta}
    for name, t in {**floats, "codes": codes}.items():
        if t.device != dev:
            raise ValueError(f"block_update_round: {name} is on {t.device}, Z on {dev}")
    if dev.type == "cpu":
        return block_update_round_twin(cfg, Z, Y, R, E, O, codes, Pr_b, sigma,
                                       theta, perm, order=order, carry=True)
    if dev.type != "cuda":
        raise ValueError(f"block_update_round: unsupported device {dev}")
    for name, t in floats.items():
        if t.dtype != _F32:
            raise TypeError(f"block_update_round: {name} must be float32, got {t.dtype}")
    K, N = R.shape
    d, B, ncov = Z.shape[0], cfg.B, cfg.n_covariates
    if (Z.shape != (d, N) or Y.shape != (d, K) or E.shape != (K, B)
            or O.shape != (K, B) or codes.shape != (ncov, N)
            or perm.shape != (N,) or (order is not None and order.shape != (N,))):
        raise ValueError("block_update_round: argument shapes disagree with the config")
    T = cell_tile(K, d, B, ncov, cfg.max_block_size, _sm_count(dev))
    smem = assign_smem_bytes(K, d, B, ncov, T)
    nb = cfg.n_blocks
    KS, smem_stats = _stats_slice(K, B, ncov, nb)
    n_slices = -(-K // KS)
    n_spans = max(1, -(-_sm_count(dev) // n_slices))
    span = -(-(-(-N // n_spans)) // 32) * 32
    n_spans = -(-N // span)

    perm = perm.to(device=dev, dtype=torch.int32).contiguous()
    if order is not None:
        order = order.to(device=dev, dtype=torch.int32).contiguous()
    off = graphs.device_table(cfg.covariate_offsets, np.int32, dev)
    gcodes = (codes + off[:, None]).to(torch.int32).contiguous()
    Zc = Z.t().contiguous()  # (N, d): one contiguous row a cell
    blk = torch.empty((N,), dtype=torch.int32, device=dev)
    bq = torch.empty((N,), dtype=torch.int32, device=dev)
    gq = torch.empty((ncov, N), dtype=torch.int32, device=dev)

    Yt = Y.t().contiguous()
    E_w, O_w = E.contiguous().clone(), O.contiguous().clone()
    Pr_c, sig_c, th_c = Pr_b.contiguous(), sigma.contiguous(), theta.contiguous()
    R_c = R.contiguous()
    pen = torch.empty((K, B), dtype=_F32, device=dev)
    acc = torch.zeros(2, dtype=_F32, device=dev)
    R_out = torch.empty((K, N), dtype=_F32, device=dev)
    P = K + K * B + 2
    old = torch.empty((nb * n_spans, P), dtype=_F32, device=dev)
    part = torch.empty((-(-cfg.max_block_size // T), P), dtype=_F32, device=dev)
    lib = _build.load("estep_round", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    _build.check(lib.k1_keys(
        perm.data_ptr(), None if order is None else order.data_ptr(), gcodes.data_ptr(),
        blk.data_ptr(), bq.data_ptr(), gq.data_ptr(), N, ncov, cfg.cells_per_block, nb,
        stream), "k1_keys")
    _build.check(lib.k1_block_stats(
        R_c.data_ptr(), bq.data_ptr(), gq.data_ptr(), old.data_ptr(), N, span, n_spans, K,
        B, ncov, nb, KS, smem_stats, stream), "k1_block_stats")
    graphs.count(block_update_round, 2)

    def commit(ncta: int, add: int, rm: int) -> None:
        _build.check(lib.k1_commit(
            part.data_ptr(), ncta, E_w.data_ptr(), O_w.data_ptr(), old.data_ptr(),
            max(rm, 0) * n_spans, n_spans if rm >= 0 else 0, nb * n_spans, Pr_c.data_ptr(),
            th_c.data_ptr(), pen.data_ptr(), acc.data_ptr(), K, B, add, stream,
        ), "k1_commit")
        graphs.count(block_update_round)

    commit(0, 0, 0)
    for i, (start, size) in enumerate(block_bounds(cfg)):
        if size:  # a tiny block_size can leave blocks empty; a 0-CTA launch is refused
            _build.check(lib.k1_assign(
                Yt.data_ptr(), Zc.data_ptr(), gcodes.data_ptr(), perm.data_ptr(),
                pen.data_ptr(), sig_c.data_ptr(), R_out.data_ptr(), part.data_ptr(), N,
                start, size, K, d, B, ncov, T, smem, stream,
            ), "k1_assign")
            graphs.count(block_update_round)
        commit(-(-size // T), 1, i + 1 if i + 1 < nb else -1)
    return RoundResult(R=R_out, E=E_w, O=O_w, kmeans_error=acc[0], entropy=acc[1])


block_update_round.launches = 0


def rotate_update_round_v1(
    cfg: HarmonyConfig,
    Y: torch.Tensor,  # (d, K)
    R: torch.Tensor,  # (K, NT*T) the previous round's assignments
    E: torch.Tensor,  # (K, B)
    O: torch.Tensor,  # (K, B)
    Pr_b: torch.Tensor,  # (B,)
    sigma: torch.Tensor,  # (K,)
    theta: torch.Tensor,  # (B,)
    sched: Union[torch.Tensor, int],
    order: Optional[Sequence[int]],
    layout: rotate.CodesLayout,
) -> RoundResult:
    """K12: one rotate round that reads the old block statistics from R,
    for ``sched``, the round's row of the schedule table
    (``rotate.draw_schedules``: rotation, block order) with ``order``
    None, or the rotation with ``order`` the block order (host ints, made
    a row here); the kernels on CUDA, the plain version on CPU. The
    launches read the row where it lies, so the host issues the same
    launches for every schedule and reads nothing. A reduced-precision
    engine's round runs on float32 copies made here, and R, E and O go back
    in their dtypes (pallas_rotate.py:1780-1846)."""
    if _reduced(Y, R, E, O, Pr_b, sigma, theta, layout.Z_pad):
        res = rotate_update_round_v1(cfg, *f32(Y, R, E, O, Pr_b, sigma, theta), sched, order,
                                     layout._replace(Z_pad=layout.Z_pad.to(_F32)))
        return cast_back(res, R, E, O)
    codes = layout.codes_pad
    dev = codes.device
    floats = {"Y": Y, "R": R, "E": E, "O": O, "Pr_b": Pr_b, "sigma": sigma,
              "theta": theta, "Z_pad": layout.Z_pad}
    for name, t in floats.items():
        if t.device != dev:
            raise ValueError(f"rotate_update_round_v1: {name} is on {t.device}, codes on {dev}")
    if dev.type == "cpu":
        return rotate.rotate_update_round_v1(cfg, Y, R, E, O, Pr_b, sigma, theta, sched,
                                             order, layout)
    if dev.type != "cuda":
        raise ValueError(f"rotate_update_round_v1: unsupported device {dev}")
    for name, t in floats.items():
        # Y may be a strided view: the wrapper copies Y^T for the kernel
        if t.dtype != _F32 or not (t.is_contiguous() or name == "Y"):
            raise TypeError(f"rotate_update_round_v1: {name} must be contiguous float32")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise TypeError("rotate_update_round_v1: codes must be contiguous int32")
    d, L = layout.Z_pad.shape
    K, B, ncov, T = cfg.K, cfg.B, cfg.n_covariates, cfg.estep_sub_tile
    NT = L // T
    if (T % _CT_OLD or L % T or NT != rotate.n_tiles(cfg) or R.shape != (K, L)
            or Y.shape != (d, K) or E.shape != (K, B) or O.shape != (K, B)
            or codes.shape != (ncov, L)):
        raise ValueError(f"rotate_update_round_v1: the layout ({L} cells), R, Y, E or O "
                         f"disagree with the config (whole tiles of {T} cells, a "
                         f"multiple of {_CT_OLD})")
    szs, _ = rotate.block_sizes(cfg)
    nb = len(szs)
    if order is not None:
        sched = graphs.device_table([int(sched), *[int(b) for b in order]], np.int32, dev)
    if (sched.shape != (1 + nb,) or sched.dtype != torch.int32 or sched.device != dev
            or not sched.is_contiguous()):
        raise ValueError(f"rotate_update_round_v1: sched must be the round's contiguous "
                         f"int32 row (1 + {nb},) of the schedule table on {dev}")
    blocks = rotate.block_table(cfg, NT, dev)
    Tc = cell_tile(K, d, B, ncov, max(szs) * T, _sm_count(dev))
    grid = -(-max(szs) * T // Tc)  # the largest block's CTAs; the rest return
    smem = assign_smem_bytes(K, d, B, ncov, Tc)
    smem_old = old_stats_smem_bytes(K, B, ncov)
    if smem_old > _SMEM_MAX:
        raise ValueError(f"rotate_update_round_v1: K={K}, B={B} need {smem_old} bytes of "
                         f"shared memory a CTA, over the {_SMEM_MAX} a CTA may use")
    span = next(s for s in (512, 256, 128, 64) if T % s == 0)
    split = T // span  # rows of old statistics a tile
    off = graphs.device_table(cfg.covariate_offsets, np.int32, dev)
    gcodes = torch.where(codes >= 0, codes + off[:, None], -1).to(torch.int32).contiguous()
    P = K + K * B + 2
    old = torch.empty((NT * split, P), dtype=_F32, device=dev)
    part = torch.empty((grid, P), dtype=_F32, device=dev)
    Yt = Y.t().contiguous()
    E_w, O_w = E.clone(), O.clone()
    pen = torch.empty((K, B), dtype=_F32, device=dev)
    acc = torch.zeros(2, dtype=_F32, device=dev)
    R_out = torch.empty_like(R)
    lib = _build.load("estep_round", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s_ptrs = (sched.data_ptr(), blocks.data_ptr())

    _build.check(lib.k12_old_stats(R.data_ptr(), gcodes.data_ptr(), old.data_ptr(), L,
                                   span, K, B, ncov, smem_old, stream), "k12_old_stats")

    def commit(pos: int) -> None:
        # after the block at position pos (-1: the round's first commit)
        _build.check(lib.k12_commit(
            part.data_ptr(), E_w.data_ptr(), O_w.data_ptr(), old.data_ptr(), Pr_b.data_ptr(),
            theta.data_ptr(), pen.data_ptr(), acc.data_ptr(), K, B, *s_ptrs, pos, nb, NT,
            split, T, Tc, stream), "k12_commit")

    commit(-1)
    for pos in range(nb):
        _build.check(lib.k12_assign(
            Yt.data_ptr(), layout.Z_pad.data_ptr(), gcodes.data_ptr(), pen.data_ptr(),
            sigma.data_ptr(), R_out.data_ptr(), part.data_ptr(), L, K, d, B, ncov, Tc, T, NT,
            *s_ptrs, pos, nb, grid, smem, stream), "k12_assign")
        commit(pos)
    # the round's launches in one add (a captured round adds them on the
    # device once)
    graphs.count(rotate_update_round_v1, 2 * nb + 2)
    return RoundResult(R=R_out, E=E_w, O=O_w, kmeans_error=acc[0], entropy=acc[1])


rotate_update_round_v1.launches = 0
