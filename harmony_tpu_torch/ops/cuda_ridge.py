"""K4, K5, K8 and K9: the wrappers of the M-step kernels.

Counterpart of ``harmony_tpu/ops/pallas_ridge.py``. The CUDA sources are
``csrc/ridge.cu`` (K4, K5) and ``csrc/tiled.cu`` (K8, K9).

* :func:`moments` (K4) — M[k, b, e] = sum_n R[k,n] [code(n)==b] [Z;1][e,n]:
  per-batch ridge right-hand sides with the O row at ``[..., -1]``.
* :func:`correction` (K5) — Z_corr = Z - sum_k R[k,n] W[k, code(n), :]
  (src/harmony.cpp:613-616).
* :func:`tile_moments` (K8) — M[j] = sum over the layout tiles t of joint
  batch j of [R_t Z_t^T | R_t 1]; mixed/pad tiles land in the trash row
  j = n_joint (``pallas_tile_moments``).
* :func:`tiled_correction` (K9) — Z - W_joint[j(t)] R_t per layout tile;
  the trash row is zero, so mixed/pad tiles pass Z through
  (``pallas_tiled_correction``).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_twin``) for CPU tensors; anything else raises. ``launches``
counts calls into the kernel's C entry point.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build, graphs

_F32 = torch.float32
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_INDEX_TILES = (128, 64, 32, 16)  # cells a tile of the K4/K5 index, largest first
_K4_MAX_THREADS = 512  # kK4MaxThreads in ridge.cu
_K4_MIN_THREADS = 64  # below this, K4 keeps its accumulators in device memory
_K4_GLOBAL_PART_BYTES = 1 << 28  # the partials of K4's device-memory layout
_K5_THREADS = 384  # kK5Threads
_K5_W_FLOATS = 6 * 4 * _K5_THREADS  # kWRegs float4 registers a thread
_SIGNATURES = {
    "ridge_occupancy": [_build.INT] * 4,
    "k4_moments": [_build.PTR] * 6 + [_build.I64] + [_build.INT] * 12 + [_build.PTR],
    "k5_correction": [_build.PTR] * 7 + [_build.I64] + [_build.INT] * 10 + [_build.PTR],
}


class CellIndex(NamedTuple):
    """The cells of each tile of ``tile`` cells, batch by batch: ``order``
    (n_tiles, tile) int32, the tile's cell offsets ordered by code (stable),
    -1 on the slots past the last cell; ``runs`` (n_tiles, tile + 1) int32,
    the first slot of each run of one code in order, then the tile's cell
    count repeated. The codes are fixed for a run, so it is built once a run
    (``engine.mstep_layout``) and read by K4 and K5."""

    order: torch.Tensor
    runs: torch.Tensor

    @property
    def tile(self) -> int:
        return self.order.shape[1]


def cell_index(codes: torch.Tensor, B: int, tile: int) -> CellIndex:
    """The :class:`CellIndex` of (N,) codes in [0, B), on their device."""
    N = codes.shape[0]
    nt = -(-N // tile)
    key = torch.full((nt * tile,), B, dtype=torch.int64, device=codes.device)
    key[:N] = codes.long()
    key, order = torch.sort(key.view(nt, tile), dim=1, stable=True)
    valid = key < B
    order = torch.where(valid, order, torch.full_like(order, -1))
    start = valid.clone()
    start[:, 1:] &= key[:, 1:] != key[:, :-1]
    nv = valid.sum(dim=1, keepdim=True)
    slot = torch.arange(tile, device=codes.device).expand(nt, tile)
    rank = torch.cumsum(start, dim=1) - 1
    runs = nv.expand(nt, tile + 2).clone()
    runs.scatter_(1, torch.where(start, rank, tile + 1), torch.where(start, slot, nv))
    return CellIndex(order.to(torch.int32).contiguous(),
                     runs[:, : tile + 1].to(torch.int32).contiguous())


def _k4_plan(K: int, d: int, B: int, T: int):
    """K4's layout at tiles of T cells: (KS cluster rows a CTA, EP, the
    accumulators in device memory, threads, bytes of shared memory), or
    None if no layout fits. The accumulators of B batches stay in shared
    memory beside the two stages unless that leaves fewer than
    ``_K4_MIN_THREADS`` register tiles and the device-memory layout has more.
    Threads are a multiple of T: each copies one slot of every staged row."""
    EP = -(-(d + 1) // 4) * 4
    k4 = -(-K // 4) * 4

    def layout(KS, global_acc):
        floats = 2 * ((KS + EP) * (T + 4) + T)
        smem = 4 * (floats + (0 if global_acc else B * EP * KS))
        threads = -(-(KS // 4) * (EP // 4) // T) * T
        if smem <= _SMEM_MAX and threads <= _K4_MAX_THREADS:
            return KS, EP, global_acc, threads, smem
        return None

    def widest(global_acc):
        for ns in range(1, k4 // 4 + 1):
            plan = layout(-(-(-(-K // ns)) // 4) * 4, global_acc)
            if plan is not None:
                return plan
        return None

    def tiles(plan):  # threads that own a register tile
        return (plan[0] // 4) * (EP // 4)

    shared, glob = widest(False), widest(True)
    if shared is None or (tiles(shared) < _K4_MIN_THREADS and glob is not None
                          and tiles(glob) > tiles(shared)):
        return glob
    return shared


def _k5_plan(K: int, d: int, T: int):
    """K5's layout at tiles of T cells: (stages, WB floats a W buffer, dp,
    bytes of shared memory), or None if none fits: two stages where the W
    buffers keep half their full size, else one. A pass takes as many
    (4-slot chunk, run) entries as the threads cover in (8 dims x 4 slots)
    tiles, one a thread, and the W buffer holds its runs' betas for a k."""
    dp = -(-d // 4) * 4
    ne8 = -(-dp // 8)
    if ne8 > _K5_THREADS or T // 4 > 32:
        return None
    # a pass's runs: at most its entries, or the tile's cells
    need = min(T, _K5_THREADS // ne8) * dp
    plans = []
    for stages in (2, 1):
        floats = stages * ((K + d) * (T + 4) + 3 * T + 4) + 4 * T + 1
        WB = min(_K5_W_FLOATS, (_SMEM_MAX // 4 - floats) // 2 // 4 * 4)
        if WB >= need:
            plans.append((stages, WB, dp, 4 * (floats + 2 * WB)))
    # two stages unless that leaves the W buffers under half their size
    good = [p for p in plans if p[0] == 1 or p[1] >= _K5_W_FLOATS // 2]
    return (good or plans or [None])[0]


def index_tile(K: int, d: int, B: int):
    """The largest index tile at which both K4 and K5 take (K, d, B), or
    None."""
    for T in _INDEX_TILES:
        if _k4_plan(K, d, B, T) is not None and _k5_plan(K, d, T) is not None:
            return T
    return None


def _index_for(where, codes, B, K, d, index):
    """``index`` checked against the codes, or one built for them."""
    N = codes.shape[0]
    if index is None:
        T = index_tile(K, d, B)
        if T is None:
            raise ValueError(f"{where}: K={K}, d={d}, B={B} fit no layout of the kernel")
        return cell_index(codes, B, T)
    T = index.tile
    nt = -(-N // T)
    for name, t, shape in (("order", index.order, (nt, T)), ("runs", index.runs, (nt, T + 1))):
        if (t.device != codes.device or t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{where}: index.{name} must be a contiguous int32 {shape} "
                             f"tensor on {codes.device} for {N} cells in tiles of {T}")
    if T not in _INDEX_TILES:
        raise ValueError(f"{where}: index tiles of {T} cells; the kernels take {_INDEX_TILES}")
    return index


def _occupancy(lib, which: int, arg: int, threads: int, smem: int) -> int:
    n = lib.ridge_occupancy(which, arg, threads, smem)
    if n <= 0:
        raise RuntimeError(f"ridge_occupancy: {'K4' if which == 0 else 'K5'} fits no CTA "
                           f"on an SM (CUDA error {-n})")
    return n


def _check_inputs(where, tensors, codes=None):
    """Same device (that of ``codes``, else of the first tensor), float32
    and contiguous; ``codes`` a contiguous (N,) int32 tensor."""
    dev = codes.device if codes is not None else next(iter(tensors.values())).device
    what = "codes" if codes is not None else next(iter(tensors))
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, {what} on {dev}")
        if t.dtype != _F32:
            raise TypeError(f"{where}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
    if codes is not None and (codes.dtype != torch.int32 or codes.dim() != 1
                              or not codes.is_contiguous()):
        raise TypeError(f"{where}: codes must be a contiguous (N,) int32 tensor")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{where}: unsupported device {dev}")


def moments_twin(R, Z, codes, B: int) -> torch.Tensor:
    """Plain version of K4: one masked product per batch."""
    K, N = R.shape
    Za = torch.cat([Z, Z.new_ones((1, N))], dim=0)
    M = torch.zeros((K, B, Z.shape[0] + 1), dtype=_F32, device=R.device)
    for b in range(B):
        sel = (codes == b).nonzero().squeeze(1)
        M[:, b, :] = R.index_select(1, sel) @ Za.index_select(1, sel).t()
    return M


def moments(R: torch.Tensor, Z: torch.Tensor, codes: torch.Tensor, B: int,
            index: Optional[CellIndex] = None) -> torch.Tensor:
    """Return M (K, B, d+1) for R (K, N), Z (d, N), codes (N,) in [0, B);
    ``index`` is the codes' :class:`CellIndex` (built here when None)."""
    _check_inputs("moments", {"R": R, "Z": Z}, codes)
    K, N = R.shape
    d = Z.shape[0]
    if Z.shape[1] != N or codes.shape[0] != N:
        raise ValueError(f"moments: shapes R {tuple(R.shape)}, Z {tuple(Z.shape)}, "
                         f"codes {tuple(codes.shape)} disagree")
    if codes.device.type == "cpu":
        if index is not None:
            _index_for("moments", codes, B, K, d, index)
        return moments_twin(R, Z, codes, B)
    index = _index_for("moments", codes, B, K, d, index)
    T = index.tile
    plan = _k4_plan(K, d, B, T)
    if plan is None:
        raise ValueError(f"moments: K={K}, d={d}, B={B} fit no layout of K4 at tiles of {T}")
    KS, EP, global_acc, threads, smem = plan
    d1, nt, n_ks = d + 1, -(-N // T), -(-K // KS)
    lib = _build.load("ridge", _SIGNATURES)
    n_sm = torch.cuda.get_device_properties(R.device).multi_processor_count
    NS = min(nt, max(1, -(-n_sm * _occupancy(lib, 0, int(global_acc), threads, smem)
                        // n_ks)))
    if global_acc:
        NS = min(NS, max(1, _K4_GLOBAL_PART_BYTES // (4 * B * d1 * K)))
    tpc = -(-nt // NS)
    NS = -(-nt // tpc)
    alloc = torch.zeros if global_acc else torch.empty
    part = alloc((NS, B, d1, K), dtype=_F32, device=R.device)
    M = torch.empty((K, B, d1), dtype=_F32, device=R.device)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    _build.check(lib.k4_moments(
        R.data_ptr(), Z.data_ptr(), codes.data_ptr(), index.order.data_ptr(),
        part.data_ptr(), M.data_ptr(), N, K, d, B, T, nt, tpc, NS,
        KS, EP, int(global_acc), threads, smem, stream,
    ), "k4_moments")
    graphs.count(moments)
    return M


moments.launches = 0


def correction_twin(W, R, Z, codes) -> torch.Tensor:
    """Plain version of K5: one product per batch over its cells."""
    out = Z.clone()
    for b in range(W.shape[1]):
        sel = (codes == b).nonzero().squeeze(1)
        out[:, sel] = Z.index_select(1, sel) - W[:, b, :].t() @ R.index_select(1, sel)
    return out


def correction(W: torch.Tensor, R: torch.Tensor, Z: torch.Tensor,
               codes: torch.Tensor, index: Optional[CellIndex] = None) -> torch.Tensor:
    """Return Z_corr (d, N) for W (K, B, d) batch betas, R (K, N), Z (d, N);
    ``index`` is the codes' :class:`CellIndex` (built here when None)."""
    _check_inputs("correction", {"W": W, "R": R, "Z": Z}, codes)
    K, N = R.shape
    d = Z.shape[0]
    B = W.shape[1]
    if W.shape != (K, B, d) or Z.shape[1] != N or codes.shape[0] != N:
        raise ValueError(f"correction: shapes W {tuple(W.shape)}, R {tuple(R.shape)}, "
                         f"Z {tuple(Z.shape)}, codes {tuple(codes.shape)} disagree")
    if codes.device.type == "cpu":
        if index is not None:
            _index_for("correction", codes, B, K, d, index)
        return correction_twin(W, R, Z, codes)
    index = _index_for("correction", codes, B, K, d, index)
    T = index.tile
    plan = _k5_plan(K, d, T)
    if plan is None:
        raise ValueError(f"correction: K={K}, d={d} fit no layout of K5 at tiles of {T}")
    stages, WB, dp, smem = plan
    nt = -(-N // T)
    # W_b as one contiguous (K, dp) block a batch, dims padded with zeros
    Wt = torch.nn.functional.pad(W.permute(1, 0, 2), (0, dp - d)).contiguous()
    Zc = torch.empty_like(Z)
    lib = _build.load("ridge", _SIGNATURES)
    n_sm = torch.cuda.get_device_properties(R.device).multi_processor_count
    grid = min(nt, n_sm * _occupancy(lib, 1, stages, _K5_THREADS, smem))
    stream = torch.cuda.current_stream(R.device).cuda_stream
    _build.check(lib.k5_correction(
        Wt.data_ptr(), R.data_ptr(), Z.data_ptr(), codes.data_ptr(), index.order.data_ptr(),
        index.runs.data_ptr(), Zc.data_ptr(), N, K, d, T, nt, T + 4, dp, WB, stages, grid, smem,
        stream,
    ), "k5_correction")
    graphs.count(correction)
    return Zc


correction.launches = 0


# ---- K8 / K9: the batch-tiled moments and correction ---------------------

_TILED_SIGNATURES = {
    "k8_tile_moments": [_build.PTR] * 6 + [_build.I64] + [_build.INT] * 11
    + [_build.PTR],
    "k9_tiled_correction": [_build.PTR] * 6 + [_build.I64] + [_build.INT] * 11
    + [_build.PTR],
    "k9_occupancy": [_build.INT] * 4,
    "sum_joint_rows": [_build.PTR] * 3 + [_build.INT, _build.I64, _build.PTR],
}
# K8 (tiled.cu): cells of one joint level per CTA, the row stride of a
# staged 32-cell slice, staged slices in flight, the side of a thread's
# register tile, and the most register tiles (threads) a CTA holds
_K8_CHUNK_CELLS = 512
_K8_SP, _K8_STAGES, _K8_RT, _K8_MAX_TILES = 36, 2, 8, 96
# K9 (tiled.cu): cells a slice of R, the most threads a CTA has (one
# 4-dim x 8-cell tile each at a time) and the fewest
_K9_CELLS, _K9_MAX_THREADS, _K9_MIN_THREADS = 64, 512, 128


def _tiled_inputs(where, tensors, tile_joint, tile):
    _check_inputs(where, tensors)
    R, Z = tensors["R"], tensors["Z"]
    K, Np = R.shape
    if Z.shape[1] != Np:
        raise ValueError(f"{where}: R {tuple(R.shape)} and Z {tuple(Z.shape)} disagree")
    tj = np.asarray(tile_joint, dtype=np.int32)
    if tj.shape != (-(-Np // tile),):
        raise ValueError(f"{where}: tile_joint needs one entry per {tile}-cell tile "
                         f"of {Np} cells, got {tj.shape}")
    return K, Np, Z.shape[0], tj


def tile_moments_twin(R, Z, tile: int, tile_joint, n_joint: int) -> torch.Tensor:
    """Plain version of K8: per-tile products, then a one-hot product over
    the tile -> joint table (n_joint + 1 rows, the last the trash row)."""
    K, Np = R.shape
    d = Z.shape[0]
    nt = -(-Np // tile)
    pad = nt * tile - Np
    Rp = torch.nn.functional.pad(R, (0, pad)).reshape(K, nt, tile).permute(1, 0, 2)
    Zp = torch.nn.functional.pad(Z, (0, pad)).reshape(d, nt, tile).permute(1, 2, 0)
    S = torch.cat([torch.bmm(Rp, Zp), Rp.sum(dim=2, keepdim=True)], dim=2)
    tj = torch.as_tensor(np.asarray(tile_joint), dtype=torch.int64, device=R.device)
    oh = torch.nn.functional.one_hot(tj, n_joint + 1).to(_F32).t()
    return (oh @ S.reshape(nt, -1)).reshape(n_joint + 1, K, d + 1)


@graphs.device_cache(maxsize=8)
def _moments_plan(tj_bytes: bytes, n_joint: int, device: str, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Chunks of up to ``chunk`` tiles of one joint level, joints in
    order and tiles ascending within a joint; (chunk tiles (n_chunks,
    chunk) padded with -1, first chunk of each joint (n_joint + 2,),
    n_chunks). The table is fixed for a run, so the plan is built and
    copied to the card once, not at every M-step."""
    tj = np.frombuffer(tj_bytes, dtype=np.int32)
    rows, start = [], [0]
    for j in range(n_joint + 1):
        tiles = np.flatnonzero(tj == j)
        for a in range(0, len(tiles), chunk):
            row = np.full(chunk, -1, np.int32)
            part = tiles[a : a + chunk]
            row[: len(part)] = part
            rows.append(row)
        start.append(len(rows))
    chunks = np.stack(rows) if rows else np.zeros((0, chunk), np.int32)
    return (torch.as_tensor(chunks, device=device),
            torch.as_tensor(np.asarray(start, np.int32), device=device), len(rows))


def plan_order(tile_joint: np.ndarray, device) -> torch.Tensor:
    """The order K9 and K10 walk, K8's plan's: every layout tile once,
    joint by joint (the trash tiles last), ascending within a joint; int32
    on ``device``, built once per table. Each CTA takes an equal range."""
    tj = np.ascontiguousarray(tile_joint, dtype=np.int32)
    return _order_on(tj.tobytes(), str(device))


@graphs.device_cache(maxsize=4)
def _order_on(tj_bytes: bytes, device: str) -> torch.Tensor:
    order = np.argsort(np.frombuffer(tj_bytes, dtype=np.int32), kind="stable")
    return torch.as_tensor(order.astype(np.int32), device=device)


def k9_plan(K: int, d: int) -> Tuple[int, int, int]:
    """(slices of R staged, threads, shared memory bytes) of a K9 CTA: two
    slices where they fit beside a joint's betas, else one; raises where
    one does not fit. A thread owns a 4-dim x 8-cell tile of a slice and
    takes the next tile 4 * threads / 8 dims on where d needs more."""
    tiles = _K9_CELLS // 8 * -(-d // 4)  # 4-dim x 8-cell register tiles of a slice
    threads = min(_K9_MAX_THREADS, max(_K9_MIN_THREADS, -(-tiles // 32) * 32))
    for stages in (2, 1):
        smem = 4 * K * (_ceil4(d) + stages * _K9_CELLS)  # the betas, the slices of R
        if smem <= _SMEM_MAX:
            return stages, threads, smem
    raise ValueError(f"tiled_correction: K={K}, d={d} need {smem} bytes of shared memory "
                     f"(a joint's betas and one 64-cell slice of R), over the {_SMEM_MAX} "
                     "a CTA may use")


@functools.lru_cache(maxsize=16)
def _k9_occupancy(threads: int, smem: int, aligned: bool, tile: int) -> int:
    """CTAs an SM holds of the K9 instance launched for ``aligned`` and the
    tile form of ``tile``."""
    n = _build.load("tiled", _TILED_SIGNATURES).k9_occupancy(threads, smem, int(aligned),
                                                             tile)
    if n <= 0:
        raise RuntimeError(f"k9_occupancy: K9 fits no CTA on an SM (CUDA error {-n})")
    return n


@graphs.device_cache(maxsize=4)
def _table_on(tj_bytes: bytes, device: str) -> torch.Tensor:
    """The tile -> joint table on the card, copied once per table."""
    return torch.as_tensor(np.frombuffer(tj_bytes, dtype=np.int32).copy(), device=device)


def _ceil4(n: int) -> int:
    """n rounded up to a multiple of 4, off multiples of 32 (bank spread)."""
    n = -(-n // 4) * 4
    return n + 4 if n % 32 == 0 else n


def sum_joint_rows(rows: torch.Tensor, start: torch.Tensor, M: torch.Tensor) -> None:
    """M[j] = the sum of rows start[j] .. start[j+1] - 1 of ``rows``, in row
    order, on the current stream: K8's per-joint sum, which K3 and K7 run on
    their moment rows. All on the card, M (n_joint + 1, K, d + 1)."""
    lib = _build.load("tiled", _TILED_SIGNATURES)
    _build.check(lib.sum_joint_rows(
        rows.data_ptr(), start.data_ptr(), M.data_ptr(), M.shape[0], M[0].numel(),
        torch.cuda.current_stream(M.device).cuda_stream,
    ), "sum_joint_rows")


def tile_moments(R: torch.Tensor, Z: torch.Tensor, tile: int, tile_joint,
                 n_joint: int) -> torch.Tensor:
    """Return M (n_joint + 1, K, d + 1) for R (K, Np), Z (d, Np) and the
    host table ``tile_joint`` (ceil(Np / tile),) of joint ids (n_joint is
    the trash row)."""
    K, Np, d, tj = _tiled_inputs("tile_moments", {"R": R, "Z": Z}, tile_joint, tile)
    if R.device.type == "cpu":
        return tile_moments_twin(R, Z, tile, tj, n_joint)
    d1 = d + 1
    neb = -(-d1 // _K8_RT)  # the ones row for the row sums at d
    if neb > _K8_MAX_TILES:
        raise ValueError(f"tile_moments: d={d} is over {_K8_RT * _K8_MAX_TILES}")
    chunk = max(1, _K8_CHUNK_CELLS // tile)
    for KS in range(-(-K // _K8_RT) * _K8_RT, 0, -_K8_RT):
        nkb = KS // _K8_RT
        stage = _K8_RT * (nkb + neb) * _K8_SP
        smem = 4 * (_K8_STAGES * stage + chunk)
        if (nkb * neb <= _K8_MAX_TILES and smem <= _SMEM_MAX
                and min(KS, K) * d1 <= _K8_STAGES * stage):
            break
    else:
        raise ValueError(f"tile_moments: d={d} needs more than {_SMEM_MAX} bytes of "
                         "shared memory at 8 clusters a CTA")
    threads = -(-nkb * neb // 32) * 32
    chunks, start, n_chunks = _moments_plan(tj.tobytes(), n_joint, str(R.device), chunk)
    part = torch.empty((max(n_chunks, 1), K, d1), dtype=_F32, device=R.device)
    M = torch.empty((n_joint + 1, K, d1), dtype=_F32, device=R.device)
    lib = _build.load("tiled", _TILED_SIGNATURES)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    _build.check(lib.k8_tile_moments(
        R.data_ptr(), Z.data_ptr(), chunks.data_ptr(), start.data_ptr(),
        part.data_ptr(), M.data_ptr(), Np, K, d, tile, n_chunks, n_joint, KS, nkb, neb,
        threads, chunk, smem, stream,
    ), "k8_tile_moments")
    graphs.count(tile_moments)
    return M


tile_moments.launches = 0


def tiled_correction_twin(W_joint, tile_joint, R, Z, tile: int) -> torch.Tensor:
    """Plain version of K9: one (d, K) x (K, tile) product per layout tile."""
    K, Np = R.shape
    d = Z.shape[0]
    nt = -(-Np // tile)
    pad = nt * tile - Np
    Rp = torch.nn.functional.pad(R, (0, pad)).reshape(K, nt, tile).permute(1, 0, 2)
    tj = torch.as_tensor(np.asarray(tile_joint), dtype=torch.int64, device=R.device)
    corr = torch.bmm(W_joint.index_select(0, tj), Rp)  # (nt, d, tile)
    corr = corr.permute(1, 0, 2).reshape(d, nt * tile)[:, :Np]
    return Z - corr


def tiled_correction(W_joint: torch.Tensor, tile_joint, R: torch.Tensor,
                     Z: torch.Tensor, tile: int) -> torch.Tensor:
    """Return Z_corr (d, Np) for W_joint (n_joint + 1, d, K) per-joint betas
    (the last row zero), the host table ``tile_joint`` (ceil(Np / tile),),
    R (K, Np) and Z (d, Np)."""
    K, Np, d, tj = _tiled_inputs("tiled_correction", {"R": R, "Z": Z, "W_joint": W_joint},
                                 tile_joint, tile)
    nj1 = W_joint.shape[0]
    if W_joint.shape != (nj1, d, K) or tj.max(initial=0) >= nj1:
        raise ValueError(f"tiled_correction: W_joint {tuple(W_joint.shape)} does not "
                         f"fit d={d}, K={K} and the tile table")
    if R.device.type == "cpu":
        return tiled_correction_twin(W_joint, tj, R, Z, tile)
    stages, threads, smem = k9_plan(K, d)
    order = plan_order(tj, R.device)
    n = order.shape[0]
    # one equal range of the order a CTA, as many CTAs as the card holds at once
    tjd = _table_on(tj.tobytes(), str(R.device))
    Zc = torch.empty_like(Z)
    aligned = Np % 4 == 0 and tile % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (R, Z, Zc))
    n_sm = torch.cuda.get_device_properties(R.device).multi_processor_count
    grid = min(n, n_sm * _k9_occupancy(threads, smem, aligned, tile))
    lib = _build.load("tiled", _TILED_SIGNATURES)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    _build.check(lib.k9_tiled_correction(
        W_joint.data_ptr(), order.data_ptr(), tjd.data_ptr(), R.data_ptr(), Z.data_ptr(),
        Zc.data_ptr(), Np, n, K, d, _ceil4(d), tile, nj1 - 1, grid, stages, threads, int(aligned),
        smem, stream,
    ), "k9_tiled_correction")
    graphs.count(tiled_correction)
    return Zc


tiled_correction.launches = 0


# ---- sharded wrappers (no kernels: K4, K8 and K9 on the rank's cells) ----


def sharded_moments(mesh, R: torch.Tensor, Z: torch.Tensor, codes: torch.Tensor, B: int,
                    index: Optional[CellIndex] = None) -> torch.Tensor:
    """The (K, B, d+1) moments of the mesh: K4 on the rank's columns (R, Z
    and ``codes``, pad cells at code 0 with R zero) through ``index``, the
    rank's own :class:`CellIndex` (``engine.mstep_layout(mesh=)`` builds it
    once a run from the rank's codes), then one all-reduce. K5 needs no
    sharded form: it corrects the rank's columns with the same index."""
    from ..sharding import all_reduce_sum

    return all_reduce_sum(moments(R, Z, codes, B, index).contiguous(), mesh)


def _pad_left(X: torch.Tensor, off: int) -> torch.Tensor:
    """X with ``off`` zero columns in front: a shard that starts inside a
    layout tile reads that tile from its start, the cells of the rank
    before as zeros, which add nothing to a moment and take no correction."""
    return torch.nn.functional.pad(X, (off, 0)) if off else X


def sharded_tile_moments(cfg, mesh, R: torch.Tensor, Z: torch.Tensor, tile: int,
                         tile_joint_full, n_joint: int) -> torch.Tensor:
    """The joint-batch moments of the mesh (``sharded_tile_moments``,
    pallas_ridge.py:213): K8 (its plain version under ``mstep_impl='torch'``)
    over the rank's layout tiles, R and Z its columns,
    ``tile_joint_full`` the global table, then one all-reduce of the
    (n_joint+1, K, d+1) table. A tile cut by a shard boundary is summed in
    part on each side."""
    from ..sharding import all_reduce_sum, shard_tiles

    t0, t1, off = shard_tiles(cfg, mesh, tile)
    fn = tile_moments if cfg.mstep_impl == "kernel" else tile_moments_twin
    M = fn(_pad_left(R, off), _pad_left(Z, off), tile, np.asarray(tile_joint_full)[t0:t1],
           n_joint)
    return all_reduce_sum(M.contiguous(), mesh)


def sharded_tiled_correction(cfg, mesh, W_joint: torch.Tensor, tile_joint_full,
                             R: torch.Tensor, Z: torch.Tensor, tile: int) -> torch.Tensor:
    """Z_corr of the rank's columns (``sharded_tiled_correction``,
    pallas_ridge.py:345): K9 (its plain version under ``mstep_impl='torch'``)
    over the rank's layout tiles with the replicated betas; no collective."""
    from ..sharding import shard_tiles

    t0, t1, off = shard_tiles(cfg, mesh, tile)
    fn = tiled_correction if cfg.mstep_impl == "kernel" else tiled_correction_twin
    Zc = fn(W_joint, np.asarray(tile_joint_full)[t0:t1], _pad_left(R, off), _pad_left(Z, off),
            tile)
    return Zc[:, off:].contiguous() if off else Zc
