"""Cell-sharded data parallelism over ``torch.distributed`` ranks.

Counterpart of ``harmony_tpu/sharding.py``. The scaling axis of Harmony is
the N cells (SURVEY.md §2.3): Z (d, N), R (K, N) and the codes shard over
the cell axis, while the small cluster state (Y, O, E, the hyperparameters,
the traces and the generator) stays replicated on every rank. Every global
reduction of the algorithm (the E/O block deltas, src/harmony.cpp:312-330;
the objective partials, src/harmony.cpp:158-170; the M-step's moments,
src/harmony.cpp:561-616) is a sum over cells, so each rank sums its own
cells and one all-reduce merges the sums, at the points where the JAX
package puts its psums.

One process per device. A rank holds the contiguous slice
:func:`cell_range` of the padded cell axis: the JAX package's
``P(None, CELL_AXIS)``, equal contiguous blocks of a cell axis padded to a
multiple of the mesh size (:func:`pad_for_mesh`; the rotate schedule pads
it to whole tiles on every shard, ``config.finalize_engine_config``).

The backend is the caller's choice: ``"nccl"`` (the default) for one rank
a card; ``"gloo"`` for several ranks on one card (NCCL refuses two ranks on
one device) or for ranks on the CPU. Only collectives gloo takes on CUDA
tensors are used: ``all_reduce``, ``broadcast`` and ``all_gather``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

CELL_AXIS = "cells"

# collectives issued through this module since the last reset_counters():
# the number of calls of each kind and the bytes each rank contributed
_COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "broadcast": 0, "all_gather": 0,
           "all_gather_bytes": 0}


def counters() -> dict:
    """Collectives since :func:`reset_counters` (a copy)."""
    return dict(_COUNTS)


def reset_counters() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def initialize_distributed(
    backend: str = "nccl",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: float = 300.0,
) -> int:
    """Initialise the default process group (idempotent); returns the
    world size.

    Arguments pass to ``torch.distributed.init_process_group``; ``timeout``
    is in seconds and bounds every collective, so a rank that dies does not
    leave the others waiting forever. Without ``init_method`` the group
    reads ``MASTER_ADDR``/``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` from
    the environment (what ``torchrun`` sets). A failed initialisation (a bad
    address, a port clash, a timeout) raises: carrying on as one process
    would run the whole workload on one rank.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    try:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=datetime.timedelta(seconds=timeout), **kw)
    except RuntimeError as e:
        # idempotence only: another caller initialised the group meanwhile
        if "already" in str(e).lower():
            return dist.get_world_size()
        raise
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class CellMesh:
    """A 1-D mesh of ``size`` ranks over the cell axis: this process's
    ``rank``, its ``device`` and the process ``group`` (None: the default
    group)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def make_mesh(device=None, group=None) -> CellMesh:
    """The mesh of every rank of ``group`` (default: the initialised default
    group). ``device`` None means the card of this rank,
    ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` from the
    environment, else the rank), and raises without one; ``"cpu"`` (or any
    torch device) is taken as given."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "sharding.initialize_distributed first")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return CellMesh(rank=rank, size=size, device=device, group=group)


def pad_for_mesh(cfg, mesh):
    """Round the physical cell axis up to a multiple of the mesh size
    (harmony_tpu/sharding.py:62-71)."""
    n = mesh.size
    Np = int(math.ceil(cfg.Np / n) * n)
    if Np == cfg.N:
        return cfg
    return dataclasses.replace(cfg, N_pad=Np)


def cell_range(cfg, mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of the padded cell axis that ``rank`` (default: this one)
    holds: equal contiguous blocks, as ``P(None, CELL_AXIS)`` lays them."""
    if cfg.Np % mesh.size:
        raise ValueError(f"the cell axis ({cfg.Np}) is not a multiple of the mesh size "
                         f"({mesh.size}): pad it with pad_for_mesh")
    n = cfg.Np // mesh.size
    r = mesh.rank if rank is None else rank
    return r * n, (r + 1) * n


def valid_cells(cfg, mesh) -> int:
    """How many of this rank's cells are real (global index < N); the rest
    are pad cells."""
    lo, hi = cell_range(cfg, mesh)
    return max(0, min(cfg.N, hi) - lo)


def shard_cells(x, cfg, mesh):
    """This rank's columns of a global (..., Np) array or tensor."""
    lo, hi = cell_range(cfg, mesh)
    return x[..., lo:hi]


def shard_fields(fields: dict, cfg, mesh) -> dict:
    """This rank's part of state fields of the whole cell axis (arrays or
    tensors by name, as the JAX state lays them out): its columns of the
    cell-axis fields (``state.CELL_FIELDS``), its rows of the stacked
    penalty tables ``virt_pen`` and its tiles' entries of ``virt_blkmap``;
    the rest as given."""
    from .state import CELL_FIELDS

    out = dict(fields)
    for f in CELL_FIELDS:
        if out.get(f) is not None:
            out[f] = shard_cells(out[f], cfg, mesh)
    if out.get("virt_pen") is not None:
        nb = out["virt_pen"].shape[0] // mesh.size
        nt = out["virt_blkmap"].shape[0] // mesh.size
        out["virt_pen"] = out["virt_pen"][mesh.rank * nb:(mesh.rank + 1) * nb]
        out["virt_blkmap"] = out["virt_blkmap"][mesh.rank * nt:(mesh.rank + 1) * nt]
    return out


def shard_state(state, cfg, mesh):
    """This rank's state from a state that holds the whole cell axis on
    every rank (``harmony_tpu/sharding.py``'s ``shard_state``): the
    replicated fields as they are, the cell-axis ones cut to the rank's
    columns (:func:`shard_fields`)."""
    names = [f.name for f in dataclasses.fields(state)]
    return dataclasses.replace(state, **{
        k: (v.contiguous() if isinstance(v, torch.Tensor) else v)
        for k, v in shard_fields({n: getattr(state, n) for n in names}, cfg, mesh).items()
        if v is not getattr(state, k)})


def all_reduce_sum(t: torch.Tensor, mesh: CellMesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    dist.all_reduce(t, group=mesh.group)
    _COUNTS["all_reduce"] += 1
    _COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def all_reduce_many(tensors: Sequence[torch.Tensor], mesh: CellMesh) -> List[torch.Tensor]:
    """The sums over the ranks of several float32 tensors in one all-reduce:
    they are packed into one buffer, summed and unpacked (new tensors)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    all_reduce_sum(flat, mesh)
    out, a = [], 0
    for t in tensors:
        out.append(flat[a:a + t.numel()].reshape(t.shape))
        a += t.numel()
    return out


def all_reduce_max(t: torch.Tensor, mesh: CellMesh) -> torch.Tensor:
    """The maximum of ``t`` over the ranks, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    _COUNTS["all_reduce"] += 1
    _COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A contiguous 2-byte float tensor (bf16, float16) as its bytes (uint8,
    the same memory), which every backend moves (gloo takes neither bf16
    nor int16 on every build); other tensors as they are. Broadcasts and
    gathers copy bits, so no value changes."""
    return t.view(torch.uint8) if t.is_floating_point() and t.element_size() == 2 else t


def broadcast(t: torch.Tensor, mesh: CellMesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns it."""
    dist.broadcast(_bits(t), src=dist.get_global_rank(mesh.group, src) if mesh.group else src,
                   group=mesh.group)
    _COUNTS["broadcast"] += 1
    return t


def _gather(t: torch.Tensor, mesh: CellMesh, dim: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather([_bits(p) for p in parts], _bits(t), group=mesh.group)
    _COUNTS["all_gather"] += 1
    _COUNTS["all_gather_bytes"] += t.numel() * t.element_size()
    return torch.cat(parts, dim=dim)


def gather_cells(t: torch.Tensor, mesh: CellMesh) -> torch.Tensor:
    """Every rank's (..., n) columns, in rank order: the global (..., Np)
    tensor on every rank."""
    return _gather(t, mesh, -1)


def gather_rows(t: torch.Tensor, mesh: CellMesh) -> torch.Tensor:
    """Every rank's (n, ...) rows stacked in rank order (the per-shard
    penalty tables, as the JAX package stacks them on a sharded leading
    axis)."""
    return _gather(t, mesh, 0)


def shard_tiles(cfg, mesh, tile: int) -> Tuple[int, int, int]:
    """This rank's cells in ``tile``-cell layout tiles of the global axis:
    (first tile, one past the last tile, cells of the first tile before
    the rank's first cell). Shard boundaries need not fall on layout tiles
    (the permute schedule pads the axis to the mesh size only); a tile cut
    by a boundary is summed in part on each side."""
    lo, hi = cell_range(cfg, mesh)
    return lo // tile, -(-hi // tile), lo % tile


def shard_tile_table(cfg, mesh, tile_joint, tile: int):
    """This rank's entries of a global per-layout-tile table (its
    ``shard_tiles`` range)."""
    t0, t1, _ = shard_tiles(cfg, mesh, tile)
    return tile_joint[t0:t1]
