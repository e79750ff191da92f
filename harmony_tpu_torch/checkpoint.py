"""Checkpoint and resume, in the ``.npz`` format of ``harmony_tpu/checkpoint.py``.

The reference has no serialization (SURVEY.md §5), but the algorithm is
restart-friendly: the correction always recomputes from Z_orig
(src/harmony.cpp:347) and clustering re-derives R from (Y, Z_corr) on
re-entry (src/harmony.cpp:214-228). So a *minimal* checkpoint holds
{Y, O, E, hyperparameters, objective traces, key, cursors} and Z_corr; R is
recomputed on resume from the original embedding and design, which the
caller hands back in engine order. A *full* checkpoint holds every array
and resumes alone.

The file is the JAX package's: the same fields (``_MINIMAL_FIELDS``,
``_FULL_ONLY_FIELDS``), a JSON config header with the JAX
``HarmonyConfig``'s field set, an optional ``__meta__`` provenance dict,
bf16 fields as their 16-bit patterns (``'V2'``, what ``np.savez`` writes
for a bf16 array) and float16 fields as numpy's float16, so each package
reads the other's files. One
array is added, ``state.GENERATOR_FIELD``: the torch generator's state, so
a resume continues the port's own draws. A JAX-written file has none (its
key advances with every draw); the generator is then seeded from the key.

The header's implementation knobs translate one to one: the port's
'kernel' is the JAX 'pallas', its 'torch' the JAX 'xla'. The JAX-only
``donate`` and ``permute_sorted_blocks`` are written at their defaults and
dropped on reading; the port's ``permute_fused`` is not written and
resolves on reading as ``config.finalize_engine_config`` resolves it, as
``n_shards`` is, from the mesh a resume runs on.

A mesh run writes the same file from the gathered state (the ranks' columns
in rank order), rank 0 alone, with ``mesh_size`` in its provenance
(harmony_tpu/api.py:453-455); a resume on a mesh takes each rank's columns
of it again.

:func:`save_checkpoint_sharded` and :func:`load_checkpoint_sharded` are the
counterpart of the JAX package's orbax variant (``save_checkpoint_orbax``,
harmony_tpu/checkpoint.py:203-246), on ``torch.distributed.checkpoint``: a
directory in which each rank writes its own columns, the replicated fields
once, and a load re-shards onto the mesh it runs on.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import engine, ops
from .config import HarmonyConfig, finalize_engine_config
from .ops.normalize import l2_normalize_columns
from .runtime import resolve_device
from .state import (GENERATOR_FIELD, HarmonyState, host_numpy, set_generator_state,
                    state_from_arrays)

_MINIMAL_FIELDS = (
    "Y", "O", "E", "Z_corr",
    "Pr_b", "batch_sizes", "sigma", "theta", "lamb",
    "objective_kmeans", "objective_kmeans_dist", "objective_kmeans_entropy",
    "objective_kmeans_cross", "n_kmeans", "objective_harmony", "n_harmony",
    "kmeans_rounds", "n_rounds", "key",
)
_FULL_ONLY_FIELDS = ("Z_orig", "R", "codes")
# cell-axis fields: padded with inert zero cells where the resolved config
# has a longer cell axis than the file's
_CELL_FIELDS = ("Z_corr", "Z_orig", "R", "codes")
_TRACE_FIELDS = ("objective_kmeans", "objective_kmeans_dist", "objective_kmeans_entropy",
                 "objective_kmeans_cross")
# the implementation knobs: the port's spelling -> the JAX package's
_IMPL_TO_JAX = {"kernel": "pallas", "torch": "xla"}
_IMPL_FROM_JAX = {v: k for k, v in _IMPL_TO_JAX.items()}
# fields of the JAX HarmonyConfig the port has not, at their defaults
_JAX_ONLY = {"permute_sorted_blocks": False, "donate": "auto"}


def normalize_checkpoint_path(path: str) -> str:
    """The on-disk name always carries ``.npz`` (``np.savez`` would append
    it otherwise, and a resume would look for a name never written)."""
    return path if path.endswith(".npz") else path + ".npz"


def _header(cfg: HarmonyConfig) -> dict:
    """The config as the JAX package's ``HarmonyConfig`` fields."""
    d = dataclasses.asdict(cfg)
    del d["permute_fused"], d["n_shards"]
    for k in ("estep_impl", "mstep_impl"):
        d[k] = _IMPL_TO_JAX.get(d[k], d[k])
    d.update(_JAX_ONLY)
    return d


def config_from_header(d: dict, mesh=None) -> HarmonyConfig:
    """The port's resolved config from a header of either package, for one
    device or for ``mesh`` (its cell axis padded to the mesh first)."""
    d = {k: v for k, v in d.items() if k not in _JAX_ONLY}
    d["B_vec"] = tuple(d["B_vec"])
    for k in ("estep_impl", "mstep_impl"):
        d[k] = _IMPL_FROM_JAX.get(d[k], d[k])
    d["permute_fused"] = None
    cfg = HarmonyConfig(**d)
    if mesh is not None:
        from .sharding import pad_for_mesh

        cfg = pad_for_mesh(cfg, mesh)
    return finalize_engine_config(cfg, mesh)


def _field(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as its 16-bit patterns viewed as ``'V2'``,
    float16 as numpy's float16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2")
    return host_numpy(t)


def save_checkpoint(
    path: str, cfg: HarmonyConfig, state: HarmonyState,
    mode: str = "minimal", meta: Optional[dict] = None,
    compress: bool = False, mesh=None,
) -> None:
    """Write ``state`` to ``path`` (``.npz`` appended if missing), replacing
    any earlier file atomically: a crash mid-write leaves the last good
    checkpoint. ``meta`` persists run provenance the arrays cannot express:
    the ingest order's recipe {shuffle_mode, seed, tiled_tile}, from which a
    resume rebuilds the order (:func:`read_checkpoint_meta`). A full save of
    a virtual-R state materialises R first (``engine.materialize_r``, K11);
    a minimal save needs no R and runs nothing on the card. On a ``mesh``
    every rank calls it: the cell fields are gathered from every rank and
    rank 0 writes the file."""
    if mode not in ("minimal", "full"):
        raise ValueError("mode must be 'minimal' or 'full'")
    if mode == "full" and state.virt_pen is not None:
        state = engine.materialize_r(cfg, state, mesh)
    path = normalize_checkpoint_path(path)
    fields = _MINIMAL_FIELDS + (_FULL_ONLY_FIELDS if mode == "full" else ())
    if mesh is not None:
        from .sharding import gather_cells

        state = dataclasses.replace(state, **{f: gather_cells(getattr(state, f), mesh)
                                              for f in _CELL_FIELDS if f in fields})
        if mesh.rank != 0:
            return
    arrays = {}
    for f in fields:
        if f == "key":
            arrays[f] = np.array([(state.seed >> 32) & 0xFFFFFFFF, state.seed & 0xFFFFFFFF],
                                 dtype=np.uint32)
        elif isinstance(getattr(state, f), int):
            arrays[f] = np.asarray(getattr(state, f), dtype=np.int32)
        else:
            arrays[f] = _field(getattr(state, f))
    arrays[GENERATOR_FIELD] = state.generator.get_state().numpy()
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    header = np.frombuffer(json.dumps(_header(cfg)).encode(), dtype=np.uint8)
    tmp = path + f".tmp.{os.getpid()}"
    # uncompressed by default: the bulk is embedding data that deflate
    # barely shrinks, at a per-round cadence
    savez = np.savez_compressed if compress else np.savez
    try:
        with open(tmp, "wb") as fh:
            savez(fh, __config__=header, __mode__=np.array(mode), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def read_checkpoint_meta(path: str) -> dict:
    """The provenance dict stored by ``save_checkpoint(..., meta=...)``
    (empty if none was stored)."""
    with np.load(normalize_checkpoint_path(path), allow_pickle=False) as z:
        if "__meta__" not in z:
            return {}
        return json.loads(bytes(z["__meta__"]).decode())


def _pad_cells(a: np.ndarray, Np: int) -> np.ndarray:
    if a.shape[-1] > Np:
        raise ValueError(f"checkpoint cell axis {a.shape[-1]} is longer than the config's {Np}")
    if a.shape[-1] == Np:
        return a
    return np.concatenate([a, np.zeros(a.shape[:-1] + (Np - a.shape[-1],), a.dtype)], axis=-1)


def _extend_traces(cfg: HarmonyConfig, arrays: dict, extra_rounds: int) -> HarmonyConfig:
    """``cfg`` with room for ``extra_rounds`` more Harmony rounds, the trace
    buffers of ``arrays`` (numpy arrays or tensors) grown to it in place."""
    if not extra_rounds:
        return cfg
    old_k, old_h, old_r = (cfg.kmeans_trace_capacity, cfg.harmony_trace_capacity,
                           cfg.max_iter_harmony)
    cfg = dataclasses.replace(cfg, max_iter_harmony=cfg.max_iter_harmony + extra_rounds)
    grow = ([(f, old_k, cfg.kmeans_trace_capacity) for f in _TRACE_FIELDS]
            + [("objective_harmony", old_h, cfg.harmony_trace_capacity),
               ("kmeans_rounds", old_r, cfg.max_iter_harmony)])
    for f, old, new in grow:
        a = arrays[f]
        arrays[f] = (np.concatenate([a, np.zeros(new - old, a.dtype)])
                     if isinstance(a, np.ndarray) else torch.cat([a, a.new_zeros(new - old)]))
    return cfg


def load_checkpoint(
    path: str,
    Z: Optional[np.ndarray] = None,
    design=None,
    extra_rounds: int = 10,
    device=None,
    mesh=None,
) -> Tuple[HarmonyConfig, HarmonyState]:
    """Load a checkpoint of either package onto ``device`` (None: the card).
    A minimal checkpoint needs the original (d, N) embedding ``Z`` and the
    :class:`DesignMatrix`, both in the engine's cell order (the ingest
    order, where the run had one). ``extra_rounds`` extends
    ``max_iter_harmony`` and the trace buffers, so the resumed run has room
    for that many more rounds.

    On a minimal resume R is re-derived from (Y, Z_corr) as the clustering
    re-entry does (harmony_tpu/checkpoint.py:175-190), pad cells masked, and
    Z_corr is stored normalised; the virtual-R context and the fused moment
    table come back as None: the next step is ``cluster``, which makes them
    again. On a ``mesh`` (every rank calls it, on the mesh's device) the
    state holds this rank's columns of the file's global arrays."""
    dev = resolve_device(device) if mesh is None else mesh.device
    with np.load(normalize_checkpoint_path(path), allow_pickle=False) as z:
        cfg = config_from_header(json.loads(bytes(z["__config__"]).decode()), mesh)
        mode = str(z["__mode__"])
        names = _MINIMAL_FIELDS + (_FULL_ONLY_FIELDS if mode == "full" else ())
        arrays = {f: z[f] for f in names}
        if GENERATOR_FIELD in z.files:
            arrays[GENERATOR_FIELD] = z[GENERATOR_FIELD]
    cfg = _extend_traces(cfg, arrays, extra_rounds)
    if mode != "full":
        if Z is None or design is None:
            raise ValueError("minimal checkpoint: pass Z (d, N) and design to resume")
        arrays["Z_orig"] = np.asarray(Z)
        arrays["codes"] = design.codes.astype(np.int32)
    for f in _CELL_FIELDS:
        if f in arrays:
            arrays[f] = _pad_cells(arrays[f], cfg.Np)
    if mode != "full":
        arrays["R"] = np.zeros((cfg.K, cfg.Np), np.float32)
    state = state_from_arrays(cfg, arrays, dev, mesh)
    if mode != "full":
        Zc = l2_normalize_columns(state.Z_corr)
        R = ops.initial_assignments(ops.compute_distances(state.Y, Zc), state.sigma)
        if mesh is None:
            nv = cfg.N
        else:
            from .sharding import valid_cells

            nv = valid_cells(cfg, mesh)
        if R.shape[1] != nv:
            R[:, nv:] = 0
        state = dataclasses.replace(state, Z_corr=Zc, R=R.to(state.Y.dtype))
    return cfg, state


# ---- sharded variant (torch.distributed.checkpoint) ------------------------

# the per-shard fields besides state.CELL_FIELDS: the stacked penalty tables
# (a shard's rows) and the tile -> block map (a shard's tiles)
_SHARD_TABLES = ("virt_pen", "virt_blkmap")
_CONFIG_KEY, _LAYOUT_KEY = "config", "layout"


def _json_tensor(d: dict) -> torch.Tensor:
    """A dict as JSON bytes in a uint8 tensor (harmony_tpu/checkpoint.py:
    218-221: the config rides beside the arrays)."""
    return torch.frombuffer(bytearray(json.dumps(d).encode()), dtype=torch.uint8)


def _shard_key(f: str, rank: int) -> str:
    return f"cells.{f}.{rank}"


def save_checkpoint_sharded(path: str, cfg: HarmonyConfig, state: HarmonyState,
                            mesh=None) -> None:
    """Write ``state`` into the directory ``path`` with
    ``torch.distributed.checkpoint``: each rank of ``mesh`` (every rank calls
    it; None: one process) writes its own columns of the cell-axis fields
    (``state.CELL_FIELDS``) and its rows of the per-shard tables
    (``virt_pen``, ``virt_blkmap``); the replicated fields, the generator's
    state (``state.GENERATOR_FIELD``) and the config (JSON bytes in a uint8
    tensor, with the mesh size beside it) go in once. Fields that are None
    are not written and come back as None (harmony_tpu/checkpoint.py:
    211-216); bf16 and float16 fields keep their dtype. A
    virtual-R state is saved with R materialised (``engine.materialize_r``,
    K11), as the npz format's full mode saves it, and keeps its context.
    The phase's Gram table and the fused moment table, which the JAX state
    has not, are not written."""
    import torch.distributed.checkpoint as dcp

    from .state import ARRAY_FIELDS, CELL_FIELDS, VIRTUAL_FIELDS, _CURSORS

    if state.virt_pen is not None:
        state = engine.materialize_r(cfg, state, mesh)
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    sd = {_CONFIG_KEY: _json_tensor(_header(cfg)),
          _LAYOUT_KEY: _json_tensor({"mesh_size": size}),
          GENERATOR_FIELD: state.generator.get_state()}
    for f in ARRAY_FIELDS + VIRTUAL_FIELDS:
        if f == "key":
            sd[f] = torch.tensor([(state.seed >> 32) & 0xFFFFFFFF, state.seed & 0xFFFFFFFF],
                                 dtype=torch.int64)
            continue
        v = getattr(state, f)
        if v is None:
            continue
        if f in _CURSORS:
            sd[f] = torch.tensor(int(v), dtype=torch.int32)
        elif f in CELL_FIELDS or f in _SHARD_TABLES:
            sd[_shard_key(f, rank)] = v.detach().cpu().contiguous()
        else:
            sd[f] = v.detach().cpu().contiguous()
    dcp.save(sd, checkpoint_id=os.path.abspath(path), no_dist=mesh is None,
             process_group=None if mesh is None else mesh.group)


def _read(path: str, keys, mesh) -> dict:
    """The tensors ``keys`` of the checkpoint at ``path``, on the host, at
    the shapes and dtypes its metadata records."""
    import torch.distributed.checkpoint as dcp

    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    sd = {k: torch.empty(tuple(md[k].size), dtype=md[k].properties.dtype) for k in keys}
    dcp.load(sd, checkpoint_id=path, no_dist=mesh is None,
             process_group=None if mesh is None else mesh.group)
    return sd


def _columns(path: str, f: str, md: dict, size: int, lo: int, hi: int, mesh) -> torch.Tensor:
    """Columns [lo, hi) of the cell-axis field ``f`` written by ``size``
    ranks: the shards that hold them, joined; past the written axis, the
    inert zero pad cells of a longer axis."""
    widths = [md[_shard_key(f, r)].size[-1] for r in range(size)]
    starts = np.concatenate([[0], np.cumsum(widths)])
    need = [r for r in range(size) if starts[r] < hi and starts[r + 1] > lo]
    parts = _read(path, [_shard_key(f, r) for r in need], mesh)
    joined = torch.cat([parts[_shard_key(f, r)] for r in need], dim=-1) if need else None
    a0 = int(starts[need[0]]) if need else lo
    out = torch.zeros(tuple(md[_shard_key(f, 0)].size[:-1]) + (hi - lo,),
                      dtype=md[_shard_key(f, 0)].properties.dtype)
    if joined is not None:
        a, b = max(lo, a0), min(hi, a0 + joined.shape[-1])
        out[..., a - lo:b - lo] = joined[..., a - a0:b - a0]
    return out


def load_checkpoint_sharded(path: str, mesh=None, device=None, extra_rounds: int = 0
                            ) -> Tuple[HarmonyConfig, HarmonyState]:
    """Returns (cfg, state) from a :func:`save_checkpoint_sharded` directory,
    re-sharded onto the mesh it runs on: on ``mesh`` (every rank calls it)
    each rank reads the shards that hold its columns of the cell axis of
    this mesh's config (padded for this mesh: the written axis's pad cells
    are dropped or more are added, all inert zeros); with ``mesh=None`` the
    whole state on one device (``device``, None: the card), as the JAX
    load returns the replicated layout. The virtual-R context comes back
    where the mesh size is the one it was written on (its per-shard tables
    belong to that mesh's blocks); otherwise it is dropped, the state's R
    being the materialised one, and the next phase builds it again.
    ``extra_rounds`` extends ``max_iter_harmony`` and the trace buffers, as
    :func:`load_checkpoint`'s does, so a finished run can go on."""
    import torch.distributed.checkpoint as dcp

    from .sharding import cell_range
    from .state import ARRAY_FIELDS, CELL_FIELDS, VIRTUAL_FIELDS, _CURSORS

    path = os.path.abspath(path)
    dev = resolve_device(device) if mesh is None else mesh.device
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    head = _read(path, [_CONFIG_KEY, _LAYOUT_KEY], mesh)
    size = json.loads(bytes(head[_LAYOUT_KEY].numpy()).decode())["mesh_size"]
    cfg = config_from_header(json.loads(bytes(head[_CONFIG_KEY].numpy()).decode()), mesh)
    same = size == (1 if mesh is None else mesh.size)
    lo, hi = (0, cfg.Np) if mesh is None else cell_range(cfg, mesh)
    arrays = _read(path, [k for k in md if "." not in k and k not in (_CONFIG_KEY, _LAYOUT_KEY)
                          and (same or k not in VIRTUAL_FIELDS)], mesh)
    for f in CELL_FIELDS + _SHARD_TABLES:
        if _shard_key(f, 0) not in md or (f in VIRTUAL_FIELDS and not same):
            continue
        if f in VIRTUAL_FIELDS:
            # the virtual-R context, on the mesh it was written on: the
            # rank's own (one device: every shard's, stacked)
            ranks = range(size) if mesh is None else [mesh.rank]
            parts = _read(path, [_shard_key(f, r) for r in ranks], mesh)
            arrays[f] = torch.cat([parts[_shard_key(f, r)] for r in ranks],
                                  dim=0 if f == "virt_pen" else -1)
        else:
            arrays[f] = _columns(path, f, md, size, lo, hi, mesh)
    cfg = _extend_traces(cfg, arrays, extra_rounds)
    kw = {}
    for f in ARRAY_FIELDS + VIRTUAL_FIELDS:
        if f == "key" or f not in arrays:
            continue
        kw[f] = int(arrays[f].item()) if f in _CURSORS else arrays[f].to(dev)
    key = arrays["key"].tolist()
    seed = (int(key[0]) << 32) | int(key[1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    set_generator_state(gen, arrays[GENERATOR_FIELD].numpy())
    return cfg, HarmonyState(**kw, seed=seed, generator=gen)
