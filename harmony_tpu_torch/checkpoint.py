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
and bf16 fields as their 16-bit patterns (``'V2'``, what ``np.savez``
writes for a bf16 array), so each package reads the other's files. One
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
of it again. The orbax variant of the JAX package (multi-host, sharded)
has no counterpart yet (ROADMAP A11, part 2: ``torch.distributed.checkpoint``).
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
from .state import GENERATOR_FIELD, HarmonyState, host_numpy, state_from_arrays

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
    """A host copy; bf16 as its 16-bit patterns viewed as ``'V2'``."""
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
    if extra_rounds:
        old_k, old_h, old_r = (cfg.kmeans_trace_capacity, cfg.harmony_trace_capacity,
                               cfg.max_iter_harmony)
        cfg = dataclasses.replace(cfg, max_iter_harmony=cfg.max_iter_harmony + extra_rounds)
        grow = ([(f, old_k, cfg.kmeans_trace_capacity) for f in _TRACE_FIELDS]
                + [("objective_harmony", old_h, cfg.harmony_trace_capacity),
                   ("kmeans_rounds", old_r, cfg.max_iter_harmony)])
        for f, old, new in grow:
            a = arrays[f]
            arrays[f] = np.concatenate([a, np.zeros(new - old, a.dtype)])
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
