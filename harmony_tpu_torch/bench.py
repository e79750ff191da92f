"""Benchmark harness: synthetic cells and the cells/s/chip per Harmony
iteration metric, the library module behind ``harmony-torch bench``.

Counterpart of ``harmony_tpu/bench.py``: the same synthetic generator (bit
for bit) and the same payload keys. Rounds are timed with CUDA events on
the card (the host clock on the CPU) after a warm-up that builds the
kernels and makes their first launches; a pair is (2 rounds, 2 + max_iter
rounds), and the per-iteration time is the median over pairs of their
difference divided by max_iter, as in the JAX package. The run takes
``run_harmony``'s ingest order and M-step layout and its ridge solver
('auto'), with lambda fixed at 1 and early stop off. On a mesh every rank
runs it (the ranks of ``torch.distributed``'s default group) and times its
own rounds, which the collectives keep in lockstep; the payload's value is
per device, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch


def make_synthetic_cells(
    n_cells: int,
    d: int,
    n_batches,
    n_types: int = 10,
    batch_shift: float = 1.5,
    seed: int = 0,
):
    """Batch-confounded synthetic PCA-like embedding (float32).

    ``n_batches`` may be an int (one covariate) or a sequence of level
    counts (one covariate each); returns (Z, batches) with ``batches`` a
    (N,) array or a dict of them."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types, size=n_cells)
    type_centers = rng.normal(size=(n_types, d)).astype(np.float32) * 3.0
    Z = type_centers[types] + rng.normal(size=(n_cells, d)).astype(np.float32) * 0.5
    single = np.ndim(n_batches) == 0
    if single:
        n_batches = (int(n_batches),)
    cols = {}
    for c, nb in enumerate(n_batches):
        b = rng.integers(0, nb, size=n_cells)
        offs = rng.normal(size=(nb, d)).astype(np.float32) * batch_shift
        Z = Z + offs[b]
        cols[f"v{c}"] = b
    if single:
        return Z, next(iter(cols.values()))
    return Z, cols


class _Clock:
    """Elapsed seconds of enqueued work: CUDA events on the card, the host
    clock (after the work) on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, t0) -> float:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            return t0.elapsed_time(ev) / 1e3
        return time.perf_counter() - t0


def run_bench(
    n_cells: int = 100_000,
    d: int = 50,
    n_batches: int = 10,
    nclust: int = 100,
    max_iter: int = 2,
    seed: int = 0,
    baseline_cells_per_sec: Optional[float] = None,
    estep_impl: Optional[str] = None,
    mstep_mode: Optional[str] = None,
    mesh=None,
    shuffle_mode: Optional[str] = None,
    dtype: Optional[str] = None,
    virtual_r: Optional[bool] = None,
    budget_s: Optional[float] = None,
    progress_cb=None,
    device=None,
) -> dict:
    """Time full Harmony rounds (cluster + correct); returns the JSON-line
    payload of ``harmony_tpu.bench.run_bench``.

    ``device``: None for the card (raises without one), or e.g. ``"cpu"``.
    ``budget_s`` bounds the measurement's wall clock: the pairs stop once
    one valid median exists and the next pair would not fit, and the
    payload carries ``degraded``. ``progress_cb(payload)`` gets each
    preliminary payload (after the warm-up, a lower bound; after each
    pair). ``HARMONY_BENCH_PAIRS`` sets the pair count (default 5),
    ``HARMONY_BENCH_VERBOSE`` prints progress to stderr. ``mesh``: None
    (one device), ``"auto"`` (every rank of the initialised default group;
    None for one process), an int (the mesh size, which must be the
    group's world size; 1 still takes the sharded code path, so a 1-rank
    and an N-rank run compare one program, harmony_tpu/bench.py:168-181)
    or a ``sharding.CellMesh``. Every rank of a mesh calls it. ``virtual_r``
    is the config's (None: by dtype), what ``HARMONY_BENCH_VIRTUAL`` sets in
    the JAX bench."""
    from . import sharding
    from .api import apply_ingest_order, ingest_perm, resolve_mesh
    from .config import finalize_engine_config, harmony_options
    from .engine import check_mesh_route, harmony_round, init_cluster, mstep_layout
    from .preprocess import build_design, expand_hyperparams, orient_embedding, resolve_config
    from .runtime import AsyncIngest, resolve_device, synchronize
    from .state import init_state

    if isinstance(mesh, int) and not isinstance(mesh, bool):
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 0
        if mesh != world:
            raise ValueError(f"mesh={mesh}: a mesh size must be the world size of the "
                             f"initialised torch.distributed group ({world}); one rank a "
                             "device (sharding.initialize_distributed)")
        mesh = sharding.make_mesh(device)
    else:
        mesh = resolve_mesh(mesh, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    t_start = time.perf_counter()
    verbose = os.environ.get("HARMONY_BENCH_VERBOSE", "") not in ("", "0")

    def note(msg: str) -> None:
        if verbose:
            print(f"[bench +{time.perf_counter() - t_start:7.1f}s] {msg}", file=sys.stderr,
                  flush=True)

    def over_budget(reserve: float = 0.0) -> bool:
        return budget_s is not None and time.perf_counter() - t_start + reserve > budget_s

    note("generating synthetic cells")
    Z, batches = make_synthetic_cells(n_cells, d, n_batches, seed=seed)
    meta = batches if isinstance(batches, dict) else {"dataset": batches}
    options = harmony_options()
    design = build_design(meta, list(meta))
    Zt = orient_embedding(Z, n_cells)
    n_pairs = int(os.environ.get("HARMONY_BENCH_PAIRS", 5))
    cfg = resolve_config(
        n_cells=n_cells, d=d, design=design, nclust=nclust,
        # trace room for the warm-up, the settle rounds and every attempt
        max_iter=2 * n_pairs * (max_iter + 4) + 5, early_stop=False,
        options=options, verbose=False, ridge_solver="auto",
        shuffle_mode=shuffle_mode or "permute", dtype=dtype or "float32",
    )
    overrides = {"estep_impl": estep_impl or "auto"}
    if virtual_r is not None:
        overrides["virtual_r"] = virtual_r
    if mstep_mode:
        overrides["mstep_mode"] = mstep_mode
    if mesh is not None:
        cfg = sharding.pad_for_mesh(cfg, mesh)
    cfg = finalize_engine_config(dataclasses.replace(cfg, **overrides), mesh)
    perm, _ = ingest_perm(cfg, design, seed)
    _, design, _ = apply_ingest_order(design, perm)
    layout = mstep_layout(cfg, design.codes, dev, mesh)
    if mesh is not None:
        check_mesh_route(cfg)
    hp = expand_hyperparams(design, cfg.K, None, 0.1, 1.0, options.tau)
    note("building the state on the device")
    Zt = AsyncIngest(Zt, cfg, dev, mesh=mesh).result(perm)
    state = init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, seed, dev, mesh=mesh)
    state = init_cluster(cfg, state, mesh=mesh)
    clock = _Clock(dev)
    n_devices = 1 if mesh is None else mesh.size

    def rounds(st, k: int):
        for _ in range(k):
            st = harmony_round(cfg, st, layout=layout, mesh=mesh)
        return st

    def payload(per_iter: float, warm_s: float, pairs_done) -> dict:
        out = {
            "metric": "cells_per_sec_per_chip_per_harmony_iter",
            "value": round(n_cells / per_iter / n_devices, 1),
            "unit": "cells/s/chip",
            "n_cells": n_cells,
            "d": d,
            "K": cfg.K,
            "n_batches": n_batches if np.ndim(n_batches) == 0 else list(n_batches),
            "seconds_per_iter": round(per_iter, 4),
            "first_iter_with_compile_s": round(warm_s, 2),
            "n_devices": n_devices,
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "estep_impl": cfg.estep_impl,
            "mstep": ("tiled" if layout.tiled is not None
                      else "segment" if layout.segments is not None else "dense"),
            "shuffle_mode": cfg.shuffle_mode,
            "dtype": cfg.dtype,
        }
        if pairs_done != n_pairs:
            out["degraded"] = pairs_done
        if baseline_cells_per_sec:
            out["vs_baseline"] = round(out["value"] / baseline_cells_per_sec, 3)
        return out

    # warm-up: the first round builds the kernels and makes their first
    # launches; its wall is an upper bound of a round
    t0 = time.perf_counter()
    state = rounds(state, 1)
    synchronize(dev)
    warm_s = time.perf_counter() - t0
    note(f"warm-up done ({warm_s:.2f} s)")
    if progress_cb is not None:
        progress_cb(payload(warm_s, warm_s, "warmup_lower_bound"))
    state = rounds(state, 2)  # settle, outside the pairs
    if over_budget():
        max_iter = min(max_iter, 5)
        note(f"over budget before pairs; timed rounds -> {max_iter}")

    deltas, pair_cost, attempts = [], 0.0, 0
    while len(deltas) < n_pairs and attempts < 2 * n_pairs:
        if deltas and over_budget(reserve=pair_cost):
            note(f"budget: stopping after {len(deltas)} valid pairs")
            break
        attempts += 1
        w0 = time.perf_counter()
        t0 = clock.start()
        state = rounds(state, 2)
        small = clock.seconds(t0)
        t0 = clock.start()
        state = rounds(state, 2 + max_iter)
        big = clock.seconds(t0)
        pair_cost = max(pair_cost, time.perf_counter() - w0)
        delta = big - small
        note(f"pair attempt {attempts}: delta={delta * 1e3:.2f} ms")
        if delta <= 0:
            continue
        deltas.append(delta)
        if progress_cb is not None:
            progress_cb(payload(float(np.median(deltas)) / max_iter, warm_s,
                                min(len(deltas), n_pairs)))
    if not deltas:
        return payload(warm_s, warm_s, "warmup_lower_bound")
    return payload(float(np.median(deltas)) / max_iter, warm_s, min(len(deltas), n_pairs))
