"""Benchmark harness: synthetic cells and the cells/s/chip per Harmony
iteration metric, the library module behind ``harmony-torch bench`` and
``python -m harmony_tpu_torch.bench`` (:func:`main`, the counterpart of
the repository's root ``bench.py``, which runs the JAX package).

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

``python -m harmony_tpu_torch.bench`` prints exactly one JSON line, the
payload, and keeps the root ``bench.py``'s contract (bench.py:11-24): a
wall-clock budget (``HARMONY_BENCH_BUDGET``, seconds, default 270) that
:func:`run_bench` returns early within, a watchdog that prints the best
payload at the budget plus 45 s, and the same on SIGTERM or SIGINT; no
payload exists, and nothing is printed, before the warm-up round has
landed. Its knobs are the JAX harness's environment variables
(bench.py:81-140, harmony_tpu/bench.py:143-153): ``HARMONY_BENCH_CELLS``,
``_DIMS``, ``_BATCHES`` (``10``, or ``4,25``: one covariate a level
count), ``_K``, ``_ITERS`` (timed rounds, default 40), ``_ESTEP``,
``_MSTEP`` (the M-step mode), ``_SHUFFLE`` (default rotate), ``_DTYPE``,
``_MESH`` (``auto``: every rank of the default group, which the harness
initialises from ``torchrun``'s variables, rank 0 printing; an integer:
the mesh size, which must be the world size), ``_MSTEP_IMPL``,
``_VARIANT``, ``_SUBTILE``, ``_TILED`` (0: no batch-tiled ingest order)
and ``_VIRTUAL``; the JAX package's implementation names ``pallas`` and
``xla`` are read as the port's ``kernel`` and ``torch``. ``_SORTED`` is
refused: the port has no ``permute_sorted_blocks``. It runs on the card;
``HARMONY_BENCH_DEVICE=cpu`` (the counterpart of ``JAX_PLATFORMS=cpu``)
runs it on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
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
    mstep_impl: Optional[str] = None,
    estep_variant: Optional[str] = None,
    estep_sub_tile: Optional[int] = None,
    tiled: bool = True,
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
    the JAX bench; ``mstep_impl``, ``estep_variant`` and ``estep_sub_tile``
    are the config's too (None: its default), and ``tiled=False`` keeps the synthetic cells'
    order instead of the batch-tiled ingest order (``HARMONY_BENCH_TILED=0``
    in the JAX bench), so the M-step takes its dense or segmented layout."""
    from . import sharding
    from .api import apply_ingest_order, ingest_perm, resolve_mesh
    from .config import finalize_engine_config, harmony_options
    from .engine import harmony_round, init_cluster, mstep_layout, run_rounds
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
    for field, v in (("virtual_r", virtual_r), ("mstep_impl", mstep_impl),
                     ("estep_variant", estep_variant), ("estep_sub_tile", estep_sub_tile)):
        if v is not None:
            overrides[field] = v
    if mstep_mode:
        overrides["mstep_mode"] = mstep_mode
    if mesh is not None:
        cfg = sharding.pad_for_mesh(cfg, mesh)
    cfg = finalize_engine_config(dataclasses.replace(cfg, **overrides), mesh)
    # synthetic cells are in random order already: without the batch-tiled
    # order no ingest order is needed
    perm = ingest_perm(cfg, design, seed)[0] if tiled else None
    _, design, _ = apply_ingest_order(design, perm)
    layout = mstep_layout(cfg, design.codes, dev, mesh)
    hp = expand_hyperparams(design, cfg.K, None, 0.1, 1.0, options.tau)
    note("building the state on the device")
    Zt = AsyncIngest(Zt, cfg, dev, mesh=mesh).result(perm)
    state = init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, seed, dev, mesh=mesh)
    state = init_cluster(cfg, state, mesh=mesh)
    clock = _Clock(dev)
    n_devices = 1 if mesh is None else mesh.size

    def rounds(st, k: int):
        # the graph route runs k iterations as k replays of one captured
        # iteration, as the JAX bench times run_rounds
        # (harmony_tpu/bench.py:282-333); the other routes the host loop
        if cfg.graph_route:
            return run_rounds(cfg, st, k, layout=layout)
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
    # launches (on the graph route it also captures the iteration); its
    # wall is an upper bound of a round
    t0 = time.perf_counter()
    state = rounds(state, 1)
    synchronize(dev)
    warm_s = time.perf_counter() - t0
    # the payload is kept before the progress line says so: a signal that
    # follows the line finds it
    if progress_cb is not None:
        progress_cb(payload(warm_s, warm_s, "warmup_lower_bound"))
    note(f"warm-up done ({warm_s:.2f} s)")
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


# ---- the harness: python -m harmony_tpu_torch.bench -------------------------

# the reference's quickstart, "~4 seconds" for 9,478 cells over ~5 Harmony
# rounds: its per-iteration throughput (bench.py:106-110)
BASELINE_CELLS_PER_SEC = 9478.0 / (4.0 / 5.0)
# the JAX package's implementation names, read as the port's
_IMPL = {"pallas": "kernel", "xla": "torch"}


class _Emitter:
    """The best payload so far, printed exactly once however the process
    ends (bench.py:38-76): at the end, by the watchdog past the budget, or
    on SIGTERM/SIGINT. ``best`` is rebound, never mutated, so the signal
    handler and the watchdog read a whole payload without a lock; the
    handler may interrupt the main thread anywhere, so it takes none.
    ``os._exit``: the main thread may sit in a native call that would
    swallow a SystemExit."""

    def __init__(self, prints: bool):
        self.prints = prints
        self.best: dict = {}
        self.emitted = threading.Event()

    def keep(self, payload: dict) -> None:
        if self.prints:
            self.best = dict(payload)

    def emit(self, rc: int) -> None:
        already = self.emitted.is_set()
        self.emitted.set()
        best = self.best
        if best and not already:
            sys.stdout.write(json.dumps(best) + "\n")
            sys.stdout.flush()
        os._exit(0 if best else rc)

    def on_signal(self, signum, frame) -> None:
        self.emit(128 + signum)

    def watchdog(self, deadline: float) -> None:
        """Print the best payload once past ``deadline``; with none yet (the
        warm-up still running), the moment the warm-up lands one."""
        while not self.emitted.is_set():
            now = time.monotonic()
            if now >= deadline and self.best:
                self.emit(0)
            time.sleep(1.0 if now >= deadline else min(5.0, deadline - now))


def _env_impl(name: str) -> Optional[str]:
    v = os.environ.get(name)
    return _IMPL.get(v, v) if v else None


def _env_flag(name: str) -> Optional[bool]:
    v = os.environ.get(name)
    return None if not v else v != "0"


def _harness_mesh(device):
    """``HARMONY_BENCH_MESH`` as run_bench's ``mesh``: with it set, the
    default group is initialised from torchrun's variables (NCCL on the
    card, gloo on the CPU) where it is not already."""
    raw = os.environ.get("HARMONY_BENCH_MESH")
    if not raw:
        return None
    from .sharding import initialize_distributed

    if "WORLD_SIZE" in os.environ:
        initialize_distributed("gloo" if device == "cpu" else "nccl")
    return int(raw) if raw.isdigit() else raw


def main() -> int:
    """The harness (module docstring); returns the exit code."""
    if os.environ.get("HARMONY_BENCH_SORTED"):
        raise SystemExit("HARMONY_BENCH_SORTED: the port has no permute_sorted_blocks (a "
                         "JAX-only config field); unset it")
    size = int(os.environ.get("HARMONY_BENCH_CELLS", 500_000))
    d = int(os.environ.get("HARMONY_BENCH_DIMS", 50))
    raw_batches = os.environ.get("HARMONY_BENCH_BATCHES", "10")
    n_batches = ([int(v) for v in raw_batches.split(",")] if "," in raw_batches
                 else int(raw_batches))
    nclust = int(os.environ.get("HARMONY_BENCH_K", 100))
    budget = float(os.environ.get("HARMONY_BENCH_BUDGET", 270))
    device = os.environ.get("HARMONY_BENCH_DEVICE") or None
    mesh = _harness_mesh(device)
    import torch.distributed as dist

    out = _Emitter(prints=not dist.is_initialized() or dist.get_rank() == 0)
    signal.signal(signal.SIGTERM, out.on_signal)
    signal.signal(signal.SIGINT, out.on_signal)
    if budget > 0:
        # grace over the budget, so run_bench's own early return lands first
        threading.Thread(target=out.watchdog, args=(time.monotonic() + budget + 45,),
                         daemon=True).start()
    subtile = os.environ.get("HARMONY_BENCH_SUBTILE")
    result = run_bench(
        n_cells=size, d=d, n_batches=n_batches, nclust=nclust,
        max_iter=int(os.environ.get("HARMONY_BENCH_ITERS", 40)),
        baseline_cells_per_sec=BASELINE_CELLS_PER_SEC,
        estep_impl=_env_impl("HARMONY_BENCH_ESTEP"),
        mstep_mode=os.environ.get("HARMONY_BENCH_MSTEP") or None,
        mesh=mesh, shuffle_mode=os.environ.get("HARMONY_BENCH_SHUFFLE", "rotate"),
        dtype=os.environ.get("HARMONY_BENCH_DTYPE") or None,
        virtual_r=_env_flag("HARMONY_BENCH_VIRTUAL"),
        budget_s=budget if budget > 0 else None, progress_cb=out.keep, device=device,
        mstep_impl=_env_impl("HARMONY_BENCH_MSTEP_IMPL"),
        estep_variant=os.environ.get("HARMONY_BENCH_VARIANT") or None,
        estep_sub_tile=int(subtile) if subtile else None,
        tiled=os.environ.get("HARMONY_BENCH_TILED", "1") != "0",
    )
    out.keep(result)
    if not out.emitted.is_set():
        out.emitted.set()
        if out.prints:
            print(json.dumps(out.best), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
