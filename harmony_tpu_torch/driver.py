"""Outer Harmony loop: the analog of ``harmonize`` (R/utils.R:15-46).

Counterpart of ``harmony_tpu/driver.py``. Where nothing needs the host
between iterations (no injected draws, no checkpoint, not verbose) on the
routes of :attr:`HarmonyConfig.graph_route`, the iterations run through
``engine.run_rounds``: one CUDA graph replay an iteration and the
convergence test on the device, the host reading the run's state once at
its end, or once a chunk of ``abort_poll_rounds`` iterations when an abort
flag is polled (harmony_tpu/driver.py:122-155). Elsewhere the host loop:
one device->host scalar read per round (the convergence flag). On a mesh
every rank runs the host loop in lockstep: the convergence test reads the
replicated (all-reduced) objective, so every rank takes the same decision,
and an abort is all-reduced (max) before each round, so no rank leaves the
others waiting in a collective.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import engine, sharding
from .config import HarmonyConfig
from .runtime import DivergenceError, span, timing
from .state import HarmonyState

logger = logging.getLogger("harmony_tpu_torch")


def _ensure_verbose_handler():
    """Make verbose output visible without user logging config (the
    reference's message() prints, R/utils.R:21-23)."""
    if not logger.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)


def _check_finite(state: HarmonyState) -> None:
    """Fail loudly on a diverged objective trace (the span ``check_finite``)."""
    n = state.n_harmony
    if n < 1:
        return
    with span("check_finite"):
        obj = state.objective_harmony[:n].cpu().numpy().astype(np.float64)
        if not np.isfinite(obj).all():
            bad = int(np.argmax(~np.isfinite(obj)))
            raise DivergenceError(bad, obj[max(0, bad - 2): bad + 1].tolist())


def _aborted(abort, mesh) -> bool:
    """Is the run to stop? On a mesh, if any rank's flag is set."""
    flag = abort is not None and abort.aborted()
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    return bool(sharding.all_reduce_max(t, mesh).item())


def harmonize(
    cfg: HarmonyConfig,
    state: HarmonyState,
    max_iter: Optional[int] = None,
    verbose: bool = False,
    perms: Optional[np.ndarray] = None,
    abort=None,
    timers=None,
    schedules: Optional[Sequence] = None,
    layout: Optional[engine.MStepLayout] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_meta: Optional[dict] = None,
    mesh=None,
    abort_poll_rounds: int = 1,
) -> HarmonyState:
    """Run up to ``max_iter`` rounds of (cluster, correct), with early stop.

    ``perms`` injects per-round permutations of shape
    (rounds, max_iter_cluster, N) on the permute schedule; ``schedules``
    injects, per round, the rotate schedule's table of the
    max_iter_cluster (rotation, block order) rows (``rotate.schedule_table``
    of the pairs). ``layout`` is the run's M-step layout
    (``engine.mstep_layout``; None: dense). ``abort`` is any
    object with an ``aborted()`` method (``runtime.AbortFlag``), polled
    before every round; a set flag raises ``KeyboardInterrupt``. A
    virtual-R run materialises its R once after the loop, in the
    ``materialize_r`` timer scope (harmony_tpu/driver.py:149-153, 231-234).

    Without ``perms``, ``schedules``, ``checkpoint_path`` and ``verbose``,
    on the routes of ``cfg.graph_route`` (the card, no mesh), the run is
    ``engine.run_rounds``: one call of ``max_iter`` iterations without
    ``abort``; with it, calls of ``abort_poll_rounds`` iterations, the flag
    polled before each, the objective trace checked after each and the
    convergence read between them (harmony_tpu/driver.py:122-155).

    ``timers`` (a ``runtime.PhaseTimers``) is made the active timers while
    the call runs, so every span below it records into them. The host
    loop's iterations are the scopes ``cluster`` and ``correct``; on the
    one-dispatch path they are one ``run_rounds`` scope (as the JAX
    package's fused path has one aggregate scope), inside which the
    captured iteration's stamps give ``cluster`` and ``correct`` their
    calls and device seconds (``engine.run_rounds``).

    ``checkpoint_path`` writes a minimal checkpoint (``checkpoint.py``, with
    ``checkpoint_meta`` as its provenance) every ``checkpoint_every``
    completed rounds, in the ``checkpoint`` timer scope, after the
    divergence check, so a diverged state never replaces the last good
    checkpoint; it needs no R, so a virtual-R run materialises nothing for
    it.

    ``mesh`` runs the rounds on the rank's cells (``engine``'s mesh
    routes); ``schedules`` then holds the rank's own draws. Every rank polls
    ``abort`` and the flags are all-reduced (max), so a flag set on one
    rank stops every rank before the same round; a checkpoint is gathered
    from every rank and written by rank 0."""
    if max_iter is None:
        max_iter = cfg.max_iter_harmony
    if max_iter > cfg.max_iter_harmony:
        # the trace buffers hold cfg.max_iter_harmony rounds
        raise ValueError(
            f"max_iter={max_iter} exceeds the engine's trace capacity "
            f"(config max_iter_harmony={cfg.max_iter_harmony}); build the "
            "config/state with max_iter >= the requested round budget"
        )
    if verbose:
        _ensure_verbose_handler()
    layout = layout or engine.MStepLayout()
    with timing(timers):
        if (perms is None and schedules is None and checkpoint_path is None and not verbose
                and cfg.graph_route and mesh is None):
            return _one_dispatch(cfg, state, max_iter, abort, abort_poll_rounds, layout)
        return _host_loop(cfg, state, max_iter, verbose, perms, abort, schedules, layout,
                          checkpoint_path, checkpoint_every, checkpoint_meta, mesh)


def _host_loop(cfg: HarmonyConfig, state: HarmonyState, max_iter: int, verbose: bool, perms,
               abort, schedules, layout, checkpoint_path, checkpoint_every, checkpoint_meta,
               mesh) -> HarmonyState:
    """harmonize's host loop: one read of the convergence flag a round."""
    for it in range(max_iter):
        if _aborted(abort, mesh):
            raise KeyboardInterrupt("harmony run aborted by user")
        t0 = time.perf_counter()
        with span("cluster", sync=True):
            state = engine.cluster(cfg, state, None if perms is None else perms[it],
                                   None if schedules is None else schedules[it], layout.tiled,
                                   mesh)
        with span("correct", sync=True):
            state = engine.correct(cfg, state, layout, mesh)
        converged = engine.harmony_converged(cfg, state)
        dt = time.perf_counter() - t0
        _check_finite(state)
        if checkpoint_path and (it + 1) % checkpoint_every == 0:
            from .checkpoint import save_checkpoint

            with span("checkpoint", sync=True):
                save_checkpoint(checkpoint_path, cfg, state, mode="minimal",
                                meta=checkpoint_meta, mesh=mesh)
        if verbose:
            obj = float(state.objective_harmony[state.n_harmony - 1])
            logger.info(
                "Harmony %d/%d  objective=%.6f  (%.3fs, %.2fM cells/s)",
                it + 1, max_iter, obj, dt, cfg.N / dt / 1e6,
            )
        if converged:
            if verbose:
                logger.info("Harmony converged after %d iterations", it + 1)
            break
    with span("materialize_r", sync=True):
        state = engine.materialize_r(cfg, state, mesh)
    return state


def _one_dispatch(cfg: HarmonyConfig, state: HarmonyState, max_iter: int, abort,
                  abort_poll_rounds: int, layout) -> HarmonyState:
    """harmonize through ``engine.run_rounds`` (harmony_tpu/driver.py:
    122-155): one call, or chunks of ``abort_poll_rounds`` iterations with
    the abort flag polled before each."""
    if max_iter < 1:
        return state
    if abort is None:
        with span("run_rounds", sync=True):
            state = engine.run_rounds(cfg, state, max_iter, layout)
    else:
        done = 0
        while done < max_iter:
            if abort.aborted():
                raise KeyboardInterrupt("harmony run aborted by user")
            k = min(max(abort_poll_rounds, 1), max_iter - done)
            with span("run_rounds", sync=True):
                state = engine.run_rounds(cfg, state, k, layout)
            done += k
            _check_finite(state)
            if done < max_iter and engine.harmony_converged(cfg, state):
                break
    with span("materialize_r", sync=True):
        state = engine.materialize_r(cfg, state)
    _check_finite(state)
    return state


def run(
    cfg: HarmonyConfig,
    state: HarmonyState,
    verbose: bool = False,
    Y0: Optional[np.ndarray] = None,
    perms: Optional[np.ndarray] = None,
    abort=None,
    timers=None,
    schedules: Optional[Sequence] = None,
    layout: Optional[engine.MStepLayout] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_meta: Optional[dict] = None,
    mesh=None,
) -> HarmonyState:
    """init_cluster (or the injected centroids ``Y0``) + harmonize, with
    ``timers`` the active timers (harmonize's docstring)."""
    with timing(timers):
        with span("init_cluster", sync=True):
            if Y0 is not None:
                state = engine.init_cluster_from(cfg, state, Y0, mesh)
            else:
                state = engine.init_cluster(cfg, state, mesh=mesh)
        return harmonize(cfg, state, verbose=verbose, perms=perms, abort=abort,
                         timers=timers, schedules=schedules, layout=layout,
                         checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                         checkpoint_meta=checkpoint_meta, mesh=mesh)
