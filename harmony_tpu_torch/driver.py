"""Outer Harmony loop: the analog of ``harmonize`` (R/utils.R:15-46).

Counterpart of ``harmony_tpu/driver.py``. One device->host scalar read per
round (the convergence flag); everything else stays on the device.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional

import numpy as np

from . import engine
from .config import HarmonyConfig
from .runtime import DivergenceError
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
    """Fail loudly on a diverged objective trace."""
    n = state.n_harmony
    if n < 1:
        return
    obj = state.objective_harmony[:n].cpu().numpy().astype(np.float64)
    if not np.isfinite(obj).all():
        bad = int(np.argmax(~np.isfinite(obj)))
        raise DivergenceError(bad, obj[max(0, bad - 2): bad + 1].tolist())


def _scope(timers, name: str):
    return contextlib.nullcontext() if timers is None else timers.scope(name)


def harmonize(
    cfg: HarmonyConfig,
    state: HarmonyState,
    max_iter: Optional[int] = None,
    verbose: bool = False,
    perms: Optional[np.ndarray] = None,
    abort=None,
    timers=None,
) -> HarmonyState:
    """Run up to ``max_iter`` rounds of (cluster, correct), with early stop.

    ``perms`` injects per-round permutations of shape
    (rounds, max_iter_cluster, N). ``abort`` is any object with an
    ``aborted()`` method, polled between rounds.
    """
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
    for it in range(max_iter):
        if abort is not None and abort.aborted():
            raise KeyboardInterrupt("harmony run aborted by user")
        t0 = time.perf_counter()
        with _scope(timers, "cluster"):
            state = engine.cluster(cfg, state, None if perms is None else perms[it])
        with _scope(timers, "correct"):
            state = engine.correct(cfg, state)
        converged = engine.harmony_converged(cfg, state)
        dt = time.perf_counter() - t0
        _check_finite(state)
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
    return state


def run(
    cfg: HarmonyConfig,
    state: HarmonyState,
    verbose: bool = False,
    Y0: Optional[np.ndarray] = None,
    perms: Optional[np.ndarray] = None,
    abort=None,
    timers=None,
) -> HarmonyState:
    """init_cluster (or the injected centroids ``Y0``) + harmonize."""
    with _scope(timers, "init_cluster"):
        if Y0 is not None:
            state = engine.init_cluster_from(cfg, state, Y0)
        else:
            state = engine.init_cluster(cfg, state)
    return harmonize(cfg, state, verbose=verbose, perms=perms, abort=abort,
                     timers=timers)
