"""What a per-layer metric's reader gets: the traced run's jobs, the
profiled slice and the run's configuration."""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional


class Job(NamedTuple):
    iterations: int  # Harmony iterations the job ran (state.n_harmony - 1)
    init_s: float  # the PhaseTimers scope init_cluster
    run_rounds_s: float  # the PhaseTimers scope run_rounds


class Context(NamedTuple):
    cfg: object  # the finalised HarmonyConfig
    layout: object  # the run's engine.MStepLayout
    jobs: List[Job]  # the traced window's jobs after the profiled slice
    profiled: List[int]  # the iterations of each job of the profiled slice
    slice: Optional[object]  # trace.Slice, None without a device trace


def note(msg: str) -> None:
    """A reader's remark, on standard error."""
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def kernel_seconds(ctx: Context, symbols) -> tuple:
    """(instances, device seconds) of the kernels named ``symbols`` in the
    profiled slice."""
    from .trace import kernels

    ks = kernels(ctx.slice)
    return (sum(ks.get(s, (0, 0.0))[0] for s in symbols),
            sum(ks.get(s, (0, 0.0))[1] for s in symbols))


def roofline(ctx: Context, metric: str, symbols, counted: str, expected: int,
             bound_s: float) -> Optional[float]:
    """100 * bound / device time of ``symbols`` in the slice; None where
    the slice ran none of them, or where the profiler saw another number
    of ``counted`` instances than the schedule launched (``expected``):
    a trace that drops kernels would read a share too high."""
    if ctx.slice is None:
        return None
    n, _ = kernel_seconds(ctx, (counted,))
    _, t = kernel_seconds(ctx, symbols)
    if t <= 0.0:
        return None
    note(f"{metric}: the profiler saw {n} {counted} launches of the {expected} "
         f"the schedule made ({'match' if n == expected else 'MISMATCH'})")
    if n != expected:
        return None
    return 100.0 * bound_s / t
