"""mstep_ms: the mean device time of one M-step in the captured iteration,
``correct`` between the iteration's last two stamps (engine._iteration;
K9, the ridge solve, the objective), over the iterations of the timed
jobs after the profiled slice (``PhaseTimers.totals()``)."""

from benchmark.metrics.seed_ms import per_call_ms


def read(ctx):
    return per_call_ms("mstep_ms", "correct", sum(j.iterations for j in ctx.jobs))
