"""estep_ms: the mean device time of one E-step in the captured iteration,
``cluster`` between the iteration's first two stamps (engine._iteration;
K6/K7 or K2/K3 and their PyTorch glue), over the iterations of the timed
jobs after the profiled slice (``PhaseTimers.totals()``)."""

from benchmark.metrics.seed_ms import per_call_ms


def read(ctx):
    return per_call_ms("estep_ms", "cluster", sum(j.iterations for j in ctx.jobs))
