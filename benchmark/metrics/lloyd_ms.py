"""lloyd_ms: the mean device time of an integration's Lloyd rounds, the
span ``kmeans_lloyd`` (ops/kmeans.py ``_lloyd_round``, 10 chunked rounds),
over the timed jobs after the profiled slice (``PhaseTimers.totals()``)."""

from benchmark.metrics.seed_ms import per_call_ms


def read(ctx):
    return per_call_ms("lloyd_ms", "kmeans_lloyd", len(ctx.jobs))
