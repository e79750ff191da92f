"""init_ms: the mean time of an integration's k-means init, the
``init_cluster`` scope of ``runtime.PhaseTimers`` (engine.init_cluster,
ops/kmeans.py; host clock closed by a synchronise), over the jobs after
the profiled slice (the profiler slows the host's launches)."""


def read(ctx):
    if not ctx.jobs:
        return None
    return 1e3 * sum(j.init_s for j in ctx.jobs) / len(ctx.jobs)
