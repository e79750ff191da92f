"""iteration_ms: the ``run_rounds`` scope of ``runtime.PhaseTimers``
(engine.run_rounds, the iterations as CUDA graph replays, the replays
after convergence included) over that job's iterations, averaged over
the traced window's integrations after the profiled slice (the profiler
slows the host's launches)."""


def read(ctx):
    jobs = [j for j in ctx.jobs if j.iterations > 0]
    if not jobs:
        return None
    return 1e3 * sum(j.run_rounds_s / j.iterations for j in jobs) / len(jobs)
