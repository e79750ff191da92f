"""rounds_overhead_ms: per integration, the device time of the
``run_rounds`` scope outside its iterations' ``cluster`` and ``correct``
(graphs.py and engine._graph_rounds: the static buffers' refresh, the
replays after convergence, the read and the copies out), over the timed
jobs after the profiled slice (``PhaseTimers.totals()``)."""

from benchmark.context import note
from benchmark.metrics.seed_ms import phase


def read(ctx):
    jobs, its = len(ctx.jobs), sum(j.iterations for j in ctx.jobs)
    rounds, e, m = phase("run_rounds"), phase("cluster"), phase("correct")
    if jobs < 1 or None in (rounds, e, m):
        return None
    if rounds.calls != jobs or e.calls != its or m.calls != its:
        note(f"rounds_overhead_ms: {rounds.calls} run_rounds, {e.calls} cluster and "
             f"{m.calls} correct calls against {jobs} jobs of {its} iterations")
        return None
    return 1e3 * (rounds.device_s - e.device_s - m.device_s) / jobs
