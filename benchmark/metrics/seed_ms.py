"""seed_ms: the mean device time of an integration's k-means seeding, the
span ``kmeans_seed`` (ops/kmeans.py ``_seed_centroids``: the distance
table, then K sequential picks), over the timed jobs after the profiled
slice: ``runtime.PhaseTimers.totals()``, its two device stamps a call.

``phase`` and ``per_call_ms`` are the other span readers' too."""

from benchmark.context import note


def phase(name: str):
    """The program's totals of the span ``name`` (calls, host s, device s),
    or None where the program keeps none or took no device stamps of it."""
    from harmony_tpu_torch.runtime import PhaseTimers

    totals = getattr(PhaseTimers, "totals", None)
    if totals is None:
        return None
    p = totals().get(name)
    if p is None or getattr(p, "device_s", None) is None:
        return None
    return p


def per_call_ms(metric: str, name: str, expected: int):
    """Device ms a call of the span ``name``; None without its stamps or
    where its calls are not the ``expected`` (the timed jobs' count)."""
    p = phase(name)
    if p is None or expected < 1:
        return None
    if p.calls != expected:
        note(f"{metric}: {p.calls} calls of {name} against the {expected} expected")
        return None
    return 1e3 * p.device_s / p.calls


def read(ctx):
    return per_call_ms("seed_ms", "kmeans_seed", len(ctx.jobs))
