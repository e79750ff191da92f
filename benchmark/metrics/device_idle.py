"""device_idle: the share of the profiled slice's wall time in which no
operation ran on the device (torch.profiler's trace)."""

from benchmark.trace import busy_seconds, window_seconds


def read(ctx):
    if ctx.slice is None:
        return None
    busy = busy_seconds(ctx.slice)
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / window_seconds(ctx.slice))
