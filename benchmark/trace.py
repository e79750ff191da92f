"""The profiled slice of a traced run, read from ``torch.profiler``'s trace.

The slice is a fixed number of jobs at the start of a traced window, run
under ``torch.profiler`` inside one ``record_function`` span. Its trace is
exported to a temporary file and read back: every device operation
(kernels, copies, fills; kernels inside CUDA graph replays included) with
its start and length, and the host's operations and spans, on the one
clock the profiler aligns them to.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

SPAN = "benchmark_profiled_slice"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Slice(NamedTuple):
    window: Tuple[float, float]  # the span's start and end, us
    device: List[Tuple[str, float, float]]  # (name, start us, length us)
    host: List[Tuple[str, str, float, float]]  # (category, name, start us, length us)


def base_name(raw: str) -> str:
    """A kernel's function name without its return type, namespace,
    template arguments and parameters: ``void ns::k<1>(float*)`` -> ``k``,
    ``void (anonymous namespace)::k(int)`` -> ``k``."""
    s = re.sub(r"^void\s+", "", raw.strip()).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip()


def profile(fn):
    """Run ``fn()`` under the profiler inside the slice's span: (fn's
    result, the :class:`Slice`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return out, parse(events)


def parse(events: list) -> Slice:
    """The slice's window, device operations and host operations from a
    chrome trace's events."""
    window, dev, host = None, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        if cat in _DEVICE_CATS:
            dev.append((e.get("name", ""), ts, dur))
        elif cat in _HOST_CATS:
            if e.get("name") == SPAN and cat == "user_annotation":
                window = (ts, ts + dur)
            else:
                host.append((cat, e.get("name", ""), ts, dur))
    if window is None:
        raise RuntimeError(f"the profiler's trace has no {SPAN} span")
    a, b = window
    dev = [(n, t, d) for n, t, d in dev if t + d > a and t < b]
    return Slice(window=window, device=sorted(dev, key=lambda x: x[1]), host=host)


def busy_intervals(s: Slice) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the window."""
    a, b = s.window
    out: List[List[float]] = []
    for _, t, d in s.device:
        lo, hi = max(t, a), min(t + d, b)
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def busy_seconds(s: Slice) -> float:
    return sum(hi - lo for lo, hi in busy_intervals(s)) * 1e-6


def window_seconds(s: Slice) -> float:
    return (s.window[1] - s.window[0]) * 1e-6


def kernels(s: Slice) -> Dict[str, Tuple[int, float]]:
    """{kernel's base name: (instances, device seconds)} in the slice."""
    acc: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for n, _, d in s.device:
        k = acc[base_name(n)]
        k[0] += 1
        k[1] += d * 1e-6
    return {k: (int(v[0]), v[1]) for k, v in acc.items()}


def top_device_ops(s: Slice, n: int = 10) -> List[list]:
    ks = sorted(kernels(s).items(), key=lambda kv: -kv[1][1])[:n]
    return [[k, v[1]] for k, v in ks]


def idle_gaps(s: Slice, n: int = 10) -> List[list]:
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle (the innermost host operation there, under
    its innermost span): the ``n`` largest."""
    a, b = s.window
    edges = [a]
    for lo, hi in busy_intervals(s):
        edges += [lo, hi]
    edges.append(b)
    gaps = [(lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo]
    acc: Dict[str, float] = defaultdict(float)
    spans = sorted((h for h in s.host if h[0] == "user_annotation"), key=lambda h: h[2])
    ops = sorted((h for h in s.host if h[0] != "user_annotation"), key=lambda h: h[2])
    sweeps = [[spans, 0, []], [ops, 0, []]]
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        names = []
        for sw in sweeps:
            evs, i, active = sw
            while i < len(evs) and evs[i][2] <= mid:
                active.append(evs[i])
                i += 1
            sw[1] = i
            active[:] = [h for h in active if h[2] + h[3] >= mid]
            names.append(active[-1][1] if active else None)
        label = " > ".join(x for x in names if x) or "host outside any operation"
        acc[label] += (hi - lo) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
