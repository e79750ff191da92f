"""The readers of the program's spans and stamps (``metrics/seed_ms.py``,
``lloyd_ms``, ``estep_ms``, ``mstep_ms``, ``rounds_overhead_ms``,
``init_state_ms``) on hand-built totals, contexts and slices: the right
means, and nothing where there are no device stamps, no device operations
or calls that do not match the jobs."""

import pytest

from benchmark.context import Context, Job
from benchmark.manifest import metric_reader
from benchmark.trace import Slice

# two jobs of 3 and 4 iterations
JOBS = [Job(iterations=3, init_s=0.05, run_rounds_s=0.02),
        Job(iterations=4, init_s=0.05, run_rounds_s=0.03)]


@pytest.fixture
def timers():
    """A PhaseTimers, the program's totals cleared before and after."""
    from harmony_tpu_torch.runtime import PhaseTimers

    PhaseTimers.reset_totals()
    yield PhaseTimers()
    PhaseTimers.reset_totals()


def _ctx(jobs=JOBS, profiled=(3, 3), slice_=None):
    return Context(cfg=None, layout=None, jobs=list(jobs), profiled=list(profiled),
                   slice=slice_)


def _spans(timers, device=True, seed_calls=2, iter_calls=7):
    on = (lambda s: {"device_s": s}) if device else (lambda s: {"host_s": s})
    timers.add("kmeans_seed", calls=seed_calls, **on(0.010))
    timers.add("kmeans_lloyd", calls=2, **on(0.030))
    timers.add("cluster", calls=iter_calls, **on(0.014))
    timers.add("correct", calls=iter_calls, **on(0.007))
    timers.add("run_rounds", calls=2, **on(0.041))


@pytest.mark.parametrize("name,ms", [
    ("seed_ms", 5.0), ("lloyd_ms", 15.0), ("estep_ms", 2.0), ("mstep_ms", 1.0),
    ("rounds_overhead_ms", 10.0)])
def test_span_readers_give_the_mean(timers, name, ms):
    _spans(timers)
    assert metric_reader(name)(_ctx()) == pytest.approx(ms)


@pytest.mark.parametrize("name", ["seed_ms", "lloyd_ms", "estep_ms", "mstep_ms",
                                  "rounds_overhead_ms"])
def test_span_readers_need_device_stamps(timers, name):
    assert metric_reader(name)(_ctx()) is None  # nothing recorded
    _spans(timers, device=False)  # host walls only, as on the CPU
    assert metric_reader(name)(_ctx()) is None


@pytest.mark.parametrize("name,seed_calls,iter_calls", [
    ("seed_ms", 3, 7), ("estep_ms", 2, 6), ("mstep_ms", 2, 8), ("rounds_overhead_ms", 2, 6)])
def test_span_readers_refuse_calls_off_the_jobs(timers, name, seed_calls, iter_calls):
    _spans(timers, seed_calls=seed_calls, iter_calls=iter_calls)
    assert metric_reader(name)(_ctx()) is None
    assert metric_reader(name)(_ctx(jobs=[])) is None


def _slice(spans, device=(("k", 5.0, 2.0),)):
    host = [("cpu_op", "aten::copy_", 1.0, 3.0)]
    host += [("user_annotation", "init_state", t, d) for t, d in spans]
    return Slice(window=(0.0, 10_000.0), device=list(device), host=host)


def test_init_state_ms_gives_the_mean_span():
    read = metric_reader("init_state_ms")
    # microseconds in the trace, ms read
    assert read(_ctx(slice_=_slice([(10.0, 1500.0), (5000.0, 2500.0)]))) == pytest.approx(2.0)


def test_init_state_ms_needs_the_slice_and_its_spans():
    read = metric_reader("init_state_ms")
    spans = [(10.0, 1500.0), (5000.0, 2500.0)]
    assert read(_ctx()) is None  # no device trace
    assert read(_ctx(slice_=_slice(spans, device=()))) is None  # no device operations
    assert read(_ctx(slice_=_slice([]))) is None  # a program without the span
    assert read(_ctx(slice_=_slice(spans[:1]))) is None  # one span for two jobs
    assert read(_ctx(profiled=(), slice_=_slice(spans))) is None
