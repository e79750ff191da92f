"""The port's spans and phase timers, on the CPU.

* ``runtime.span`` records into the active ``PhaseTimers``, which
  ``driver.run`` and ``state.init_state`` make active while they run:
  the k-means seeding and Lloyd rounds, the first assignment and the
  divergence check are timed with no ``timers`` passed below them.
* Without timers nothing is recorded; ``PhaseTimers.totals`` sums every
  instance until ``reset_totals``.
* The eager ``engine.run_rounds`` stamps each iteration's ``cluster`` and
  ``correct`` (on the CPU with the host's clock).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import driver, engine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.runtime import PhaseTimers, active_timers, span


def _problem(n=2000, d=4, B=3, max_iter=3, seed=5):
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    design = tpre.build_design({"b": batches}, ["b"])
    cfg = tpre.resolve_config(n_cells=n, d=d, design=design, nclust=4, max_iter=max_iter,
                              early_stop=False, options=tconfig.harmony_options(),
                              verbose=False, lambda_estimation=True, shuffle_mode="permute")
    cfg = tconfig.finalize_engine_config(cfg)
    hp = tpre.expand_hyperparams(design, cfg.K, None, 0.1, None, 0.0)
    args = (cfg, tpre.orient_embedding(Z, n), design, hp.sigma, hp.theta, hp.lamb, 0, "cpu")
    return cfg, args


def _state(timers=None):
    cfg, args = _problem()
    return cfg, tstate.init_state(*args, timers=timers)


def test_driver_run_records_the_spans_below_it():
    cfg, st = _state()
    assert cfg.graph_route  # the one-dispatch path: run_rounds, eager on the CPU
    timers = PhaseTimers(torch.device("cpu"))
    out = driver.run(cfg, st, timers=timers)
    calls = timers.counts()
    for name in ("init_cluster", "kmeans_seed", "kmeans_lloyd", "init_assign", "run_rounds",
                 "materialize_r", "check_finite"):
        assert calls[name] == 1, (name, calls)
    # the captured iteration's phases, one call an iteration run
    assert calls["cluster"] == calls["correct"] == out.n_harmony - 1 == cfg.max_iter_harmony
    host = timers.as_dict()
    assert host["kmeans_seed"] + host["kmeans_lloyd"] + host["init_assign"] \
        <= host["init_cluster"]
    assert "init_state" not in calls  # init_state had no timers
    assert timers.device_dict() == {}  # no card: no device stamps
    assert active_timers() is None


def test_init_state_records_its_spans():
    timers = PhaseTimers(torch.device("cpu"))
    _state(timers)
    assert timers.counts() == {"init_state": 1, "ingest_normalize": 1}
    host = timers.as_dict()
    assert 0.0 <= host["ingest_normalize"] <= host["init_state"]


def test_without_timers_nothing_is_recorded():
    before = PhaseTimers.totals()
    cfg, st = _state()
    driver.run(cfg, st)
    assert PhaseTimers.totals() == before
    assert isinstance(span("anything"), torch.profiler.record_function)


def test_totals_sum_instances_and_reset():
    PhaseTimers.reset_totals()
    a, b = PhaseTimers(), PhaseTimers()
    for t, n in ((a, 2), (b, 3)):
        for _ in range(n):
            with t.scope("x"):
                pass
    with b.scope("y"):
        pass
    tot = PhaseTimers.totals()
    assert tot["x"].calls == 5 and tot["y"].calls == 1
    assert tot["x"].host_s == pytest.approx(a.as_dict()["x"] + b.as_dict()["x"])
    assert tot["x"].device_s is None  # no device: no stamps
    assert a.counts() == {"x": 2} and b.counts() == {"x": 3, "y": 1}
    PhaseTimers.reset_totals()
    assert PhaseTimers.totals() == {}
    assert a.counts() == {"x": 2}  # an instance keeps its own


@pytest.mark.parametrize("epsilon", [None, 0.5])
def test_eager_run_rounds_records_each_iteration(epsilon):
    """Every iteration, and with an early stop those run only."""
    cfg, st = _state()
    if epsilon is not None:
        cfg = dataclasses.replace(cfg, epsilon_harmony=epsilon)
    st = engine.init_cluster(cfg, st)
    timers = PhaseTimers(torch.device("cpu"))
    with timers.active():
        out = engine.run_rounds(cfg, st, 3)
    ran = out.n_harmony - st.n_harmony
    assert ran == 3 if epsilon is None else 1 <= ran < 3
    assert timers.counts() == {"cluster": ran, "correct": ran}
    assert timers.as_dict()["cluster"] > 0.0 and timers.as_dict()["correct"] > 0.0
    # without active timers the eager loop takes no stamps
    quiet = PhaseTimers()
    engine.run_rounds(cfg, st, 3)
    assert quiet.counts() == {}


def test_spans_nest():
    timers = PhaseTimers()
    with timers.active():
        with span("outer"):
            with span("inner", sync=True):
                with span("inner"):
                    pass
        with span("outer"):
            pass
    assert timers.counts() == {"outer": 2, "inner": 2}
    host = timers.as_dict()
    assert 0.0 <= host["inner"] <= host["outer"]
    assert active_timers() is None
    # a scope outside any activation makes its timers active for its block
    with timers.scope("alone"):
        assert active_timers() is timers
    assert timers.counts()["alone"] == 1 and active_timers() is None


def test_host_loop_records_each_round():
    """The host loop (verbose off, injected schedules off, but off the
    graph route): its cluster and correct scopes and a divergence check a
    round."""
    cfg, st = _state()
    cfg = dataclasses.replace(cfg, estep_impl="torch")
    assert not cfg.graph_route
    timers = PhaseTimers(torch.device("cpu"))
    out = driver.run(cfg, st, timers=timers)
    ran = out.n_harmony - 1
    calls = timers.counts()
    assert calls["cluster"] == calls["correct"] == calls["check_finite"] == ran >= 1
    assert calls["kmeans_seed"] == calls["kmeans_lloyd"] == calls["init_assign"] == 1
    assert "run_rounds" not in calls
