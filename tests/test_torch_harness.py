"""The port's benchmark harnesses on the CPU.

* ``python -m harmony_tpu_torch.bench`` (``bench.main``, the counterpart of
  the root ``bench.py``) with ``HARMONY_BENCH_DEVICE=cpu`` prints exactly
  one JSON line whose keys are the JAX package's payload's
  (``harmony_tpu.bench.run_bench`` with the harness's baseline, at a tiny
  size); without the CPU knob and without a card it raises and prints
  nothing; ``HARMONY_BENCH_SORTED`` is refused.
* A SIGTERM before the warm-up round has landed prints nothing; after it,
  exactly one line, the payload so far.
* The knobs reach the config: the harness's environment variables reach
  ``run_bench``'s arguments (the JAX names ``pallas``/``xla`` read as
  ``kernel``/``torch``), and those arguments the config the rounds run.
* ``python -m harmony_tpu_torch.tools.quality_bench``: its ``parity``
  section on ``cell_lines_small_default`` matches the stored float64
  oracle (Z_corr atol 1e-4, objective rtol 1e-5: the bounds of
  tests/test_parity_fixtures.py) with the keys of ``QUALITY.json``'s
  entries, and the section's ``meta`` entry names the device.
* ``python -m harmony_tpu_torch.tools.scaling_bench`` on the CPU: a 1-rank
  and a 2-rank leg (gloo) of one program, and the efficiency line.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from harmony_tpu_torch import bench as tbench
from harmony_tpu_torch import engine as tengine

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TINY = {"HARMONY_BENCH_CELLS": "4096", "HARMONY_BENCH_DIMS": "8", "HARMONY_BENCH_K": "8",
        "HARMONY_BENCH_BATCHES": "3", "HARMONY_BENCH_ITERS": "2", "HARMONY_BENCH_PAIRS": "2"}


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("HARMONY_BENCH_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def _harness(timeout=120.0, **extra):
    return subprocess.run([sys.executable, "-m", "harmony_tpu_torch.bench"], env=_env(**extra),
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_harness_prints_one_line_with_the_jax_payload_keys():
    import jax

    from harmony_tpu.bench import run_bench as jax_run_bench

    assert jax.default_backend() == "cpu"
    os.environ["HARMONY_BENCH_PAIRS"] = "1"
    try:
        ref = jax_run_bench(n_cells=2048, d=8, n_batches=3, nclust=8, max_iter=1,
                            shuffle_mode="rotate", baseline_cells_per_sec=1.0)
    finally:
        del os.environ["HARMONY_BENCH_PAIRS"]
    out = _harness(**TINY, HARMONY_BENCH_DEVICE="cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    payload = json.loads(lines[0])
    # "degraded" is optional in both payloads: it says that fewer pairs than
    # asked were valid (a non-positive delta under a loaded host), so it
    # comes and goes with timing noise; every other key must be the same
    assert set(payload) - {"degraded"} == set(ref) - {"degraded"}
    assert payload["platform"] == "cpu" and payload["n_cells"] == 4096
    assert payload["shuffle_mode"] == "rotate" and payload["value"] > 0
    assert payload["vs_baseline"] == round(payload["value"] / tbench.BASELINE_CELLS_PER_SEC, 3)


def test_harness_raises_without_a_card_and_refuses_sorted():
    import torch

    if not torch.cuda.is_available():
        out = _harness(**TINY)
        assert out.returncode != 0 and out.stdout == ""
        assert "no CUDA device" in out.stderr
    out = _harness(**TINY, HARMONY_BENCH_DEVICE="cpu", HARMONY_BENCH_SORTED="1")
    assert out.returncode != 0 and out.stdout == ""
    assert "permute_sorted_blocks" in out.stderr


def _sigterm_after(marker: str, **extra):
    """Start the harness (verbose), send SIGTERM once ``marker`` shows on
    its stderr, and return (exit code, stdout)."""
    p = subprocess.Popen([sys.executable, "-m", "harmony_tpu_torch.bench"],
                         env=_env(**extra, HARMONY_BENCH_VERBOSE="1"), cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        seen = ""
        while marker not in seen:
            line = p.stderr.readline()
            assert line or p.poll() is None, f"the harness ended first: {seen[-2000:]}"
            seen += line
            assert time.monotonic() < deadline, seen[-2000:]
        p.send_signal(signal.SIGTERM)
        so, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return p.returncode, so


def test_sigterm_before_the_warm_up_prints_nothing():
    rc, so = _sigterm_after("generating synthetic cells", **TINY, HARMONY_BENCH_DEVICE="cpu")
    assert so == "" and rc == 128 + signal.SIGTERM


def test_sigterm_after_the_warm_up_prints_one_line():
    # many timed rounds, so the run is still going when the signal comes
    rc, so = _sigterm_after("warm-up done", **{**TINY, "HARMONY_BENCH_ITERS": "400",
                                               "HARMONY_BENCH_PAIRS": "50"},
                            HARMONY_BENCH_DEVICE="cpu")
    lines = [ln for ln in so.splitlines() if ln.strip()]
    assert rc == 0 and len(lines) == 1, so
    payload = json.loads(lines[0])
    assert payload["metric"] == "cells_per_sec_per_chip_per_harmony_iter"
    assert payload["platform"] == "cpu"


def test_harness_knobs_reach_run_bench(monkeypatch, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"metric": "m", "value": 1.0}

    monkeypatch.setattr(tbench, "run_bench", fake)
    for k, v in {"HARMONY_BENCH_CELLS": "1234", "HARMONY_BENCH_DIMS": "7",
                 "HARMONY_BENCH_BATCHES": "4,25", "HARMONY_BENCH_K": "9",
                 "HARMONY_BENCH_ITERS": "3", "HARMONY_BENCH_BUDGET": "0",
                 "HARMONY_BENCH_ESTEP": "pallas", "HARMONY_BENCH_MSTEP": "segment",
                 "HARMONY_BENCH_SHUFFLE": "permute", "HARMONY_BENCH_DTYPE": "bfloat16",
                 "HARMONY_BENCH_MSTEP_IMPL": "xla", "HARMONY_BENCH_VARIANT": "legacy",
                 "HARMONY_BENCH_SUBTILE": "2560", "HARMONY_BENCH_TILED": "0",
                 "HARMONY_BENCH_VIRTUAL": "1", "HARMONY_BENCH_DEVICE": "cpu"}.items():
        monkeypatch.setenv(k, v)
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        assert tbench.main() == 0
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert json.loads(capsys.readouterr().out.strip()) == {"metric": "m", "value": 1.0}
    assert seen == dict(
        n_cells=1234, d=7, n_batches=[4, 25], nclust=9, max_iter=3,
        baseline_cells_per_sec=tbench.BASELINE_CELLS_PER_SEC, estep_impl="kernel",
        mstep_mode="segment", mesh=None, shuffle_mode="permute", dtype="bfloat16",
        virtual_r=True, budget_s=None, progress_cb=seen["progress_cb"], device="cpu",
        mstep_impl="torch", estep_variant="legacy", estep_sub_tile=2560, tiled=False)


@pytest.mark.parametrize("kw,want", [
    (dict(shuffle_mode="rotate", estep_variant="legacy", estep_sub_tile=512, virtual_r=False),
     dict(estep_variant="legacy", estep_sub_tile=512, virtual_r=False)),
    (dict(shuffle_mode="permute", mstep_impl="torch"),
     dict(shuffle_mode="permute", mstep_impl="torch")),
    (dict(shuffle_mode="rotate", virtual_r=True, mstep_mode="tiled"),
     dict(virtual_r=True, mstep_mode="tiled")),
])
def test_run_bench_arguments_reach_the_config(monkeypatch, kw, want):
    seen = []
    real = tengine.harmony_round

    def spy(cfg, *a, **k):
        seen.append(cfg)
        return real(cfg, *a, **k)

    monkeypatch.setattr(tengine, "harmony_round", spy)
    monkeypatch.setenv("HARMONY_BENCH_PAIRS", "1")
    out = tbench.run_bench(n_cells=16_384, d=8, n_batches=3, nclust=8, max_iter=1,
                           device="cpu", **kw)
    assert seen and out["platform"] == "cpu"
    for k, v in want.items():
        assert getattr(seen[0], k) == v, k


def test_run_bench_without_the_tiled_order_takes_another_m_step(monkeypatch):
    monkeypatch.setenv("HARMONY_BENCH_PAIRS", "1")
    kw = dict(n_cells=16_384, d=8, n_batches=3, nclust=8, max_iter=1, device="cpu",
              shuffle_mode="rotate")
    assert tbench.run_bench(**kw)["mstep"] == "tiled"
    assert tbench.run_bench(**kw, tiled=False)["mstep"] == "dense"


def test_quality_bench_parity_matches_the_stored_oracle(tmp_path):
    from harmony_tpu_torch.tools import quality_bench

    out = tmp_path / "q.json"
    quality_bench.main(["--sections", "parity", "--out", str(out), "--device", "cpu"])
    doc = json.loads(out.read_text())
    with open(os.path.join(ROOT, "QUALITY.json")) as fh:
        jax_doc = json.load(fh)
    assert set(doc["parity"]) == set(jax_doc["parity"])
    for name, entry in doc["parity"].items():
        assert set(entry) == set(jax_doc["parity"][name])
    entry = doc["parity"]["cell_lines_small_default"]
    assert entry["max_abs_err_vs_oracle"] <= 1e-4
    assert entry["objective_max_rel_delta_vs_oracle"] <= 1e-5
    assert set(doc["meta"]["parity"]) == set(jax_doc["meta"]["parity"])
    assert doc["meta"]["parity"]["platform"] == "cpu"
    # the fixture replayed directly: the same numbers
    z = np.load(os.path.join(quality_bench.FIXDIR, "cell_lines_small_default.npz"))
    assert entry["n_cells"] == z["codes"].shape[1]


def test_scaling_bench_runs_one_program_on_one_and_two_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "harmony_tpu_torch.tools.scaling_bench", "--ranks", "2",
         "--cells", "8192", "--dims", "8", "--batches", "3", "--nclust", "8",
         "--device", "cpu", "--timeout", "150"],
        env=_env(HARMONY_BENCH_PAIRS="1"), capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert [ln.get("devices") for ln in lines[:2]] == [1, 2]
    assert all(ln["platform"] == "cpu" and ln["cells_per_sec_total"] > 0 for ln in lines[:2])
    eff = lines[2]
    assert eff["metric"] == "multi_device_scaling_efficiency" and eff["backend"] == "gloo"
    assert eff["value"] == round(lines[1]["cells_per_sec_total"]
                                 / (lines[0]["cells_per_sec_total"] * 2), 4)
