"""The ``harmony-torch`` command and ``harmony_tpu_torch.bench``, on the CPU.

* ``harmony-torch run --device cpu`` writes what ``run_harmony`` returns
  for the same arguments (equal arrays), from ``.npy`` and ``.csv``.
* A rotate run with ``--checkpoint``, two rounds, then the same command
  again, which resumes for one: the output equals an uninterrupted
  three-round run within 5e-4 (``tests/test_cli.py:154``'s bound); the
  resume warns about the flags it ignores. ``--mesh auto`` in one process
  (no torchrun) runs on one device, a resume too, as the JAX command's
  does; its runs on ranks are in ``test_torch_mesh_run.py``.
* ``harmony-torch bench --device cpu`` prints one JSON line with the JAX
  package's payload keys (``harmony_tpu/bench.py:242-274``);
  ``make_synthetic_cells`` equals the JAX package's bit for bit.
"""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest

from harmony_tpu import bench as jbench
from harmony_tpu_torch import bench, cli, run_harmony, harmony_options

# the payload keys of harmony_tpu/bench.py:242-274 without the optional
# "degraded" and "vs_baseline"
PAYLOAD_KEYS = {
    "metric", "value", "unit", "n_cells", "d", "K", "n_batches", "seconds_per_iter",
    "first_iter_with_compile_s", "n_devices", "platform", "estep_impl", "mstep",
    "shuffle_mode", "dtype",
}


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(4)
    n, d = 4096, 8
    b = rng.integers(0, 3, n)
    Z = ((rng.normal(size=(3, d)) * 0.8)[b] + rng.normal(size=(n, d))).astype(np.float32)
    np.save(tmp_path / "emb.npy", Z)
    np.savetxt(tmp_path / "emb.csv", Z, delimiter=",", header=",".join(f"pc{i}" for i in
                                                                      range(d)), comments="")
    with open(tmp_path / "meta.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["dataset"])
        w.writerows([[f"b{x}"] for x in b])
    return tmp_path, Z, {"dataset": np.array([f"b{x}" for x in b])}


def _run(tmp, out, *extra, emb="emb.npy"):
    return cli.main(["run", "--embeddings", str(tmp / emb), "--meta", str(tmp / "meta.csv"),
                     "--vars", "dataset", "--out", str(tmp / out), "--nclust", "6",
                     "--device", "cpu", *extra])


@pytest.mark.parametrize("emb", ["emb.npy", "emb.csv"])
def test_run_equals_run_harmony(files, emb):
    tmp, Z, meta = files
    assert _run(tmp, "out.npy", "--max-iter", "2", "--seed", "3", emb=emb) == 0
    want = run_harmony(Z.astype(np.float64) if emb.endswith("csv") else Z, meta, ["dataset"],
                       nclust=6, max_iter=2, seed=3, device="cpu", options=harmony_options())
    np.testing.assert_array_equal(np.load(tmp / "out.npy"), want)


def test_checkpoint_then_resume_equals_uninterrupted(files, capsys):
    tmp, Z, meta = files
    flags = ("--shuffle-mode", "rotate")
    assert _run(tmp, "a.npy", "--max-iter", "2", "--checkpoint", str(tmp / "ck"), *flags) == 0
    with np.load(tmp / "ck.npz") as z:
        assert int(z["n_rounds"]) == 2  # no early stop before the resume
    capsys.readouterr()
    assert _run(tmp, "b.npy", "--max-iter", "1", "--checkpoint", str(tmp / "ck"), *flags) == 0
    err = capsys.readouterr()
    assert "resuming from checkpoint" in err.out
    assert "ignoring --nclust, --shuffle-mode" in err.err
    with np.load(tmp / "ck.npz") as z:
        assert int(z["n_rounds"]) == 3
    full = run_harmony(Z, meta, ["dataset"], nclust=6, max_iter=3, early_stop=False,
                       shuffle_mode="rotate", device="cpu")
    np.testing.assert_allclose(np.load(tmp / "b.npy"), full, rtol=0, atol=5e-4)


def test_resume_with_mesh_raises(files, monkeypatch):
    """Ported: ``--mesh auto`` without torchrun's ranks (WORLD_SIZE unset or
    1) is one device, for a run and for a resume (the name is the one the
    test had while the flag raised)."""
    tmp, _, _ = files
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert _run(tmp, "a.npy", "--max-iter", "1", "--checkpoint", str(tmp / "ck")) == 0
    assert _run(tmp, "b.npy", "--max-iter", "1", "--checkpoint", str(tmp / "ck"),
                "--mesh", "auto") == 0
    with np.load(tmp / "ck.npz") as z:
        assert int(z["n_rounds"]) == 2
    assert _run(tmp, "c.npy", "--max-iter", "1", "--mesh", "auto") == 0
    np.testing.assert_array_equal(np.load(tmp / "c.npy"), np.load(tmp / "a.npy"))


def test_bench_prints_the_payload(capsys, monkeypatch):
    monkeypatch.setenv("HARMONY_BENCH_PAIRS", "2")
    assert cli.main(["bench", "--cells", "3000", "--dims", "8", "--batches", "3",
                     "--nclust", "6", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert set(payload) == PAYLOAD_KEYS
    assert payload["metric"] == "cells_per_sec_per_chip_per_harmony_iter"
    assert payload["platform"] == "cpu" and payload["shuffle_mode"] == "rotate"
    assert payload["value"] > 0 and payload["n_devices"] == 1


def test_bench_budget_and_progress(monkeypatch):
    monkeypatch.setenv("HARMONY_BENCH_PAIRS", "3")
    seen = []
    out = bench.run_bench(n_cells=1200, d=6, n_batches=2, nclust=4, device="cpu",
                          budget_s=0.0, progress_cb=seen.append)
    assert seen[0]["degraded"] == "warmup_lower_bound"
    assert out["degraded"] == 1 and set(out) == PAYLOAD_KEYS | {"degraded"}


@pytest.mark.parametrize("n_batches", [4, (3, 2)])
def test_make_synthetic_cells_equals_jax(n_batches):
    Z, b = bench.make_synthetic_cells(2000, 12, n_batches, seed=5)
    Zj, bj = jbench.make_synthetic_cells(2000, 12, n_batches, seed=5)
    assert Z.dtype == Zj.dtype == np.float32
    np.testing.assert_array_equal(Z, Zj)
    if isinstance(b, dict):
        assert set(b) == set(bj)
        for k in b:
            np.testing.assert_array_equal(b[k], bj[k])
    else:
        np.testing.assert_array_equal(b, bj)
