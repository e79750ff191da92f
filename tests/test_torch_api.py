"""The run_harmony surface of harmony_tpu_torch, on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import harmony_tpu
import harmony_tpu_torch
from harmony_tpu_torch import HarmonyConfigError, run_harmony

from conftest import make_synthetic

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _separation(Z, batches):
    """Mean pairwise distance of batch centroids in L2-normalised space
    (Z is (N, d))."""
    Zn = Z / np.linalg.norm(Z, axis=1, keepdims=True)
    c = np.stack([Zn[batches == b].mean(0) for b in np.unique(batches)])
    dd = np.linalg.norm(c[:, None] - c[None], axis=-1)
    return dd.sum() / (len(c) * (len(c) - 1))


def test_run_harmony_end_to_end_result_object():
    rng = np.random.default_rng(0)
    n, d = 1500, 12
    batches = rng.integers(0, 3, n)
    types = rng.integers(0, 4, n)
    Z = (rng.normal(size=(4, d)) * 3)[types] + (rng.normal(size=(3, d)) * 0.8)[batches] \
        + rng.normal(size=(n, d))
    res = run_harmony(Z, {"dataset": batches.astype(str)}, ["dataset"],
                      return_object=True, seed=0, device="cpu", lamb=None)
    emb = res.embeddings
    assert emb.shape == (n, d) and np.isfinite(emb).all()
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
    assert _separation(emb, batches) < _separation(Z, batches)
    assert res.W.shape == (res.K, res.B + 1, d)
    np.testing.assert_array_equal(res.W[:, 0, :], 0.0)
    lam = res.get_lambda()
    assert lam.shape == (res.K, res.B + 1)
    np.testing.assert_allclose(lam[:, 1:], 0.2 * res.E, rtol=1e-6)
    assert len(res.objective_harmony) == len(res.kmeans_rounds) + 1
    assert len(res.objective_kmeans) == 1 + res.kmeans_rounds.sum()
    assert set(res.phase_seconds()) >= {"init_cluster", "cluster", "correct"}
    assert res.state.Z_corr.device.type == "cpu"


def test_run_harmony_fixed_lambda_and_vector_metadata():
    Z, meta = make_synthetic(None, n_cells=200, d=6, seed=2)
    out = run_harmony(Z, meta["dataset"], lamb=1.0, max_iter=2, device="cpu",
                      return_object=True)
    assert out.config.B_vec == (3,)
    assert out.config.lambda_estimation is False
    np.testing.assert_allclose(out.get_lambda(), 1.0 * (np.arange(4) > 0)[None].repeat(out.K, 0))
    emb = run_harmony(Z, meta, ["dataset", "cell_type"], theta=[1.0, 1.0], lamb=1.0,
                      max_iter=2, device="cpu")
    assert emb.shape == Z.shape and np.isfinite(emb).all()


def test_run_harmony_small_n_forces_block_size():
    Z, meta = make_synthetic(None, n_cells=30, d=4, seed=3)
    res = run_harmony(Z, meta, ["dataset"], nclust=3, max_iter=2, device="cpu",
                      return_object=True)
    assert res.config.n_blocks == 5 and res.config.cells_per_block == 6
    assert np.isfinite(res.embeddings).all()


def test_run_harmony_matches_between_kernel_and_torch_impls_on_cpu():
    Z, meta = make_synthetic(None, n_cells=300, d=6, seed=4)
    kw = dict(max_iter=2, device="cpu", seed=1, lamb=1.0)
    a = run_harmony(Z, meta, ["dataset"], estep_impl="kernel", mstep_impl="kernel", **kw)
    b = run_harmony(Z, meta, ["dataset"], estep_impl="torch", mstep_impl="torch", **kw)
    np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize(
    "kwargs,item",
    [
        ({"shuffle_mode": "rotate"}, "ROADMAP A9"),
        ({"mesh": "auto"}, "ROADMAP A11"),
        ({"checkpoint_path": "x.npz"}, "ROADMAP A10"),
        ({"stream_ingest": True}, "ROADMAP A10"),
        ({"virtual_r": True}, "ROADMAP A9"),
        ({"dtype": "bfloat16"}, "ROADMAP A9"),
        ({"matmul_precision": "bfloat16"}, "ROADMAP A9"),
        ({"plot_convergence": True}, "ROADMAP A10"),
    ],
)
def test_unported_paths_raise(kwargs, item):
    Z, meta = make_synthetic(None, n_cells=60, d=4, seed=5)
    with pytest.raises(NotImplementedError, match=item):
        run_harmony(Z, meta, ["dataset"], device="cpu", **kwargs)


def test_auto_shuffle_mode_at_scale_is_rotate_and_not_ported():
    from harmony_tpu.api import _resolve_shuffle_mode as jres
    from harmony_tpu_torch.api import _resolve_shuffle_mode as tres

    for args in [("auto", 99_999, False), ("auto", 100_000, False),
                 ("auto", 500_000, True), ("permute", 500_000, False),
                 ("rotate", 10, False)]:
        assert tres(*args, False) == jres(*args, False)
    Z = np.zeros((100_000, 2), np.float32)
    with pytest.raises(NotImplementedError, match="rotate"):
        run_harmony(Z, np.zeros(100_000), device="cpu")


def test_anndata_like_input_raises():
    class FakeAnnData:
        obsm, obs = {}, {}

    with pytest.raises(NotImplementedError, match="AnnData"):
        run_harmony(FakeAnnData(), "batch", device="cpu")


def test_config_errors_match_the_jax_api():
    Z, meta = make_synthetic(None, n_cells=60, d=4, seed=6)
    for kwargs in [{"max_iter_harmony": 3}, {"tau": 1.0}, {"nope": 1}]:
        with pytest.raises(harmony_tpu.HarmonyConfigError) as je:
            harmony_tpu.run_harmony(Z, meta, ["dataset"], **kwargs)
        with pytest.raises(HarmonyConfigError) as te:
            run_harmony(Z, meta, ["dataset"], device="cpu", **kwargs)
        assert str(te.value) == str(je.value)
    with pytest.raises(HarmonyConfigError, match="less than 6 cells"):
        run_harmony(Z[:5], meta["dataset"][:5], device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Z, meta = make_synthetic(None, n_cells=60, d=4, seed=7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_harmony(Z, meta, ["dataset"])


def test_import_loads_neither_jax_nor_harmony_tpu():
    code = (
        "import sys, harmony_tpu_torch, harmony_tpu_torch.ops.cuda_estep, "
        "harmony_tpu_torch.ops.cuda_ridge, harmony_tpu_torch._build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'harmony_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert harmony_tpu_torch.__name__ == "harmony_tpu_torch"
