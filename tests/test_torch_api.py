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
    assert set(res.phase_seconds()) >= {"init_cluster", "run_rounds", "materialize_r"}
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
        # ported: small rotate runs take the cell-granular round (the id is
        # the one the case had while it raised)
        pytest.param({"shuffle_mode": "rotate"}, "cell", id="kwargs0-ROADMAP A9"),
        # ported: in one process (no torch.distributed group) "auto" is one
        # device, as the JAX package's "auto" is on one device (the id is
        # the one the case had while it raised)
        pytest.param({"mesh": "auto"}, "mesh", id="kwargs1-ROADMAP A11"),
        # ported: checkpoints, streamed ingest and the convergence plot run
        # (the ids are the ones the cases had while they raised)
        pytest.param({"checkpoint_path": "x.npz"}, "checkpoint", id="kwargs2-ROADMAP A10"),
        pytest.param({"stream_ingest": True}, "stream", id="kwargs3-ROADMAP A10"),
        ({"virtual_r": True}, None),
        # ported: the bf16 engine and the bf16 precision permission resolve
        # (the ids are the ones the cases had while they raised)
        pytest.param({"dtype": "bfloat16"}, "bf16",
                     id="kwargs5-ROADMAP A9, reduced-precision engines"),
        pytest.param({"matmul_precision": "bfloat16"}, "bf16", id="kwargs6-ROADMAP A9"),
        pytest.param({"plot_convergence": True}, "plot", id="kwargs7-ROADMAP A10"),
        # ported: the float16 engine resolves and runs (the id is the one
        # the case had while it raised)
        pytest.param({"dtype": "float16"}, "f16", id="kwargs8-ROADMAP A9, float16 engines"),
    ],
)
def test_unported_paths_raise(kwargs, item, tmp_path, monkeypatch):
    Z, meta = make_synthetic(None, n_cells=60, d=4, seed=5)
    if item == "checkpoint":
        path = str(tmp_path / kwargs["checkpoint_path"])
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True,
                          checkpoint_path=path)
        with np.load(path) as z:
            assert int(z["n_harmony"]) == res.state.n_harmony
        return
    if item == "stream":
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True, **kwargs)
        assert "ingest_stream" in res.phase_seconds() and np.isfinite(res.embeddings).all()
        return
    if item == "plot":
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        shown = []
        monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
        run_harmony(Z, meta, ["dataset"], device="cpu", **kwargs)
        assert len(shown) == 1 and len(shown[0].axes[0].collections) > 0
        plt.close("all")
        return
    if item == "bf16":
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True, **kwargs)
        assert res.config.matmul_precision == "bfloat16"
        dt = torch.bfloat16 if "dtype" in kwargs else torch.float32
        assert res.state.Z_corr.dtype == res.state.R.dtype == dt
        assert res.R.dtype == np.float32 and np.isfinite(res.embeddings).all()
        np.testing.assert_allclose(res.R.sum(0), 1.0, atol=5e-3)
        return
    if item == "f16":
        # float16 is numpy's own: the result arrays are float16
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True, **kwargs)
        assert res.config.matmul_precision == "bfloat16" and res.config.bf16_products
        assert res.state.Z_corr.dtype == res.state.R.dtype == torch.float16
        assert res.R.dtype == np.float16 and np.isfinite(res.embeddings).all()
        np.testing.assert_allclose(res.R.astype(np.float64).sum(0), 1.0, atol=5e-3)
        return
    if item is None:
        # ported: on this permute run the virtual-R gate ignores it, as the
        # JAX package's does
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True, **kwargs)
        assert res.config.virtual_r and res.config.shuffle_mode == "permute"
        assert res.state.virt_pen is None and np.isfinite(res.embeddings).all()
        return
    if item == "mesh":
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True, **kwargs)
        assert res.mesh is None and res.config.n_shards == 1
        np.testing.assert_array_equal(res.embeddings,
                                      run_harmony(Z, meta, ["dataset"], device="cpu"))
        return
    if item == "cell":
        res = run_harmony(Z, meta, ["dataset"], device="cpu", return_object=True, **kwargs)
        assert res.config.rotate_route == "cell" and res.config.Np == 60
        np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-5)
        assert np.isfinite(res.embeddings).all()
        return
    with pytest.raises(NotImplementedError, match=item):
        run_harmony(Z, meta, ["dataset"], device="cpu", **kwargs)


def test_auto_shuffle_mode_at_scale_is_rotate_and_not_ported():
    from harmony_tpu.api import _resolve_shuffle_mode as jres
    from harmony_tpu_torch.api import _resolve_shuffle_mode as tres

    for args in [("auto", 99_999, False), ("auto", 100_000, False),
                 ("auto", 500_000, True), ("permute", 500_000, False),
                 ("rotate", 10, False)]:
        assert tres(*args, False) == jres(*args, False)
    # 'auto' at 100k cells now runs the rotate schedule and hands the
    # output back in the caller's cell order
    rng = np.random.default_rng(9)
    n, d = 100_000, 4
    batches = rng.integers(0, 3, n)
    types = rng.integers(0, 4, n)
    Z = ((rng.normal(size=(4, d)) * 3)[types] + (rng.normal(size=(3, d)) * 0.8)[batches]
         + rng.normal(size=(n, d))).astype(np.float32)
    res = run_harmony(Z, {"batch": batches}, ["batch"], nclust=8, max_iter=2,
                      device="cpu", return_object=True)
    assert res.config.shuffle_mode == "rotate" and res.config.Np % res.config.estep_sub_tile == 0
    assert res.ingest_inv is not None and not np.array_equal(res.ingest_inv, np.arange(n))
    np.testing.assert_array_equal(res.Z_orig, Z.T)
    emb = res.embeddings
    assert emb.shape == (n, d) and np.isfinite(emb).all()
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
    assert _separation(emb, batches) < _separation(Z, batches)
    assert res.W.shape == (8, 4, d)


def test_anndata_like_input_raises():
    """Ported: an AnnData-like object goes to the adapter, which raises, as
    the JAX package's does, when the object has no PCA embedding."""
    class FakeAnnData:
        obsm, obs = {}, {}

    with pytest.raises(HarmonyConfigError, match="X_pca cell embeddings not found in AnnData"):
        run_harmony(FakeAnnData(), "batch", device="cpu")
    with pytest.raises(harmony_tpu.HarmonyConfigError, match="X_pca cell embeddings not found"):
        harmony_tpu.run_harmony(FakeAnnData(), "batch")


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
        "harmony_tpu_torch.ops.cuda_ridge, harmony_tpu_torch.ops.cuda_rotate, "
        "harmony_tpu_torch.ops.rotate, harmony_tpu_torch.ops.tiled, harmony_tpu_torch._build\n"
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
