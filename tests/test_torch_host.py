"""The host modules around the port's engine, on the CPU.

* ``runtime.AbortFlag``: set before the run, and set from another thread
  between rounds: the run raises ``KeyboardInterrupt`` before the next
  round. ``runtime.trace`` writes a Chrome trace holding the ``cluster``
  and ``correct`` spans; ``PhaseTimers.report`` lists each scope.
* ``plot.convergence_plot`` under the Agg backend, alone and through
  ``run_harmony(plot_convergence=True)``.
* ``scale.scale_data`` (native C++ and NumPy paths, sparse and dense)
  against ``harmony_tpu.scale.scale_data`` at rtol 1e-12; the native
  ``csc_scale_rows`` against NumPy.
* The ``datasets`` loaders against the JAX package's: equal arrays;
  ``pbmc_dataset`` at rtol 1e-10.
* The adapters with a stand-in AnnData object (``obsm``, ``obs``,
  ``n_obs``, ``X``, ``varm``), the ``run_harmony`` dispatch to it, and
  ``run_harmony_dataframe`` (pandas).
"""

from __future__ import annotations

import glob
import threading

import numpy as np
import pytest
import scipy.sparse as sp

from harmony_tpu import datasets as jdatasets
from harmony_tpu import scale as jscale
from harmony_tpu_torch import AbortFlag, run_harmony
from harmony_tpu_torch import adapters, datasets, native, scale
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch.plot import convergence_plot
from harmony_tpu_torch.runtime import PhaseTimers, trace


def _problem(n=600, d=6, B=3, seed=2):
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    return Z, {"dataset": batches.astype(str)}


KW = dict(nclust=4, seed=0, device="cpu", early_stop=False)


def test_abort_set_before_the_run():
    flag = AbortFlag()
    flag.set()
    with pytest.raises(KeyboardInterrupt):
        run_harmony(*_problem(), ["dataset"], max_iter=3, abort=flag, **KW)


def test_abort_set_from_a_thread_between_rounds(monkeypatch):
    """A thread sets the flag once round 1's correction is done; the poll
    before round 2 sees it."""
    flag = AbortFlag()
    round_done = threading.Event()
    setter = threading.Thread(target=lambda: (round_done.wait(30), flag.set()))
    setter.start()
    correct = tengine.correct
    rounds = []

    def signalling(cfg, state, layout=None, mesh=None):
        out = correct(cfg, state, layout, mesh)
        rounds.append(out.n_rounds)
        round_done.set()
        setter.join(30)
        return out

    monkeypatch.setattr(tengine, "correct", signalling)
    with pytest.raises(KeyboardInterrupt):
        run_harmony(*_problem(), ["dataset"], max_iter=5, abort=flag, **KW)
    assert not setter.is_alive() and flag.aborted() and rounds == [1]


def test_trace_holds_the_engine_spans(tmp_path):
    """The default run takes the one-dispatch path (engine.run_rounds), one
    span for its iterations; the host loop (verbose) has a span a phase."""
    spans = {"default": ("init_cluster", "run_rounds", "materialize_r"),
             "verbose": ("init_cluster", "cluster", "correct", "materialize_r")}
    for how, names in spans.items():
        out = tmp_path / how
        with trace(str(out)):
            run_harmony(*_problem(), ["dataset"], max_iter=1, verbose=how == "verbose", **KW)
        files = glob.glob(str(out / "*.json"))
        assert len(files) == 1
        text = open(files[0]).read()
        for name in names:
            assert f'"name": "{name}"' in text, (how, name)


def test_phase_timers_report():
    timers = PhaseTimers()
    for _ in range(3):
        with timers.scope("cluster"):
            pass
    with timers.scope("correct"):
        pass
    lines = timers.report().splitlines()
    assert len(lines) == 2 and "cluster" in lines[0] and "over 3 calls" in lines[0]
    assert "over 1 calls" in lines[1] and set(timers.as_dict()) == {"cluster", "correct"}


def test_convergence_plot_under_agg(monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    res = run_harmony(*_problem(), ["dataset"], max_iter=2, return_object=True, **KW)
    ax = convergence_plot(res)
    assert len(ax.collections) == len(res.kmeans_rounds) == 2
    n_points = sum(len(c.get_offsets()) for c in ax.collections)
    assert n_points == int(np.sum(res.kmeans_rounds))
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    run_harmony(*_problem(), ["dataset"], max_iter=2, plot_convergence=True, **KW)
    assert len(shown) == 1 and shown[0].axes[0].get_xlabel() == "Clustering Step #"
    plt.close("all")


def _counts(seed=0, shape=(40, 30), density=0.3):
    rng = np.random.default_rng(seed)
    M = sp.random(*shape, density=density, format="csr", random_state=seed,
                  data_rvs=lambda n: rng.poisson(3.0, n) + 1.0).toarray()
    M[3] = 0  # a row of zeros: sd 0, kept at 1
    return sp.csc_matrix(M)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("margin", [1, 2])
def test_scale_data_sparse_matches_jax(monkeypatch, path, margin):
    if path == "native":
        assert native.available(), "g++ builds native/scale_csc.cpp"
    else:
        monkeypatch.setattr(native, "_LIB", False)
    M = _counts()
    out = scale.scale_data(M, margin=margin, thresh=2.5)
    np.testing.assert_allclose(out, jscale.scale_data(M, margin=margin, thresh=2.5),
                               rtol=1e-12, atol=1e-12)


def test_scale_data_dense_matches_jax():
    A = _counts().toarray()
    for margin in (1, 2):
        np.testing.assert_allclose(scale.scale_data(A, margin, 3.0),
                                   jscale.scale_data(A, margin, 3.0), rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        scale.scale_data(A, margin=3)


def test_csc_helpers_against_numpy():
    M = _counts(seed=1)
    nrow, ncol = M.shape
    dense = M.toarray()
    mean, sd = dense.mean(1, keepdims=True), dense.std(1, ddof=1, keepdims=True)
    want = np.clip((dense - mean) / np.where(sd == 0, 1, sd), -10.0, 10.0)
    out = native.csc_scale_rows(M.data, M.indices, M.indptr, nrow, ncol, 10.0)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        native.csc_scale_rows(M.data, M.indices + nrow, M.indptr, nrow, ncol, 10.0)


@pytest.mark.parametrize("name", ["cell_lines", "cell_lines_small"])
def test_cell_lines_equal_jax(name):
    ours, theirs = getattr(datasets, name)(), getattr(jdatasets, name)()
    assert ours.name == theirs.name == name
    np.testing.assert_array_equal(ours.scaled_pcs, theirs.scaled_pcs)
    assert set(ours.meta_data) == set(theirs.meta_data)
    for k in ours.meta_data:
        np.testing.assert_array_equal(ours.meta_data[k], theirs.meta_data[k])


def test_pbmc_equal_jax():
    for a, b in zip(datasets.pbmc_stim(), jdatasets.pbmc_stim()):
        assert a.shape == b.shape
        for f in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ours, theirs = datasets.pbmc_dataset(n_pcs=10), jdatasets.pbmc_dataset(n_pcs=10)
    np.testing.assert_allclose(ours.scaled_pcs, theirs.scaled_pcs, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(ours.meta_data["stim"], theirs.meta_data["stim"])


def test_synthetic_fallback_equals_jax(tmp_path):
    ours = datasets.cell_lines_small(path=str(tmp_path))
    theirs = jdatasets.cell_lines_small(path=str(tmp_path))
    assert ours.name == theirs.name == "cell_lines_small_synthetic"
    np.testing.assert_array_equal(ours.scaled_pcs, theirs.scaled_pcs)


class _AnnData:
    def __init__(self, Z, obs, X=None):
        self.obsm = {"X_pca": Z}
        self.obs = obs
        self.n_obs = Z.shape[0]
        self.X = X
        self.varm = {} if X is not None else None


def test_anndata_adapter_and_dispatch():
    Z, meta = _problem()
    X = np.random.default_rng(0).normal(size=(Z.shape[0], 5))
    want = run_harmony(Z, meta, ["dataset"], max_iter=2, **KW)
    ad = adapters.run_harmony_anndata(_AnnData(Z, meta, X), ["dataset"], max_iter=2, **KW)
    np.testing.assert_array_equal(ad.obsm["X_harmony"], want)
    np.testing.assert_allclose(ad.varm["X_harmony"], X.T @ want, rtol=1e-12)
    via = run_harmony(_AnnData(Z, meta), "dataset", max_iter=2, **KW)
    np.testing.assert_array_equal(via.obsm["X_harmony"], want)
    sub = adapters.run_harmony_anndata(_AnnData(Z, meta), ["dataset"], dims_use=[0, 2, 4],
                                       max_iter=2, **KW)
    np.testing.assert_array_equal(sub.obsm["X_harmony"],
                                  run_harmony(Z[:, [0, 2, 4]], meta, ["dataset"],
                                              max_iter=2, **KW))
    from harmony_tpu_torch.config import HarmonyConfigError

    with pytest.raises(HarmonyConfigError, match="missing"):
        adapters.run_harmony_anndata(_AnnData(Z, meta), ["nope"], **KW)
    with pytest.raises(HarmonyConfigError, match="one dimension"):
        adapters.run_harmony_anndata(_AnnData(Z, meta), ["dataset"], dims_use=[1], **KW)


def test_dataframe_adapter():
    pd = pytest.importorskip("pandas")
    Z, meta = _problem()
    emb = pd.DataFrame(Z, index=[f"c{i}" for i in range(len(Z))])
    out = adapters.run_harmony_dataframe(emb, pd.DataFrame(meta), ["dataset"], max_iter=2,
                                         **KW)
    assert list(out.columns) == [f"harmony_{i + 1}" for i in range(Z.shape[1])]
    assert (out.index == emb.index).all()
    np.testing.assert_array_equal(out.to_numpy(),
                                  run_harmony(Z, meta, ["dataset"], max_iter=2, **KW))
