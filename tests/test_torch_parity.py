"""Whole-run parity of harmony_tpu_torch against the JAX engine and the
vendored fixtures.

Both packages get the same injected randomness (initial centroids and the
per-round permutations), so any difference is fp32 summation order. The
port runs on the CPU, where its kernel wrappers run their plain twins.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from harmony_tpu.config import harmony_options
from harmony_tpu.driver import harmonize as jax_harmonize
from harmony_tpu.engine import make_engine
from harmony_tpu.preprocess import (
    build_design, expand_hyperparams, orient_embedding,
    resolve_config,
)
from harmony_tpu.state import init_state as jax_init_state

from harmony_tpu_torch import driver as tdriver, engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch.config import finalize_engine_config
from harmony_tpu_torch.state import (
    init_state, state_from_arrays, state_to_arrays,
)

from conftest import make_synthetic

_FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "parity")
_NAMES = [
    "cell_lines_small_default",
    "cell_lines_small_twocov",
    "pbmc_stim_default",
    "synthetic_threecov",
]


def _jax_state_arrays(state):
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
        if getattr(state, f.name) is not None
    }


def _port_cfg(Zt, meta, vars_use, nclust, lamb, max_iter, opts, mstep_impl,
              ridge_solver="auto"):
    design = tpre.build_design(meta, vars_use)
    cfg = tpre.resolve_config(
        n_cells=design.n_cells, d=Zt.shape[0], design=design, nclust=nclust,
        max_iter=max_iter, early_stop=True, options=opts, verbose=False,
        lambda_estimation=lamb is None, ridge_solver=ridge_solver,
    )
    cfg = dataclasses.replace(cfg, mstep_impl=mstep_impl)
    return finalize_engine_config(cfg), design


def _run_both(Z, meta, vars_use, lamb, mstep_impl, opts, nclust, max_iter, theta):
    """Run the JAX engine and the port (from the JAX post-init state and
    from its own init) on the same injected randomness."""
    jdesign = build_design(meta, vars_use)
    N = jdesign.n_cells
    Zt = orient_embedding(Z, N)
    jcfg = resolve_config(
        n_cells=N, d=Zt.shape[0], design=jdesign, nclust=nclust,
        max_iter=max_iter, early_stop=True, options=opts, verbose=False,
        lambda_estimation=lamb is None, ridge_solver="auto",
    )
    hp = expand_hyperparams(jdesign, jcfg.K, theta, 0.1, lamb, opts.tau)
    rng = np.random.default_rng(0)
    Y0 = Zt[:, rng.choice(N, jcfg.K, replace=False)]
    perms = np.stack([
        np.stack([rng.permutation(N) for _ in range(jcfg.max_iter_cluster)])
        for _ in range(max_iter)
    ]).astype(np.int32)

    jstate = jax_init_state(jcfg, Zt, jdesign, hp.sigma, hp.theta, hp.lamb,
                            jax.random.PRNGKey(0))
    eng = make_engine(jcfg)
    jstate = eng.init_cluster_from(jstate, jnp.asarray(Y0))
    j_after_init = _jax_state_arrays(jstate)
    jstate = jax_harmonize(eng, jstate, max_iter=max_iter, perms=perms)

    cfg, design = _port_cfg(Zt, meta, vars_use, nclust, lamb, max_iter, opts,
                            mstep_impl)
    s1 = state_from_arrays(cfg, j_after_init, "cpu")
    s1 = tdriver.harmonize(cfg, s1, max_iter=max_iter, perms=perms)
    s2 = init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, 0, "cpu")
    s2 = tengine.init_cluster_from(cfg, s2, Y0)
    s2 = tdriver.harmonize(cfg, s2, max_iter=max_iter, perms=perms)
    return jcfg, jstate, cfg, (s1, s2)


def _assert_same_run(jcfg, jstate, cfg, states):
    """Objective traces rtol 1e-5, R and Y atol 1e-5. Z_corr is on the
    data's scale (|Z| up to ~10, not the unit sphere), where a few rounds
    of fp32 summation-order differences reach ~1.5e-5; its bound is the
    fixtures' oracle bound, atol 1e-4."""
    jtr = jstate.trace_lists(jcfg)
    for s in states:
        tr = s.trace_lists(cfg)
        np.testing.assert_allclose(tr["objective_kmeans"], jtr["objective_kmeans"], rtol=1e-5)
        np.testing.assert_allclose(tr["objective_harmony"], jtr["objective_harmony"], rtol=1e-5)
        np.testing.assert_array_equal(tr["kmeans_rounds"], jtr["kmeans_rounds"])
        arr = state_to_arrays(s)
        np.testing.assert_allclose(arr["Z_corr"], np.asarray(jstate.Z_corr), atol=1e-4)
        np.testing.assert_allclose(arr["R"], np.asarray(jstate.R), atol=1e-5)
        np.testing.assert_allclose(arr["Y"], np.asarray(jstate.Y), atol=1e-5)


@pytest.mark.parametrize(
    "vars_use,lamb,mstep_impl",
    [
        (["dataset"], 1.0, "kernel"),
        (["dataset"], None, "kernel"),
        (["dataset"], 1.0, "torch"),
        (["dataset", "cell_type"], 1.0, "kernel"),
    ],
)
def test_whole_run_matches_jax_engine(vars_use, lamb, mstep_impl):
    Z, meta = make_synthetic(None, n_cells=240, d=8, seed=7)
    _assert_same_run(*_run_both(
        Z, meta, vars_use, lamb, mstep_impl, harmony_options(), nclust=6,
        max_iter=3, theta=[1.0] * len(vars_use),
    ))


@pytest.mark.parametrize("mstep_impl", ["kernel", "torch"])
def test_whole_run_with_a_batch_below_the_cutoff_matches_jax(mstep_impl):
    """A rare, isolated batch falls under batch_prop_cutoff in most clusters
    (test_parity.py's cutoff case): the kernel branch drops the cell mask,
    which is exact for one covariate (ops/ridge.py)."""
    rng = np.random.default_rng(3)
    Z = rng.normal(size=(200, 6))
    Z[180:] += 8.0
    meta = {"dataset": np.array(["a"] * 90 + ["b"] * 90 + ["rare"] * 20)}
    _assert_same_run(*_run_both(
        Z, meta, ["dataset"], 1.0, mstep_impl,
        harmony_options(batch_prop_cutoff=5e-2), nclust=5, max_iter=2,
        theta=None,
    ))


def test_state_arrays_round_trip():
    """state_to_arrays(state_from_arrays(a)) gives back every JAX field."""
    Z, meta = make_synthetic(None, n_cells=60, d=5, seed=2)
    design = build_design(meta, ["dataset"])
    Zt = orient_embedding(Z, 60)
    cfg = resolve_config(
        n_cells=60, d=5, design=design, nclust=3, max_iter=2, early_stop=True,
        options=harmony_options(), verbose=False,
    )
    hp = expand_hyperparams(design, cfg.K, None, 0.1, 1.0, 0)
    js = jax_init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb,
                        jax.random.PRNGKey(5))
    a = _jax_state_arrays(js)
    pcfg, _ = _port_cfg(Zt, meta, ["dataset"], 3, 1.0, 2, harmony_options(), "kernel")
    back = state_to_arrays(state_from_arrays(pcfg, a, "cpu"))
    assert set(back) == set(a)
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)


@pytest.mark.parametrize("name", _NAMES)
def test_port_reproduces_vendored_golden(name):
    """Replay each fixture under the bounds of test_parity_fixtures.py:
    objective rtol 1e-5 and Z_corr atol 1e-5 against the engine golden;
    Z_corr atol 1e-4 and objective_harmony rtol 1e-5 against the fp64
    oracle."""
    z = np.load(os.path.join(_FIXDIR, f"{name}.npz"), allow_pickle=False)
    codes = z["codes"]
    ncov, N = codes.shape
    design = tpre.DesignMatrix(
        codes=codes.astype(np.int32),
        levels=[np.arange(len(np.unique(codes[c]))) for c in range(ncov)],
        names=[str(v) for v in z["vars_use"]],
    )
    options = harmony_options(max_iter_cluster=int(z["max_iter_cluster"]))
    cfg = finalize_engine_config(tpre.resolve_config(
        n_cells=N, d=z["Z"].shape[0], design=design, nclust=int(z["nclust"]),
        max_iter=int(z["max_iter"]), early_stop=True, options=options,
        verbose=False,
    ))
    state = init_state(cfg, z["Z"], design, z["sigma"], z["theta"], z["lamb"],
                       0, "cpu")
    state = tengine.init_cluster_from(cfg, state, z["Y0"])
    state = tdriver.harmonize(cfg, state, max_iter=int(z["max_iter"]),
                              perms=z["perms"])
    tr = state.trace_lists(cfg)
    Zc = state.Z_corr.numpy()
    np.testing.assert_allclose(
        tr["objective_kmeans"], z["engine_objective_kmeans"], rtol=1e-5
    )
    np.testing.assert_allclose(Zc, z["engine_Z_corr"], atol=1e-5)
    np.testing.assert_allclose(Zc, z["oracle_Z_corr"], atol=1e-4)
    np.testing.assert_allclose(
        tr["objective_harmony"], z["oracle_objective_harmony"], rtol=1e-5
    )
