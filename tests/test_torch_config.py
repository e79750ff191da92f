"""harmony_tpu_torch config and preprocessing against harmony_tpu.

Both packages get the same numpy inputs; designs, hyperparameters, resolved
configs, block geometry and every configuration error message must agree
exactly.
"""

import numpy as np
import pytest

from harmony_tpu import config as jconfig
from harmony_tpu import preprocess as jpre
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import preprocess as tpre

from conftest import make_synthetic

_FIELDS = (
    "N", "d", "K", "B", "B_vec", "max_iter_harmony", "max_iter_cluster",
    "epsilon_cluster", "epsilon_harmony", "window_size", "alpha",
    "batch_prop_cutoff", "lambda_estimation", "block_size", "dtype",
    "ridge_solver", "shuffle_mode",
)
_GEOMETRY = (
    "effective_block_size", "n_blocks", "cells_per_block", "last_block_size",
    "max_block_size", "covariate_offsets", "n_covariates", "norm_const",
    "kmeans_trace_capacity", "harmony_trace_capacity",
)


@pytest.mark.parametrize(
    "n_cells,vars_use,block_size,nclust",
    [
        (300, ["dataset"], 0.05, None),
        (300, ["dataset", "cell_type"], 0.3, 7),
        (25, ["dataset"], 0.05, None),  # N < 40 forces block_size 0.2
        (1003, ["dataset", "cell_type"], 0.07, 9),  # ragged last block
        (100, ["dataset"], 0.3, 4),  # last block smaller: 30/30/30/10
    ],
)
def test_design_config_and_geometry_match(n_cells, vars_use, block_size, nclust):
    Z, meta = make_synthetic(None, n_cells=n_cells, d=6, seed=3)
    jd, td = jpre.build_design(meta, vars_use), tpre.build_design(meta, vars_use)
    np.testing.assert_array_equal(td.codes, jd.codes)
    np.testing.assert_array_equal(td.global_codes, jd.global_codes)
    np.testing.assert_array_equal(td.batch_sizes(), jd.batch_sizes())
    assert td.B_vec == jd.B_vec and td.offsets == jd.offsets
    assert td.names == jd.names
    for a, b in zip(td.levels, jd.levels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tpre.orient_embedding(Z, n_cells), jpre.orient_embedding(Z, n_cells)
    )
    opts_j = jconfig.harmony_options(block_size=block_size)
    opts_t = tconfig.harmony_options(block_size=block_size)
    for lamb in (None, 1.0):
        jc = jpre.resolve_config(
            n_cells=n_cells, d=6, design=jd, nclust=nclust, max_iter=4,
            early_stop=lamb is None, options=opts_j, verbose=False,
            lambda_estimation=lamb is None,
        )
        tc = tpre.resolve_config(
            n_cells=n_cells, d=6, design=td, nclust=nclust, max_iter=4,
            early_stop=lamb is None, options=opts_t, verbose=False,
            lambda_estimation=lamb is None,
        )
        for f in _FIELDS + _GEOMETRY:
            assert getattr(tc, f) == getattr(jc, f), f


@pytest.mark.parametrize("tau", [0.0, 5.0])
@pytest.mark.parametrize("lamb", [None, 1.0, "per_covariate"])
def test_expand_hyperparams_match(tau, lamb):
    _, meta = make_synthetic(None, n_cells=200, d=4, seed=8)
    vars_use = ["dataset", "cell_type"]
    jd, td = jpre.build_design(meta, vars_use), tpre.build_design(meta, vars_use)
    lam = [0.5, 2.0] if lamb == "per_covariate" else lamb
    jh = jpre.expand_hyperparams(jd, 6, [1.0, 3.0], 0.2, lam, tau)
    th = tpre.expand_hyperparams(td, 6, [1.0, 3.0], 0.2, lam, tau)
    np.testing.assert_array_equal(th.sigma, jh.sigma)
    np.testing.assert_array_equal(th.theta, jh.theta)
    np.testing.assert_array_equal(th.lamb, jh.lamb)
    assert th.lambda_estimation == jh.lambda_estimation


@pytest.mark.parametrize("n", [0, 15, 29, 30, 45, 75, 2999, 3000, 3015, 500000])
def test_default_nclust_matches(n):
    assert tconfig.default_nclust(n) == jconfig.default_nclust(n)


def _meta():
    _, meta = make_synthetic(None, n_cells=50, d=4, seed=1)
    return meta


def _legacy(mod, **kw):
    mod.check_legacy_args(**kw)


_ERROR_CASES = {
    "legacy_max_iter_harmony": lambda c, p: _legacy(c, max_iter_harmony=3),
    "legacy_do_pca": lambda c, p: _legacy(c, do_pca=True),
    "legacy_tau": lambda c, p: _legacy(c, tau=1.0),
    "legacy_block_dot_size": lambda c, p: _legacy(c, **{"block.size": 0.1}),
    "unknown_arg": lambda c, p: _legacy(c, foo=1, bar=2),
    "bad_covariate": lambda c, p: p.build_design(_meta(), ["nope"]),
    "no_vars_use": lambda c, p: p.build_design(_meta(), None),
    "bad_metadata": lambda c, p: p.build_design(np.zeros((3, 3)), None),
    "ragged_metadata": lambda c, p: p.build_design(
        {"a": np.arange(5), "b": np.arange(6)}, ["a"]),
    "lambda_length": lambda c, p: p.expand_hyperparams(
        p.build_design(_meta(), ["dataset", "cell_type"]), 4, None, 0.1,
        [1.0, 2.0, 3.0], 0.0),
    "lambda_negative": lambda c, p: p.expand_hyperparams(
        p.build_design(_meta(), ["dataset"]), 4, None, 0.1, -1.0, 0.0),
    "theta_length": lambda c, p: p.expand_hyperparams(
        p.build_design(_meta(), ["dataset", "cell_type"]), 4, 1.0, 0.1, 1.0,
        0.0),
    "sigma_length": lambda c, p: p.expand_hyperparams(
        p.build_design(_meta(), ["dataset"]), 4, None, [0.1, 0.2], 1.0, 0.0),
    "orientation": lambda c, p: p.orient_embedding(np.zeros((7, 9)), 50),
    "too_few_cells": lambda c, p: c.HarmonyConfig(N=5, d=2, K=2, B=1, B_vec=(1,)),
    "block_size": lambda c, p: c.harmony_options(block_size=0.0),
}


@pytest.mark.parametrize("case", sorted(_ERROR_CASES))
def test_config_error_messages_match(case):
    fn = _ERROR_CASES[case]
    with pytest.raises(jconfig.HarmonyConfigError) as je:
        fn(jconfig, jpre)
    with pytest.raises(tconfig.HarmonyConfigError) as te:
        fn(tconfig, tpre)
    assert str(te.value) == str(je.value)


def test_finalize_resolves_impls_and_refuses_unported():
    base = tconfig.HarmonyConfig(N=100, d=4, K=3, B=2, B_vec=(2,))
    cfg = tconfig.finalize_engine_config(base)
    assert (cfg.estep_impl, cfg.mstep_impl, cfg.virtual_r) == ("kernel", "kernel", False)
    import dataclasses

    f64 = tconfig.finalize_engine_config(dataclasses.replace(base, dtype="float64"))
    assert (f64.estep_impl, f64.mstep_impl) == ("torch", "torch")
    # below n_blocks * 128 cells rotate takes the cell-granular round, untiled
    small = tconfig.finalize_engine_config(dataclasses.replace(base, shuffle_mode="rotate"))
    assert (small.rotate_route, small.Np, small.estep_sub_tile) == ("cell", 100, 4096)
    # the bf16 and float16 engines resolve: the kernels, virtual R, the
    # bf16 precision permission, as the JAX package resolves them
    bf = tconfig.finalize_engine_config(dataclasses.replace(base, dtype="bfloat16",
                                                            matmul_precision="auto"))
    assert (bf.estep_impl, bf.mstep_impl, bf.virtual_r, bf.matmul_precision) == (
        "kernel", "kernel", True, "bfloat16")
    f16 = tconfig.finalize_engine_config(dataclasses.replace(base, dtype="float16",
                                                             matmul_precision="auto"))
    assert (f16.estep_impl, f16.mstep_impl, f16.virtual_r, f16.matmul_precision) == (
        "kernel", "kernel", True, "bfloat16")
    assert f16.bf16_products and bf.bf16_products and not cfg.bf16_products
    with pytest.raises(tconfig.HarmonyConfigError):
        tconfig.finalize_engine_config(dataclasses.replace(base, estep_impl="pallas"))
