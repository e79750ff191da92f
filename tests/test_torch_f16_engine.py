"""The float16 engine of harmony_tpu_torch against the JAX package's, end to end.

Both packages run ``dtype='float16'`` with ``matmul_precision`` left to
resolve ('bfloat16'): the port takes the bf16 product form in K6, K10 and
K11 (``HarmonyConfig.bf16_products``), the JAX package computes its
products in fp32 on the CPU. The same centroids and the same randomness
(permutations, or rotations and block orders drawn from the JAX state key)
go to both; the JAX engine runs jitted, its Pallas kernels in interpret
mode, as its own tests run it (tests/test_largeb.py:118-131).

* The slice: rotate, stats carry, virtual R, 8,704 cells, three Harmony
  rounds and the run-end R: objective trace rtol 5e-3, Z_corr relative
  Frobenius error <= 5e-3, R's column sums within 5e-3 of 1 (the bounds of
  test_torch_bf16_engine.py); the state and R are float16.
* Every other route of a float16 engine, at the same bounds: the per-round
  permute schedule (K1 on float32 copies) against the JAX package's K1
  (``pallas_block_update_round``, ``max_iter_cluster=6``), the fused
  permute phase, rotate with written R, the rounds without the stats carry
  (K12), and the cell-granular round against the JAX package's float32
  engine. The JAX package's XLA rounds in float16 (the per-round permute
  on 'xla', the cell-granular round) take exp(-d / sigma) in float16,
  which is subnormal or zero for most clusters of a cell at sigma = 0.1:
  they land 3.6-3.7% (Z_corr relative) from the float32 engine, where the
  port (its rounds on float32 copies, as the JAX package's kernels run
  them) lands 3.5e-4; the cell-granular case checks that it stays closer.
* The state crossing: a JAX float16 state (virtual R included) goes to the
  port and back bit for bit (float16 is numpy's own dtype); a run resumed
  in the port from it matches the JAX engine resumed from it.
* ``run_harmony(dtype='float16')``: the route, float16 storage and result
  arrays.
* The float16 norm and the initial softmax bit-equal to ``jnp.linalg.norm``
  and ``jax.nn.softmax`` on float16 arrays.
* The batch-size guard: a float16 engine refuses a batch of more than
  65,504 cells, where the JAX package rounds that batch's size, from 65,520
  cells to inf, and runs on.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from harmony_tpu import config as jconfig
from harmony_tpu import engine as jengine
from harmony_tpu import preprocess as jpre
from harmony_tpu import state as jstate
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import run_harmony
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.ops.assign import initial_assignments
from harmony_tpu_torch.ops.normalize import l2_normalize_columns

from test_torch_bf16 import _f64
from test_torch_bf16_engine import _layouts, _permute_setup, _rotate_rounds
from test_torch_rotate_v1 import _cell_schedule
from test_torch_virtual import _setup

F16 = torch.float16
OBJ_RTOL = Z_REL = COLSUM_ATOL = 5e-3


def _f16(cj, ct, **over):
    return (dataclasses.replace(cj, dtype="float16", **over),
            dataclasses.replace(ct, dtype="float16", **over))


def _states(cj, ct, jd, td, Zt, hj, ht, Y0):
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    assert sj.Z_corr.dtype == jnp.float16 and st.Z_corr.dtype == F16
    # the state the port builds is the JAX package's, bit for bit
    for f in ("Z_orig", "Z_corr", "Pr_b", "batch_sizes", "sigma", "theta", "lamb"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)
    return (jengine.init_cluster_from(cj, sj, jnp.asarray(Y0)),
            tengine.init_cluster_from(ct, st, Y0))


def _compare(sj, st, cj, ct, R_t=None):
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=OBJ_RTOL)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=OBJ_RTOL)
    assert st.Z_corr.dtype == st.R.dtype == F16
    zj, zt = _f64(sj.Z_corr), _f64(st.Z_corr)
    assert np.linalg.norm(zt - zj) / np.linalg.norm(zj) <= Z_REL
    R = _f64(st.R if R_t is None else R_t)
    np.testing.assert_allclose(R[:, : ct.N].sum(0), 1.0, atol=COLSUM_ATOL)


def test_virtual_slice_matches_jax_f16_engine():
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((3,), 8704, 8704)
    cj, ct = _f16(cj, ct)
    assert ct.bf16_products
    sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j, tiled_t = _layouts(cj, ct, sj, st)
    sj, st = _rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t)
    assert sj.virt_pen is not None and st.virt_pen is not None
    assert st.virt_Y.dtype == F16 and st.virt_Zn.dtype == torch.float32
    mt = tengine.materialize_r(ct, st)
    assert mt.R.dtype == F16
    _compare(sj, st, cj, ct, mt.R)
    assert (_f64(mt.R)[:, ct.N:] == 0).all()


def _permute_route(fused):
    cj, ct, jd, td, Zt, hj, ht, Y0, perms = _permute_setup(tiled=fused)
    cj, ct = _f16(cj, ct)
    if fused:
        cj = dataclasses.replace(cj, estep_impl="pallas", estep_sub_tile=256, mstep_mode="tiled")
        ct = tconfig.finalize_engine_config(dataclasses.replace(
            ct, mstep_tile=128, permute_fused=True))
    else:
        # past the static budget the JAX package runs its K1 round by round
        # (pallas_block_update_round), the kernel the port's K1 ports
        cj = dataclasses.replace(cj, estep_impl="pallas", max_iter_cluster=6)
        ct = tconfig.finalize_engine_config(dataclasses.replace(ct, max_iter_cluster=6))
        assert not ct.permute_fused and ct.estep_impl == "kernel"
        rng = np.random.default_rng(11)
        perms = np.stack([np.stack([rng.permutation(cj.N) for _ in range(6)])
                          for _ in range(3)]).astype(np.int32)
    sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j = tiled_t = None
    if fused:
        tiled_j, tiled_t = _layouts(cj, ct, sj, st)
    for it in range(3):
        if fused:
            sj, M = jengine.cluster(cj, sj, jnp.asarray(perms[it]), tiled=tiled_j,
                                    return_moments=True)
            sj = jengine.correct(cj, sj, tiled=tiled_j, tiled_moments=M)
        else:
            sj = jengine.correct(cj, jengine.cluster(cj, sj, jnp.asarray(perms[it])))
        st = tengine.correct(ct, tengine.cluster(ct, st, perms[it], tiled=tiled_t),
                             tengine.MStepLayout(tiled_t) if fused else
                             tengine.mstep_layout(ct, st.codes.numpy()))
    return sj, st, cj, ct


def _rotate_route(route):
    if route == "cell":
        from test_torch_rotate_v1 import _cell_setup

        cj, ct, jd, td, Zt, hj, ht, Y0 = _cell_setup(1500, 4)
        # the JAX package's float32 engine and its float16 one (XLA only on
        # this route), the port's float16 engine
        ct = dataclasses.replace(ct, dtype="float16")
        assert ct.rotate_route == "cell"
        out = {}
        for dt in ("float16", "float32"):
            c = dataclasses.replace(cj, dtype=dt)
            s = jengine.init_cluster_from(c, jstate.init_state(
                c, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3)), jnp.asarray(Y0))
            st = tengine.init_cluster_from(ct, tstate.init_state(
                ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu"), Y0)
            out[dt] = (c, *_rotate_rounds(c, ct, s, st, None, None, _cell_schedule))
        c32, sj, st = out["float32"]
        z32, zt, z16 = _f64(sj.Z_corr), _f64(st.Z_corr), _f64(out["float16"][1].Z_corr)
        assert np.linalg.norm(zt - z32) < np.linalg.norm(z16 - z32)
        return sj, st, c32, ct
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((3,), 4096, 4096)
    over = ({"virtual_r": False} if route == "written"
            else {"virtual_r": False, "rotate_stats_carry": False})
    cj, ct = _f16(cj, ct, **over)
    assert ct.rotate_route == ("carry" if route == "written" else "two_phase")
    sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j, tiled_t = _layouts(cj, ct, sj, st)
    return (*_rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t), cj, ct)


@pytest.mark.parametrize("route", ["permute", "permute_fused", "rotate_written",
                                   "rotate_two_phase", "rotate_cell"])
def test_every_other_route_matches_jax_f16_engine(route):
    if route.startswith("permute"):
        sj, st, cj, ct = _permute_route(route == "permute_fused")
    else:
        sj, st, cj, ct = _rotate_route(route.removeprefix("rotate_"))
    assert st.virt_pen is None
    _compare(sj, st, cj, ct)


def _jax_fields(sj):
    return {f: np.asarray(getattr(sj, f)) for f in tstate.ARRAY_FIELDS + tstate.VIRTUAL_FIELDS
            if getattr(sj, f, None) is not None}


def test_f16_state_crosses_between_packages_and_resumes():
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((2, 3), 4000, 4096)
    cj, ct = _f16(cj, ct)
    sj, _ = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    sj = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled_j))(sj)
    assert sj.virt_pen is not None and sj.virt_Y.dtype == jnp.float16
    arrays = _jax_fields(sj)
    st = tstate.state_from_arrays(ct, arrays, "cpu")
    assert st.Z_corr.dtype == st.R.dtype == st.virt_Y.dtype == F16
    # out of the port and back: float16 arrays, bit for bit
    back = tstate.state_to_arrays(st)
    assert set(back) == set(arrays)
    for f, a in arrays.items():
        b = np.atleast_1d(back[f])
        assert b.dtype == np.atleast_1d(a).dtype, f
        np.testing.assert_array_equal(b.view(np.uint8), np.atleast_1d(a).view(np.uint8),
                                      err_msg=f)
    # resumed: two more rounds from the crossed state in each package
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    sj, st = _rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t, rounds=2)
    _compare(sj, st, cj, ct, tengine.materialize_r(ct, st).R)


def test_run_harmony_f16_on_cpu():
    rng = np.random.default_rng(2)
    N, d = 120_000, 4
    b = rng.integers(0, 3, N)
    Z = (rng.normal(size=(3, d)) * 0.8)[b] + rng.normal(size=(N, d))
    res = run_harmony(Z, {"dataset": b.astype(str)}, ["dataset"], nclust=8, max_iter=2,
                      device="cpu", dtype="float16", return_object=True)
    cfg = res.config
    assert (cfg.shuffle_mode, cfg.rotate_route, cfg.matmul_precision) == (
        "rotate", "carry", "bfloat16")
    assert cfg.virtual_r and cfg.bf16_products and res.state.virt_pen is not None
    assert res.state.Z_orig.dtype == res.state.R.dtype == res.state.Y.dtype == F16
    for X in (res.Z_corr, res.R, res.Y, res.O, res.E, res.sigma):
        assert X.dtype == np.float16
    assert res.embeddings.shape == (N, d) and np.isfinite(res.embeddings).all()
    np.testing.assert_allclose(res.R.astype(np.float64).sum(0), 1.0, atol=COLSUM_ATOL)
    W = res.W
    assert W.shape == (cfg.K, cfg.B + 1, d) and np.isfinite(W).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_f16_norm_and_softmax_bit_equal_jax(seed):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(50, 4000)) * 3).astype(np.float32)
    X[:, 7] = 0.0  # a zero column stays zero
    Xj = jnp.asarray(X).astype(jnp.float16)
    nj = jnp.linalg.norm(Xj, axis=0, keepdims=True)
    ref = np.asarray(Xj / jnp.where(nj == 0, 1.0, nj))
    got = l2_normalize_columns(torch.from_numpy(X).to(F16))
    assert got.dtype == F16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), ref.view(np.uint16))
    D = rng.uniform(0, 4, size=(20, 3000)).astype(np.float16)
    s = np.full(20, 0.1, np.float16)
    ref = np.asarray(jax.nn.softmax(-jnp.asarray(D) / jnp.asarray(s)[:, None], axis=0))
    got = initial_assignments(torch.from_numpy(D), torch.from_numpy(s))
    assert got.dtype == F16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), ref.view(np.uint16))


@pytest.mark.parametrize("dtype,cells,raises", [
    ("float16", 65_504, False), ("float16", 65_505, True), ("float16", 65_520, True),
    ("bfloat16", 65_520, False), ("float32", 65_520, False)])
def test_f16_batch_guard(dtype, cells, raises):
    """A float16 engine stores each batch's size (and O and E, at most it)
    in float16, whose largest value is 65,504: from 65,520 cells the JAX
    package's stored size is inf (avg_R = O / inf = 0, the batch masked
    out, never corrected), below that it is rounded; the port raises past
    65,504 where the batch sizes are known, in resolve_config and
    init_state."""
    codes = np.concatenate([np.zeros(cells, np.int32), np.ones(10, np.int32)])
    design = tpre.build_design({"b": codes}, ["b"])
    assert tuple(design.batch_sizes()) == (cells, 10)
    kw = dict(n_cells=cells + 10, d=4, nclust=8, max_iter=1, early_stop=False,
              options=tconfig.harmony_options(), verbose=False, dtype=dtype)
    if raises:
        with pytest.raises(tconfig.HarmonyConfigError, match="65504"):
            tpre.resolve_config(design=design, **kw)
        cfg = tpre.resolve_config(design=design, **{**kw, "dtype": "float32"})
        with pytest.raises(tconfig.HarmonyConfigError, match=rf"\[0\] hold \[{cells}\]"):
            tstate.init_state(dataclasses.replace(cfg, dtype="float16"),
                              np.zeros((4, cells + 10)), design, np.full(8, 0.1),
                              np.full(2, 2.0), np.zeros(3), 0, "cpu")
        if cells >= 65_520:
            # the JAX package's float16 state holds inf where the port refuses
            jd = jpre.build_design({"b": codes}, ["b"])
            assert np.isinf(np.asarray(jnp.asarray(jd.batch_sizes(), jnp.float16))[0])
    else:
        cfg = tpre.resolve_config(design=design, **kw)
        assert cfg.dtype == dtype
        tconfig.check_float16_batches(dtype, design.batch_sizes())
