"""The bf16 engine of harmony_tpu_torch against the JAX package's, end to end.

Both packages run ``dtype='bfloat16'`` with ``matmul_precision`` left to
resolve ('bfloat16', a permission to use bf16 passes; on the CPU both
compute the products in fp32). The same centroids and the same randomness
(permutations, or rotations and block orders drawn from the JAX state key)
go to both; the JAX engine runs jitted, its Pallas kernels in interpret
mode, as its own tests run it (tests/test_largeb.py:118-131).

* The slice: rotate, stats carry, virtual R, 8,704 cells, three Harmony
  rounds and the run-end R: objective trace rtol 5e-3, Z_corr relative
  Frobenius error <= 5e-3, R's column sums within 5e-3 of 1 (the JAX
  package's own bound, tests/test_largeb.py:131); the state and R are bf16.
* Every other route of a bf16 engine, at the same bounds: the per-round
  permute schedule (K1 on float32 copies), the fused permute phase, rotate
  with written R, the rounds without the stats carry (K12) and the
  cell-granular round.
* The state crossing: a JAX bf16 state (virtual R included) goes to the
  port and back bit-equal; a run resumed in the port from a crossed
  virtual-R state matches the JAX engine resumed from it.
* ``run_harmony(dtype='bfloat16')``: the route, bf16 storage, float32
  result arrays holding the bf16 values, ``W`` through the run's layout.
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
from harmony_tpu_torch.ops import rotate as tr

from test_torch_bf16 import _bf, _f64
from test_torch_rotate import _jax_schedule
from test_torch_rotate_v1 import _cell_schedule
from test_torch_virtual import _setup

BF16 = torch.bfloat16
OBJ_RTOL = Z_REL = COLSUM_ATOL = 5e-3


def _bf16(cj, ct, **over):
    return (dataclasses.replace(cj, dtype="bfloat16", **over),
            dataclasses.replace(ct, dtype="bfloat16", **over))


def _states(cj, ct, jd, td, Zt, hj, ht, Y0):
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    assert sj.Z_corr.dtype == jnp.bfloat16 and st.Z_corr.dtype == BF16
    return jengine.init_cluster_from(cj, sj, jnp.asarray(Y0)), tengine.init_cluster_from(ct, st,
                                                                                        Y0)


def _compare(sj, st, cj, ct, R_t=None):
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=OBJ_RTOL)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=OBJ_RTOL)
    assert st.Z_corr.dtype == st.R.dtype == BF16
    zj, zt = _f64(sj.Z_corr), _f64(st.Z_corr)
    assert np.linalg.norm(zt - zj) / np.linalg.norm(zj) <= Z_REL
    R = _f64(st.R if R_t is None else R_t)
    np.testing.assert_allclose(R[:, : ct.N].sum(0), 1.0, atol=COLSUM_ATOL)
    # (the JAX package's own R is not held to it: its XLA rounds in bf16,
    # the per-round permute schedule here, leave column sums 8.2e-3 from 1)


def _rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t, schedule=_jax_schedule, rounds=3):
    round_j = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled_j))
    for _ in range(rounds):
        _, sub = jax.random.split(sj.key)
        sched = tr.schedule_table(
            [schedule(ct, k) for k in jax.random.split(sub, cj.max_iter_cluster)])
        sj = round_j(sj)
        st = tengine.harmony_round(ct, st, schedules=sched,
                                   layout=tengine.MStepLayout(tiled_t))
    return sj, st


def _layouts(cj, ct, sj, st):
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    assert tiled_j is not None and tiled_t is not None and tiled_t.n_pure == tiled_j.n_pure
    return tiled_j, tiled_t


def test_virtual_slice_matches_jax_bf16_engine():
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((3,), 8704, 8704)
    cj, ct = _bf16(cj, ct)
    sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j, tiled_t = _layouts(cj, ct, sj, st)
    sj, st = _rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t)
    assert sj.virt_pen is not None and st.virt_pen is not None
    assert st.virt_Y.dtype == BF16 and st.virt_Zn.dtype == torch.float32
    mt = tengine.materialize_r(ct, st)
    assert mt.R.dtype == BF16
    _compare(sj, st, cj, ct, mt.R)
    assert (_f64(mt.R)[:, ct.N:] == 0).all()


def _permute_setup(N=4096, d=8, B=3, K=8, tiled=False):
    rng = np.random.default_rng(7)
    batches = rng.integers(0, B, N)
    Z = ((rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(N, d))).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=True, dtype="bfloat16")
    cj = jpre.resolve_config(design=jd, options=jconfig.harmony_options(), **kw)
    ct = tpre.resolve_config(design=td, options=tconfig.harmony_options(), **kw)
    Zt = jpre.orient_embedding(Z, N)
    if tiled:
        perm, _ = jtiled.build_batch_tiled_order(jd.codes, 128, seed=0)
        Zt = Zt[:, perm]
        jd = dataclasses.replace(jd, codes=jd.codes[:, perm])
        td = dataclasses.replace(td, codes=td.codes[:, perm])
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, None, 0.0)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, None, 0.0)
    Y0 = Zt[:, rng.choice(N, cj.K, replace=False)]
    perms = np.stack([np.stack([rng.permutation(N) for _ in range(cj.max_iter_cluster)])
                      for _ in range(3)]).astype(np.int32)
    return cj, ct, jd, td, Zt, hj, ht, Y0, perms


def _permute_route(fused):
    cj, ct, jd, td, Zt, hj, ht, Y0, perms = _permute_setup(tiled=fused)
    if fused:
        cj = dataclasses.replace(cj, estep_impl="pallas", estep_sub_tile=256, mstep_mode="tiled")
        ct = tconfig.finalize_engine_config(dataclasses.replace(
            ct, mstep_tile=128, permute_fused=True))
    else:
        cj = dataclasses.replace(cj, estep_impl="xla")
        ct = tconfig.finalize_engine_config(ct)
        assert not ct.permute_fused and ct.estep_impl == "kernel"
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
        cj, ct = _bf16(cj, ct)
        assert ct.rotate_route == "cell"
        sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
        return (*_rotate_rounds(cj, ct, sj, st, None, None, _cell_schedule), cj, ct)
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((3,), 4096, 4096)
    over = ({"virtual_r": False} if route == "written"
            else {"virtual_r": False, "rotate_stats_carry": False})
    cj, ct = _bf16(cj, ct, **over)
    assert ct.rotate_route == ("carry" if route == "written" else "two_phase")
    sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j, tiled_t = _layouts(cj, ct, sj, st)
    return (*_rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t), cj, ct)


@pytest.mark.parametrize("route", ["permute", "permute_fused", "rotate_written",
                                   "rotate_two_phase", "rotate_cell"])
def test_every_other_route_matches_jax_bf16_engine(route):
    if route.startswith("permute"):
        sj, st, cj, ct = _permute_route(route == "permute_fused")
    else:
        sj, st, cj, ct = _rotate_route(route.removeprefix("rotate_"))
    assert st.virt_pen is None
    _compare(sj, st, cj, ct)


def _jax_fields(sj):
    return {f: np.asarray(getattr(sj, f)) for f in tstate.ARRAY_FIELDS + tstate.VIRTUAL_FIELDS
            if getattr(sj, f, None) is not None}


def test_bf16_state_crosses_between_packages_and_resumes():
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((2, 3), 4000, 4096)
    cj, ct = _bf16(cj, ct)
    sj, _ = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    sj = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled_j))(sj)
    assert sj.virt_pen is not None and sj.virt_Y.dtype == jnp.bfloat16
    arrays = _jax_fields(sj)
    st = tstate.state_from_arrays(ct, arrays, "cpu")
    assert st.Z_corr.dtype == st.R.dtype == st.virt_Y.dtype == BF16
    for f, a in arrays.items():
        if a.dtype == jnp.bfloat16:
            assert torch.equal(getattr(st, f), _bf(a)), f
    # out of the port: float32 arrays holding the bf16 values, which a JAX
    # state takes back bit for bit
    back = tstate.state_to_arrays(st)
    assert set(back) == set(arrays)
    for f, a in arrays.items():
        b = back[f]
        if a.dtype == jnp.bfloat16:
            assert b.dtype == np.float32
            b = np.asarray(jnp.asarray(b).astype(jnp.bfloat16))
        np.testing.assert_array_equal(np.atleast_1d(b).view(np.uint8),
                                      np.atleast_1d(a).view(np.uint8), err_msg=f)
    # and through the port's own arrays again
    again = tstate.state_to_arrays(tstate.state_from_arrays(ct, back, "cpu"))
    for f in back:
        np.testing.assert_array_equal(again[f], back[f], err_msg=f)
    # resumed: two more rounds from the crossed state in each package
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    sj, st = _rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t, rounds=2)
    _compare(sj, st, cj, ct, tengine.materialize_r(ct, st).R)


def test_run_harmony_bf16_on_cpu():
    rng = np.random.default_rng(2)
    N, d = 120_000, 4
    b = rng.integers(0, 3, N)
    Z = (rng.normal(size=(3, d)) * 0.8)[b] + rng.normal(size=(N, d))
    res = run_harmony(Z, {"dataset": b.astype(str)}, ["dataset"], nclust=8, max_iter=2,
                      device="cpu", dtype="bfloat16", return_object=True)
    cfg = res.config
    assert (cfg.shuffle_mode, cfg.rotate_route, cfg.matmul_precision) == (
        "rotate", "carry", "bfloat16")
    assert cfg.virtual_r and res.state.virt_pen is not None
    assert res.state.Z_orig.dtype == res.state.R.dtype == res.state.Y.dtype == BF16
    for X in (res.Z_corr, res.R, res.Y, res.O, res.E, res.sigma):
        assert X.dtype == np.float32
    # float32 arrays holding bf16 values
    assert np.array_equal(res.Z_corr, torch.as_tensor(res.Z_corr).to(BF16).float().numpy())
    assert res.embeddings.shape == (N, d) and np.isfinite(res.embeddings).all()
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=COLSUM_ATOL)
    W = res.W
    assert W.shape == (cfg.K, cfg.B + 1, d) and W.dtype == np.float32 and np.isfinite(W).all()
