"""The rotate rounds that read and write R, harmony_tpu_torch against
harmony_tpu.

* K12's step walk (``ops.rotate.v1_steps``) equals the rows of JAX's
  ``_schedule`` table.
* The K12 twin (``ops.rotate.rotate_update_round_v1``, through the wrapper
  ``cuda_estep.rotate_update_round_v1`` on CPU tensors) against
  ``pallas_rotate_update_round`` in interpret mode, with the rotation and
  block order its key draws; one and two covariates, pad cells, two
  chained rounds: R atol 1e-6; E, O, k-means error and entropy rtol 1e-5.
* The cell-granular round (``ops.estep.rotate_update_round``), fed the row
  of the schedule table that the JAX key draws, against
  ``harmony_tpu.ops.rotate_update_round`` at the shape of
  ``tests/test_rotate.py``'s emulation (203 cells, N_pad 208, two
  covariates): the layout equal; R atol 2e-6; E, O atol 1e-4; the
  accumulators rtol 1e-5.
* Three Harmony rounds of each route against the JAX engine with the same
  centroids and schedules, lambda estimated: K12 (JAX ``estep_impl=
  'pallas'``, ``rotate_stats_carry=False``) on ``test_torch_rotate``'s
  slice problem with its batch-tiled M-step; the cell-granular round (JAX
  ``estep_impl='xla'``) at 1,500 cells with the dense M-step; each also
  with ``max_iter_cluster=7``, where the early stop can fire. Objective
  rtol 1e-5, Z_corr and R atol 1e-4.
* ``run_harmony(..., shuffle_mode='rotate')`` at 2,000 cells and
  ``driver.run`` with ``rotate_stats_carry=False`` at 20k cells run end to
  end on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_synthetic
from harmony_tpu import config as jconfig
from harmony_tpu import engine as jengine
from harmony_tpu import ops as jops
from harmony_tpu import preprocess as jpre
from harmony_tpu import state as jstate
from harmony_tpu.ops import pallas_rotate as jpr
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import driver as tdriver
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.ops import cuda_estep
from harmony_tpu_torch.ops import estep as te
from harmony_tpu_torch.ops import rotate as tr
from test_torch_rotate import CASES, _jax_schedule, _problem, _slice_setup


def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


def _close(a, b, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _cell_schedule(cfg_t, key):
    """(r, order) as the JAX cell-granular round draws them from its key."""
    k1, k2 = jax.random.split(key)
    return (int(jax.random.randint(k1, (), 0, cfg_t.Np)),
            [int(b) for b in jax.random.permutation(k2, cfg_t.n_blocks)])


@pytest.mark.parametrize("N,d,K,B_vec", [(500_000, 50, 100, (10,)), (20_000, 50, 100, (10,)),
                                         (3000, 8, 5, (3,)), (2559, 8, 5, (3,)),
                                         (60_000, 30, 50, (4, 5))])
def test_written_route_geometry_matches(N, d, K, B_vec):
    """The K12 route takes the JAX package's tile geometry; below n_blocks *
    128 cells the cell route takes none, as JAX's XLA path."""
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, shuffle_mode="rotate",
              rotate_stats_carry=False)
    cj = jconfig.finalize_engine_config(jconfig.HarmonyConfig(
        **kw, estep_impl="pallas" if N >= 2560 else "xla"))
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(**kw))
    assert (ct.estep_sub_tile, ct.Np) == (cj.estep_sub_tile, cj.Np)
    assert ct.rotate_route == ("two_phase" if N >= 2560 else "cell")


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_v1_steps_match_jax_schedule(N, Np, d, K, B_vec, T):
    cj, ct = _problem(N, Np, d, K, B_vec, T, seed=1)[:2]
    NT = tr.n_tiles(ct)
    for key in jax.random.split(jax.random.PRNGKey(N), 3):
        scal, n_steps = jpr._schedule(cj, NT, key)
        rt, order = _jax_schedule(ct, key)
        steps = tr.v1_steps(ct, rt, order)
        rows = np.asarray(scal)[[jpr._TILE, jpr._BLK, jpr._PHASE, jpr._FIRST, jpr._LAST]]
        assert steps.shape == (5, n_steps)
        np.testing.assert_array_equal(steps.numpy(), rows)


def _k12_inputs(N, Np, d, K, B_vec, T, seed):
    """Normalised Z (pads zero) and the R/E/O of the initial softmax, in
    both packages' types."""
    cj, ct, Z, Y, codes, Pr, sigma, theta = _problem(N, Np, d, K, B_vec, T, seed)
    Zn = np.zeros_like(Z)
    Zn[:, :N] = Z[:, :N] / np.linalg.norm(Z[:, :N], axis=0)
    R = np.zeros((K, Np), np.float32)
    R[:, :N] = np.asarray(jops.initial_assignments(
        jops.compute_distances(jnp.asarray(Y), jnp.asarray(Zn[:, :N])), jnp.asarray(sigma)))
    E = np.asarray(jops.compute_E(jnp.asarray(R), jnp.asarray(Pr)))
    O = np.asarray(jops.compute_O(jnp.asarray(R), jnp.asarray(codes), cj.covariate_offsets, cj.B))
    return cj, ct, Zn, Y, R, E, O, codes, Pr, sigma, theta


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k12_twin_matches_pallas_round(N, Np, d, K, B_vec, T):
    cj, ct, Zn, Y, R, E, O, codes, Pr, sigma, theta = _k12_inputs(
        N, Np, d, K, B_vec, T, seed=N + K + 1)
    lay_t = tr.CodesLayout(Z_pad=tr.pad_cells_to_tile(ct, _t(Zn)),
                           codes_pad=tr.make_codes_pad(ct, _t(codes)))
    jargs = [jnp.asarray(a) for a in (Zn, Y, R, E, O, codes, Pr, sigma, theta)]
    targs = [_t(a) for a in (Y, R, E, O, Pr, sigma, theta)]
    for key in jax.random.split(jax.random.PRNGKey(N + 1), 2):
        ref = jpr.pallas_rotate_update_round(cj, *jargs, key, interpret=True)
        rt, order = _jax_schedule(ct, key)
        before = cuda_estep.rotate_update_round_v1.launches
        out = cuda_estep.rotate_update_round_v1(ct, *targs, rt, order, lay_t)
        assert cuda_estep.rotate_update_round_v1.launches == before
        _close(out.R, ref.R, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out.R.numpy()[:, :N].sum(0), 1.0, atol=1e-5)
        assert (out.R.numpy()[:, N:] == 0).all()
        for name in ("E", "O", "kmeans_error", "entropy"):
            _close(getattr(out, name), getattr(ref, name))
        # chain: the next round starts from this round's R, E, O in each package
        jargs[2:5] = [ref.R, ref.E, ref.O]
        targs[1:4] = [out.R, out.E, out.O]


def test_k12_wrapper_rejects_mixed_devices():
    _, ct, Zn, Y, R, E, O, codes, Pr, sigma, theta = _k12_inputs(600, 640, 8, 5, (3,), 128, 2)
    lay = tr.CodesLayout(Z_pad=_t(Zn), codes_pad=tr.make_codes_pad(ct, _t(codes)))
    args = [_t(a) for a in (Y, R, E, O, Pr, sigma, theta)]
    args[5] = args[5].to("meta")
    with pytest.raises(ValueError, match="sigma is on meta"):
        cuda_estep.rotate_update_round_v1(ct, *args, 0, [0, 1, 2, 3, 4], lay)


def _cell_state():
    """tests/test_rotate.py's emulation problem after init, in JAX."""
    n, d = 203, 7
    Z, meta = make_synthetic(None, n_cells=n, d=d, seed=19)
    opts = jconfig.harmony_options()
    design = jpre.build_design(meta, ["dataset", "cell_type"])
    cj = jpre.resolve_config(n_cells=n, d=d, design=design, nclust=6, max_iter=2,
                             early_stop=True, options=opts, verbose=False)
    cj = dataclasses.replace(cj, N_pad=208, shuffle_mode="rotate")
    hp = jpre.expand_hyperparams(design, cj.K, None, 0.1, 1.0, opts.tau)
    sj = jstate.init_state(cj, jpre.orient_embedding(Z, n), design, hp.sigma, hp.theta,
                           hp.lamb, jax.random.PRNGKey(3))
    sj = jax.jit(lambda s: jengine.init_cluster(cj, s))(sj)
    ct = tconfig.HarmonyConfig(N=n, d=d, K=cj.K, B=cj.B, B_vec=cj.B_vec, N_pad=208,
                               shuffle_mode="rotate")
    assert ct.rotate_route == "cell" and ct.n_blocks == cj.n_blocks
    return cj, ct, sj


def test_cell_round_matches_jax():
    cj, ct, sj = _cell_state()
    names = ("Z_corr", "Y", "R", "E", "O", "codes", "Pr_b", "sigma", "theta")
    ja = [getattr(sj, f) for f in names]
    ta = [_t(a) for a in ja]
    lay_j = jops.make_rotate_layout(cj, sj.Z_corr, sj.codes)
    lay_t = te.make_rotate_layout(ct, ta[0], ta[5])
    for f in lay_j._fields:
        np.testing.assert_array_equal(getattr(lay_t, f).numpy(), np.asarray(getattr(lay_j, f)))
    for key in jax.random.split(jax.random.PRNGKey(42), 2):
        ref = jax.jit(lambda *a: jops.rotate_update_round(cj, *a, key))(*ja)
        # the table row of the rotation and block order the JAX key draws
        row = tr.schedule_table([_cell_schedule(ct, key)])[0]
        out = te.rotate_update_round(ct, *ta, row, lay_t)
        _close(out.R, ref.R, rtol=0, atol=2e-6)
        _close(out.E, ref.E, rtol=0, atol=1e-4)
        _close(out.O, ref.O, rtol=0, atol=1e-4)
        _close(out.kmeans_error, ref.kmeans_error)
        _close(out.entropy, ref.entropy)
        assert (out.R.numpy()[:, ct.N:] == 0).all()
        ja[2:5] = [ref.R, ref.E, ref.O]
        ta[2:5] = [out.R, out.E, out.O]


def test_cell_schedule_draws():
    """The cell route's schedule table: (rounds, 1 + n_blocks) int32 on the
    generator's device, a rotation in [0, Np) and a block order a row, drawn
    as one randint of the rotations, then one randperm a round (the stream
    the (rotation, block order) pairs came from), and the generator left
    where those calls leave it."""
    ct = tconfig.HarmonyConfig(N=1000, d=4, K=5, B=2, B_vec=(2,), shuffle_mode="rotate")
    g, h = torch.Generator(), torch.Generator()
    g.manual_seed(0)
    h.manual_seed(0)
    table = te.draw_rotate_schedules(ct, g, 3)
    assert table.dtype == torch.int32 and table.shape == (3, 1 + ct.n_blocks)
    assert table.device == g.device
    for r, order in tr.schedule_pairs(table):
        assert 0 <= r < 1000 and sorted(order) == list(range(20))
    rs = torch.randint(0, ct.Np, (3,), generator=h)
    orders = [torch.randperm(ct.n_blocks, generator=h) for _ in range(3)]
    assert tr.schedule_pairs(table) == [(int(r), o.tolist()) for r, o in zip(rs, orders)]
    assert torch.equal(g.get_state(), h.get_state())


def _cell_setup(N, mic):
    """A plain-order problem below n_blocks * 128 cells for both packages:
    the JAX XLA rotate round and dense M-step, the port's cell route."""
    rng = np.random.default_rng(11)
    d, B = 8, 3
    batches = rng.integers(0, B, N)
    Z = (rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(N, d))
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    opts_j = jconfig.harmony_options(max_iter_cluster=mic)
    opts_t = tconfig.harmony_options(max_iter_cluster=mic)
    kw = dict(n_cells=N, d=d, nclust=8, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=True, shuffle_mode="rotate")
    cj = dataclasses.replace(jpre.resolve_config(design=jd, options=opts_j, **kw),
                             estep_impl="xla")
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        tpre.resolve_config(design=td, options=opts_t, **kw), mstep_impl="torch"))
    assert ct.rotate_route == "cell" and ct.Np == N
    Zt = jpre.orient_embedding(Z, N)
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, None, opts_j.tau)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, None, opts_t.tau)
    Y0 = Zt[:, rng.choice(N, cj.K, replace=False)]
    return cj, ct, jd, td, Zt, hj, ht, Y0


@pytest.mark.parametrize("route,mic", [("two_phase", 4), ("two_phase", 7),
                                       ("cell", 4), ("cell", 7)])
def test_written_rounds_match_jax_engine(route, mic):
    if route == "two_phase":
        cj, ct, jd, td, Zt, hj, ht, Y0 = _slice_setup(4096, 4096, None, mic)
        cj = dataclasses.replace(cj, rotate_stats_carry=False)
        ct = dataclasses.replace(ct, rotate_stats_carry=False, estep_impl="kernel")
        schedule = _jax_schedule
    else:
        cj, ct, jd, td, Zt, hj, ht, Y0 = _cell_setup(1500, mic)
        schedule = _cell_schedule
    assert ct.rotate_route == route
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    tiled_j = tiled_t = None
    if route == "two_phase":
        tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
        tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
        assert tiled_j is not None and tiled_t is not None
    else:
        assert tengine.mstep_layout(ct, st.codes.numpy()).tiled is None
    cluster_j = jax.jit(lambda s: jengine.cluster(cj, s, tiled=tiled_j))
    correct_j = jax.jit(lambda s: jengine.correct(cj, s, tiled=tiled_j))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    before = cuda_estep.rotate_update_round_v1.launches
    for _ in range(3):
        # the schedules JAX's cluster draws from the state key
        _, sub = jax.random.split(sj.key)
        # every rotate route takes the schedule table: in tiles on the tile
        # route, in cells on the cell route
        sched = tr.schedule_table(
            [schedule(ct, k) for k in jax.random.split(sub, cj.max_iter_cluster)])
        sj = correct_j(cluster_j(sj))
        st = tengine.correct(ct, tengine.cluster(ct, st, schedules=sched),
                             tengine.MStepLayout(tiled_t))
    assert cuda_estep.rotate_update_round_v1.launches == before
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    if mic == 7:
        assert (tt["kmeans_rounds"] < 7).any()  # the early stop fired
    _close(tt["objective_kmeans"], tj["objective_kmeans"])
    _close(tt["objective_harmony"], tj["objective_harmony"])
    _close(st.Z_corr.numpy(), np.asarray(sj.Z_corr), rtol=0, atol=1e-4)
    _close(st.R.numpy(), np.asarray(sj.R), rtol=0, atol=1e-4)


def test_run_harmony_cell_route():
    from harmony_tpu_torch import run_harmony

    rng = np.random.default_rng(8)
    n, d = 2000, 6
    batches = rng.integers(0, 3, n)
    Z = (rng.normal(size=(3, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    res = run_harmony(Z, {"b": batches}, ["b"], nclust=8, max_iter=3, device="cpu",
                      shuffle_mode="rotate", return_object=True)
    assert res.config.rotate_route == "cell" and res.config.Np == n
    np.testing.assert_array_equal(res.ingest_inv,
                                  np.argsort(np.random.default_rng(0).permutation(n)))
    np.testing.assert_allclose(res.Z_orig, Z.T.astype(np.float32))
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
    assert np.isfinite(res.embeddings).all() and res.embeddings.shape == (n, d)


def test_driver_run_two_phase_route():
    rng = np.random.default_rng(9)
    n, d = 20_000, 4
    batches = rng.integers(0, 4, n)
    Z = (rng.normal(size=(4, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    design = tpre.build_design({"b": batches}, ["b"])
    cfg = tpre.resolve_config(n_cells=n, d=d, design=design, nclust=8, max_iter=2,
                              early_stop=True, options=tconfig.harmony_options(),
                              verbose=False, lambda_estimation=True, shuffle_mode="rotate")
    cfg = tconfig.finalize_engine_config(dataclasses.replace(
        cfg, rotate_stats_carry=False, estep_variant="legacy", virtual_r=True))
    assert cfg.rotate_route == "two_phase" and cfg.Np % cfg.estep_sub_tile == 0
    hp = tpre.expand_hyperparams(design, cfg.K, None, 0.1, None, 0.0)
    st = tstate.init_state(cfg, tpre.orient_embedding(Z, n), design, hp.sigma, hp.theta,
                           hp.lamb, 0, "cpu")
    st = tdriver.run(cfg, st)
    assert st.virt_pen is None and st.R.shape == (cfg.K, cfg.Np)
    np.testing.assert_allclose(st.R[:, :n].sum(0).numpy(), 1.0, atol=1e-4)
    assert (st.R[:, n:] == 0).all() and torch.isfinite(st.Z_corr).all()
