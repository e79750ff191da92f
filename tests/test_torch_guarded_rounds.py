"""engine.run_rounds on the per-round routes, on the CPU: the guarded rounds.

On the card a run_rounds iteration is one CUDA graph; the re-entry and the
rounds that the windowed early stop may skip are guarded regions on device
flags (``graphs.guarded``). On CPU tensors each region is a Python ``if`` on
one read of its flag, the graph's plain version, which these tests drive.

* ``run_rounds`` equals the per-round host loop bit for bit (Z_corr, Y, R,
  the four kmeans traces, ``objective_harmony``, ``kmeans_rounds``, the
  cursors, the generator) on the per-round permute route (K1) with the
  default budget and with ``max_iter_cluster=10`` and phases that the
  window test stops after guarded rounds ran, the two-phase rotate route
  (K12), the carry route at ``max_iter_cluster=10``, the segmented M-step
  and a three-covariate run (Cholesky's solve).
* The device window test equals the host one on the same traces, at either
  cursor.
* With injected draws, run_rounds on the K1 and K12 routes at
  ``max_iter_cluster=10`` is held to the JAX package's per-round loop:
  the same ``kmeans_rounds``, objective rtol 1e-5, Z_corr atol 1e-4 (1e-5
  on K1), R atol 1e-4.
* K12's plain version fed the round's row of the schedule table equals it
  fed the host pairs, through the wrapper too.
* The ridge solve of two or more covariates (``cholesky_ex`` and
  ``solve_ex``, no host read) equals the synchronising forms bit for bit on
  a positive-definite G, gives NaN on the batch of a G that is not, as the
  JAX solve does, and matches ``harmony_tpu``'s ``_solve_ridge`` within
  1e-6 of each batch's largest entry.
* ``graphs.guarded`` off the card: the body runs exactly where the flag is
  nonzero; a region's buffers must keep their dtype and shape.
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
from harmony_tpu.ops import ridge as jridge
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import api as tapi
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import graphs
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.ops import cuda_estep
from harmony_tpu_torch.ops import ridge as tridge
from harmony_tpu_torch.ops import rotate as tr

from test_torch_rotate import CASES, _jax_schedule, _slice_setup
from test_torch_rotate_v1 import _k12_inputs, _t
from test_torch_run_rounds import _host_loop, _same

MAX_ITER = 5
# epsilon_cluster where the phases at these sizes run past window_size + 2
# rounds (into the guarded ones) and stop before 10
EPS_LATE = 3e-6
ROUTES = {
    "k1": dict(shuffle="permute"),
    "k1_early_stop": dict(shuffle="permute", max_iter_cluster=10, epsilon_cluster=EPS_LATE),
    "two_phase": dict(shuffle="rotate", max_iter_cluster=10, epsilon_cluster=EPS_LATE,
                      rotate_stats_carry=False),
    "carry": dict(shuffle="rotate", max_iter_cluster=10, epsilon_cluster=EPS_LATE),
    "segment": dict(shuffle="permute", max_iter_cluster=10, epsilon_cluster=EPS_LATE,
                    mstep_mode="segment", segment_tile=128),
    "three_covariates": dict(shuffle="permute", levels=(3, 4, 2), max_iter_cluster=10,
                             epsilon_cluster=EPS_LATE),
}


def _setup(shuffle, levels=(3,), N=3000, d=8, K=8, seed=5, **change):
    """run_harmony's steps up to init_cluster on the CPU for a run whose
    covariates have ``levels`` levels each: the resolved config (with
    ``change``), the M-step layout and a factory of the initialised state."""
    rng = np.random.default_rng(seed)
    meta = {f"c{i}": rng.integers(0, b, N) for i, b in enumerate(levels)}
    Z = rng.normal(size=(N, d))
    for i, b in enumerate(levels):
        Z += (rng.normal(size=(b, d)) * 0.8)[meta[f"c{i}"]]
    design = tpre.build_design(meta, list(meta))
    opts = tconfig.harmony_options()
    cfg = tpre.resolve_config(
        n_cells=N, d=d, design=design, nclust=K, max_iter=MAX_ITER, early_stop=True,
        options=opts, verbose=False, lambda_estimation=True, ridge_solver="auto",
        shuffle_mode=shuffle)
    cfg = tconfig.finalize_engine_config(dataclasses.replace(cfg, **change))
    perm = tapi.order_from_recipe(design, cfg.shuffle_mode, seed, 128)
    _, design, _ = tapi.apply_ingest_order(design, perm)
    layout = tengine.mstep_layout(cfg, design.codes, "cpu")
    hp = tpre.expand_hyperparams(design, cfg.K, None, 0.1, None, opts.tau)
    Zt = tpre.orient_embedding(Z.astype(np.float32), N)[:, perm]

    def state():
        st = tstate.init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, seed, "cpu")
        return tengine.init_cluster(cfg, st)

    return cfg, layout, state


@pytest.mark.parametrize("route", list(ROUTES))
def test_run_rounds_equals_host_loop(route):
    cfg, layout, state = _setup(**ROUTES[route])
    assert cfg.graph_route
    assert (cfg.rotate_route, bool(cfg.permute_fused)) == {
        "two_phase": ("two_phase", False), "carry": ("carry", False)}.get(route, (None, False))
    assert (layout.segments is not None) == (route == "segment")
    host = _host_loop(cfg, state(), layout, MAX_ITER)
    fused = tengine.run_rounds(cfg, state(), MAX_ITER, layout)
    _same(fused, host)
    rounds = host.kmeans_rounds[:host.n_rounds].tolist()
    if cfg.max_iter_cluster > cfg.window_size + 2:
        # guarded rounds ran, and the window test stopped a phase inside
        # the budget
        assert any(cfg.window_size + 2 < r < cfg.max_iter_cluster for r in rounds), rounds
    else:
        assert set(rounds) == {cfg.max_iter_cluster}


@pytest.mark.parametrize("eps", [1e-2, 1e-4, 1e-6])
def test_device_window_test_equals_the_host_one(eps):
    cfg, layout, state = _setup(shuffle="permute", max_iter_cluster=10, epsilon_cluster=eps)
    st = tengine.harmony_round(cfg, state(), layout=layout)
    want = []
    for n in range(cfg.window_size + 2, st.n_kmeans + 1):
        at = dataclasses.replace(st, n_kmeans=n)
        host = tengine._kmeans_window_converged(cfg, at)
        dev = tengine._kmeans_window_converged_t(cfg, dataclasses.replace(
            at, cursor=torch.tensor([n, st.n_harmony, st.n_rounds])))
        # the window test as the host computed it before the device form
        w, o = cfg.window_size, st.objective_kmeans
        a, b = o[n - 1 - w:n - 1].sum(), o[n - w:n].sum()
        assert dev.shape == (1,) and bool(dev) == host == bool(abs(a - b) / abs(a) < eps)
        want.append(host)
    assert len(want) >= 2


def _k1_setup(mic):
    """A per-round permute problem for both packages (the dense M-step, one
    covariate), with injected centroids and permutations."""
    N, d, B, K = 3000, 6, 4, 8
    rng = np.random.default_rng(13)
    batches = rng.integers(0, B, N)
    Z = ((rng.normal(size=(B, d)) * 0.6)[batches] + rng.normal(size=(N, d))).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=True)
    cj = jpre.resolve_config(design=jd, options=jconfig.harmony_options(max_iter_cluster=mic),
                             **kw)
    ct = tpre.resolve_config(design=td, options=tconfig.harmony_options(max_iter_cluster=mic),
                             **kw)
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        ct, estep_impl="kernel", mstep_impl="kernel"))
    assert ct.shuffle_mode == "permute" and not ct.permute_fused and ct.graph_route
    Zt = jpre.orient_embedding(Z, N)
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, None, 0.0)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, None, 0.0)
    Y0 = Zt[:, rng.choice(N, K, replace=False)]
    perms = np.stack([np.stack([rng.permutation(N) for _ in range(mic)])
                      for _ in range(2)]).astype(np.int32)
    return cj, ct, jd, td, Zt, hj, ht, Y0, perms


def _held_to_jax(cj, ct, sj, st, z_atol):
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    assert (tt["kmeans_rounds"] < ct.max_iter_cluster).any()  # the early stop fired
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=1e-5)
    np.testing.assert_allclose(st.Z_corr.numpy(), np.asarray(sj.Z_corr), rtol=0, atol=z_atol)
    np.testing.assert_allclose(st.R.numpy(), np.asarray(sj.R), rtol=0, atol=1e-4)


def test_k1_run_rounds_with_injected_draws_matches_jax():
    """Two iterations of run_rounds on the K1 route with the permutations
    JAX's per-round loop is given, at max_iter_cluster=10."""
    cj, ct, jd, td, Zt, hj, ht, Y0, perms = _k1_setup(10)
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    layout = tengine.mstep_layout(ct, st.codes.numpy())
    assert layout.tiled is None and layout.segments is None
    cluster_j = jax.jit(lambda s, p: jengine.cluster(cj, s, p))
    correct_j = jax.jit(lambda s: jengine.correct(cj, s))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    for it in range(2):
        sj = correct_j(cluster_j(sj, jnp.asarray(perms[it])))
    st = tengine.run_rounds(ct, st, 2, layout, perms=torch.as_tensor(perms).long())
    _held_to_jax(cj, ct, sj, st, 1e-5)


def test_k12_run_rounds_with_injected_draws_matches_jax():
    """Two iterations of run_rounds on the two-phase route with the schedule
    tables JAX's cluster draws, at max_iter_cluster=10."""
    cj, ct, jd, td, Zt, hj, ht, Y0 = _slice_setup(4096, 4096, None, 10)
    cj = dataclasses.replace(cj, rotate_stats_carry=False)
    ct = dataclasses.replace(ct, rotate_stats_carry=False, estep_impl="kernel",
                             mstep_impl="kernel")
    assert ct.rotate_route == "two_phase" and ct.graph_route
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    cluster_j = jax.jit(lambda s: jengine.cluster(cj, s, tiled=tiled_j))
    correct_j = jax.jit(lambda s: jengine.correct(cj, s, tiled=tiled_j))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    tables = []
    for _ in range(2):
        _, sub = jax.random.split(sj.key)
        tables.append(tr.schedule_table(
            [_jax_schedule(ct, k) for k in jax.random.split(sub, cj.max_iter_cluster)]))
        sj = correct_j(cluster_j(sj))
    before = cuda_estep.rotate_update_round_v1.launches
    st = tengine.run_rounds(ct, st, 2, tengine.MStepLayout(tiled_t),
                            schedules=torch.stack(tables))
    assert cuda_estep.rotate_update_round_v1.launches == before  # CPU: the plain version
    _held_to_jax(cj, ct, sj, st, 1e-4)


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k12_plain_version_reads_the_table_row(N, Np, d, K, B_vec, T):
    cj, ct, Zn, Y, R, E, O, codes, Pr, sigma, theta = _k12_inputs(
        N, Np, d, K, B_vec, T, seed=N + 3)
    lay = tr.CodesLayout(Z_pad=tr.pad_cells_to_tile(ct, _t(Zn)),
                         codes_pad=tr.make_codes_pad(ct, _t(codes)))
    args = [_t(a) for a in (Y, R, E, O, Pr, sigma, theta)]
    g = torch.Generator()
    g.manual_seed(N)
    table = tr.draw_schedules(ct, g, 2)
    for row, (rt, order) in zip(table, tr.schedule_pairs(table)):
        ref = tr.rotate_update_round_v1(ct, *args, rt, order, lay)
        for fn in (tr.rotate_update_round_v1, cuda_estep.rotate_update_round_v1):
            out = fn(ct, *args, row, None, lay)
            for f in ("R", "E", "O", "kmeans_error", "entropy"):
                assert torch.equal(getattr(out, f), getattr(ref, f)), (fn.__module__, f)
        args[1:4] = [ref.R, ref.E, ref.O]


def _normal_matrices(K, B, seed, bad=()):
    """K positive-definite (B, B) matrices (the batches in ``bad`` made
    indefinite) and right-hand sides of d = 5."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, B, B)).astype(np.float32)
    G = A @ A.transpose(0, 2, 1) + B * np.eye(B, dtype=np.float32)
    for k in bad:
        G[k, 0, 0] = -1.0
    return G, rng.normal(size=(K, B, 5)).astype(np.float32)


def _rel_close(a, b, rtol=1e-6):
    """|a - b| <= rtol * max |b| in each batch: another LAPACK's summation
    order moves an entry that cancels to near zero by more than rtol of
    itself."""
    scale = np.abs(b).max(axis=(1, 2), keepdims=True)
    assert (np.abs(a - b) <= rtol * scale).all(), float((np.abs(a - b) / scale).max())


@pytest.mark.parametrize("solver", ["cholesky", "solve"])
def test_the_capturable_solve_equals_the_synchronising_one(solver):
    cfg = tconfig.HarmonyConfig(N=100, d=5, K=6, B=17, B_vec=(9, 8), ridge_solver=solver)
    G, rhs = (torch.from_numpy(a) for a in _normal_matrices(6, 18, 1))
    got = tridge._solve_ridge(cfg, G, rhs)
    want = (torch.cholesky_solve(rhs, torch.linalg.cholesky(G)) if solver == "cholesky"
            else torch.linalg.solve(G, rhs))
    assert torch.equal(got, want)
    cj = jconfig.HarmonyConfig(N=100, d=5, K=6, B=17, B_vec=(9, 8), ridge_solver=solver)
    ref = np.asarray(jridge._solve_ridge(cj, jnp.asarray(G.numpy()), jnp.asarray(rhs.numpy())))
    _rel_close(got.numpy(), ref)


def test_the_solve_gives_nan_where_the_jax_solve_does():
    bad = (1, 4)
    cfg = tconfig.HarmonyConfig(N=100, d=5, K=6, B=17, B_vec=(9, 8))
    cj = jconfig.HarmonyConfig(N=100, d=5, K=6, B=17, B_vec=(9, 8))
    G, rhs = _normal_matrices(6, 18, 2, bad)
    got = tridge._solve_ridge(cfg, torch.from_numpy(G), torch.from_numpy(rhs)).numpy()
    ref = np.asarray(jridge._solve_ridge(cj, jnp.asarray(G), jnp.asarray(rhs)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[list(bad)]).all() and np.isfinite(np.delete(got, bad, 0)).all()
    good = [k for k in range(6) if k not in bad]
    _rel_close(got[good], ref[good])


def test_guarded_off_the_card_runs_where_the_flag_is_set():
    ran = []
    for v in (1, 0, 7):
        graphs.guarded(torch.tensor([v], dtype=torch.int32), lambda v=v: ran.append(v))
    assert ran == [1, 7]


def test_a_guarded_region_keeps_its_buffers():
    cfg, layout, state = _setup(shuffle="permute")
    st = state()
    R0 = st.R
    held = tengine._hold(st, dataclasses.replace(st, R=st.R * 2), ("R",))
    assert held.R is R0 and torch.equal(R0, state().R * 2)
    with pytest.raises(RuntimeError, match="buffer"):
        tengine._hold(st, dataclasses.replace(st, R=st.R.double()), ("R",))
