"""The rotate schedule of harmony_tpu_torch against harmony_tpu.

* ``finalize_engine_config``: the same sub-tile T and padded N as the JAX
  package's for several shapes (its ``estep_impl='auto'`` picks Pallas
  only on a TPU, so it is given 'pallas'); ``virtual_r=True``,
  ``rotate_stats_carry=False``, ``estep_variant='legacy'``,
  ``dtype='bfloat16'``, ``dtype='float16'`` and runs below
  ``n_blocks * 128`` cells resolve.
* The K6 twin (``ops.rotate.reassign``) against ``pallas_reassign`` in
  interpret mode: Zn atol 1e-6; tile_O, O, E rtol 1e-5.
* The K7 twin (``ops.rotate.rotate_update_round_v2``) against
  ``pallas_rotate_update_round_v2`` with the rotation and block order its
  key draws (``_block_old_stats``), writing R or not, one and two
  covariates, two chained rounds: R atol 1e-5; E, O, tile_O, k-means
  error and entropy rtol 1e-5. The step table equals JAX's; blk_O agrees
  to rtol 1e-6. The same under ``estep_variant='legacy'``, the
  reference's two-normalise op order, g formed or read from G.
* The whole slice at the shape of ``tests/test_tiled.py:250-272`` (N =
  4096, d = 8, B = 3, K = 8, T = 512, layout tile 128): three Harmony
  rounds of JAX ``cluster`` (unfused) + ``correct(tiled=)`` against the
  port's engine with the same centroids and schedules. With lambda
  estimated (run_harmony's default): objective_kmeans rtol 1e-5, Z_corr
  and R atol 1e-4. With the fixed lambda = 1 of that test the intercept
  solve cancels (u = r_tot - sum_b O_b^2 / (O_b + lambda)): one M-step
  from identical inputs already differs by 2e-5 in Z_corr between the
  packages (as the JAX package's own tiled and dense paths do), and three
  rounds carry that to objective rtol 5e-5 and R atol 1e-3. Under
  ``estep_variant='legacy'`` the same three rounds at the same bounds.
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
from harmony_tpu.ops import pallas_rotate as jpr
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.ops import cuda_rotate
from harmony_tpu_torch.ops import rotate as tr

R_ATOL, RTOL = 1e-5, 1e-5


def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "N,d,K,B_vec",
    [(500_000, 50, 100, (10,)), (100_000, 20, 30, (3,)), (20_000, 50, 100, (10,)),
     (3000, 8, 5, (3,)), (1_000_000, 100, 100, (100,)), (60_000, 30, 50, (4, 5)),
     (2_000_000, 50, 100, (10,)), (130_001, 16, 200, (40,))],
)
def test_rotate_geometry_matches(N, d, K, B_vec):
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, shuffle_mode="rotate")
    cj = jconfig.finalize_engine_config(jconfig.HarmonyConfig(**kw, estep_impl="pallas"))
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(**kw))
    assert (ct.estep_sub_tile, ct.Np) == (cj.estep_sub_tile, cj.Np)
    assert ct.Np % ct.estep_sub_tile == 0
    assert (ct.estep_impl, ct.mstep_impl, ct.virtual_r) == ("kernel", "kernel", False)


# The cases whose rounds are ported resolve to their route; each keeps, as
# its id, the ROADMAP item it named while it raised.
_PORTED_ROUTES = {"ROADMAP B, K12": "two_phase", "cell-granular rotate round": "cell"}


@pytest.mark.parametrize(
    "change,item",
    [({"rotate_stats_carry": False}, "ROADMAP B, K12"),
     ({"virtual_r": True}, None),
     # ported: the id is the one the case had while it raised
     pytest.param({"dtype": "bfloat16"}, "bf16",
                  id="change2-ROADMAP A9, reduced-precision engines"),
     ({"N": 2559}, "cell-granular rotate round"),
     ({"estep_variant": "legacy"}, "ROADMAP A9"),
     ({"mstep_mode": "segment"}, "segmented M-step"),
     # ported: the id is the one the case had while it raised
     pytest.param({"dtype": "float16"}, "f16", id="change6-ROADMAP A9, float16 engines")],
)
def test_unported_rotate_options_raise(change, item):
    base = tconfig.HarmonyConfig(N=5000, d=4, K=3, B=2, B_vec=(2,), shuffle_mode="rotate")
    if item in ("bf16", "f16"):
        # the bf16 and float16 engines take the stats-carrying route with
        # virtual R, on the geometry of the float32 engine
        cfg = tconfig.finalize_engine_config(dataclasses.replace(base, **change))
        assert (cfg.virtual_r, cfg.estep_impl, cfg.rotate_route) == (True, "kernel", "carry")
        assert (cfg.N_pad, cfg.estep_sub_tile) == (5120, 128)
    elif item is None:
        # ported: virtual R resolves on (engine._virtual_gate decides per run)
        cfg = tconfig.finalize_engine_config(dataclasses.replace(base, **change))
        assert (cfg.virtual_r, cfg.estep_impl, cfg.mstep_impl) == (True, "kernel", "kernel")
    elif item == "segmented M-step":
        # ported: the config resolves, and the M-step takes the segments
        cfg = tconfig.finalize_engine_config(dataclasses.replace(base, **change))
        assert cfg.use_segments and cfg.rotate_route == "carry"
        assert (cfg.N_pad, cfg.estep_sub_tile, cfg.segment_tile) == (5120, 128, 1024)
    elif change == {"estep_variant": "legacy"}:
        # ported: the stats-carrying route runs K7, K10 and K11 in that order
        cfg = tconfig.finalize_engine_config(dataclasses.replace(base, **change))
        assert cfg.rotate_route == "carry" and cfg.estep_variant == "legacy"
        assert (cfg.N_pad, cfg.estep_sub_tile, cfg.estep_impl) == (5120, 128, "kernel")
    elif item in _PORTED_ROUTES:
        route = _PORTED_ROUTES[item]
        # legacy and virtual R are accepted there, as the JAX package ignores them
        for extra in ({}, {"estep_variant": "legacy"}, {"virtual_r": True}):
            cfg = tconfig.finalize_engine_config(dataclasses.replace(base, **change, **extra))
            assert cfg.rotate_route == route and cfg.estep_impl == "kernel"
        if route == "cell":
            assert (cfg.Np, cfg.estep_sub_tile) == (2559, 4096)
        else:
            assert (cfg.N_pad, cfg.estep_sub_tile) == (5120, 128)
    else:
        with pytest.raises(NotImplementedError, match=item):
            tconfig.finalize_engine_config(dataclasses.replace(base, **change))
    mxu = tconfig.finalize_engine_config(dataclasses.replace(base, estep_variant="fused_mxu"))
    assert mxu.N_pad == 5120 and mxu.estep_sub_tile == 128
    with pytest.raises(tconfig.HarmonyConfigError):
        tconfig.finalize_engine_config(dataclasses.replace(base, estep_variant="vpu"))


def _problem(N, Np, d, K, B_vec, T, seed, variant="fused_vpu"):
    """A padded rotate problem, built the same way for both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, N_pad=Np if Np != N else None,
              estep_sub_tile=T, estep_variant=variant)
    cj, ct = jconfig.HarmonyConfig(**kw), tconfig.HarmonyConfig(**kw)
    Z = np.zeros((d, Np), np.float32)
    Z[:, :N] = 2.5 * rng.normal(size=(d, N))
    Zn = Z[:, :N] / np.linalg.norm(Z[:, :N], axis=0)
    Y = Zn[:, rng.choice(N, K, replace=False)] + 0.3 * rng.normal(size=(d, K))
    Y = (Y / np.linalg.norm(Y, axis=0)).astype(np.float32)
    codes = np.zeros((len(B_vec), Np), np.int32)
    for c, b in enumerate(B_vec):
        codes[c, :N] = rng.integers(0, b, N)
    Pr = (np.concatenate([np.bincount(codes[c, :N], minlength=b) for c, b in enumerate(B_vec)])
          / N).astype(np.float32)
    sigma = rng.uniform(0.08, 0.15, K).astype(np.float32)
    theta = rng.uniform(1.0, 2.0, cj.B).astype(np.float32)
    return cj, ct, Z, Y, codes, Pr, sigma, theta


CASES = [(600, 640, 8, 5, (3,), 128), (600, 640, 8, 5, (2, 3), 128),
         (1500, 1536, 12, 6, (3,), 128), (2560, 2560, 6, 4, (2, 2, 3), 256)]


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k6_twin_matches_pallas_reassign(N, Np, d, K, B_vec, T):
    cj, ct, Z, Y, codes, Pr, sigma, _ = _problem(N, Np, d, K, B_vec, T, seed=N + K)
    cp_j = jpr.make_codes_pad(cj, jnp.asarray(codes))
    Zr_j = jpr.pad_cells_to_tile(cj, jnp.asarray(Z))
    ref = jpr.pallas_reassign(cj, jnp.asarray(Y), jnp.asarray(sigma), jnp.asarray(Pr), Zr_j,
                              cp_j, interpret=True)
    cp_t = tr.make_codes_pad(ct, _t(codes))
    np.testing.assert_array_equal(cp_t.numpy(), np.asarray(cp_j))
    Zr_t = tr.pad_cells_to_tile(ct, _t(Z))
    np.testing.assert_array_equal(Zr_t.numpy(), np.asarray(Zr_j))
    before = cuda_rotate.reassign.launches
    out = cuda_rotate.reassign(ct, _t(Y), _t(sigma), _t(Pr), Zr_t, cp_t)
    assert cuda_rotate.reassign.launches == before
    _close(out[0], ref[0], rtol=0, atol=1e-6)
    for o, r in zip(out[1:], ref[1:]):
        _close(o, r, atol=1e-6)
    # the per-tile table is the design contraction of the re-entry R
    R = np.asarray(jengine.ops.initial_assignments(
        jengine.ops.compute_distances(jnp.asarray(Y), ref[0][:, :N]), jnp.asarray(sigma)))
    R = np.concatenate([R, np.zeros((K, cp_t.shape[1] - N), np.float32)], axis=1)
    _close(tr.tile_stats_from_R(ct, _t(R), cp_t), out[1], atol=1e-5)


def _jax_schedule(cfg_t, key):
    """(rt, order) as _block_old_stats draws them from a round key."""
    NT = tr.n_tiles(cfg_t)
    nb = len(tr.block_sizes(cfg_t)[0])
    k1, k2 = jax.random.split(key)
    return int(jax.random.randint(k1, (), 0, NT)), [int(b) for b in jax.random.permutation(k2, nb)]


def _jax_table(cfg_t, keys):
    """The schedule table the engine takes, of the rounds' JAX draws."""
    return tr.schedule_table([_jax_schedule(cfg_t, k) for k in keys])


def gram_table(Y, Zn):
    """The phase's Gram table as K6 stores it, (Y^T Zn)^T, from JAX's Zn."""
    return _t(np.asarray(Zn).T @ np.asarray(Y))


def _k7_rounds_against_pallas(N, Np, d, K, B_vec, T, with_G, variant="fused_vpu"):
    """Two K7 rounds of the twin against pallas_rotate_update_round_v2 in
    the op order ``variant``, g formed from the layout's Zn or
    (``with_G``) read from the Gram table of JAX's Zn, as the engine runs
    it."""
    cj, ct, Z, Y, codes, Pr, sigma, theta = _problem(N, Np, d, K, B_vec, T, seed=N + d,
                                                     variant=variant)
    cp_j = jpr.make_codes_pad(cj, jnp.asarray(codes))
    Zn, tO, O, E = jpr.pallas_reassign(cj, jnp.asarray(Y), jnp.asarray(sigma), jnp.asarray(Pr),
                                       jpr.pad_cells_to_tile(cj, jnp.asarray(Z)), cp_j,
                                       interpret=True)
    lay_j = jpr.CodesLayout(Z_pad=Zn, codes_pad=cp_j)
    lay_t = tr.CodesLayout(Z_pad=_t(Zn), codes_pad=_t(cp_j),
                           G=gram_table(Y, Zn) if with_G else None)
    R0 = np.full((K, Np), 0.5, np.float32)  # stale R: no round reads it
    rs_j = jpr.RoundState(R=jnp.asarray(R0), E=E, O=O, tile_O=tO,
                          kmeans_error=jnp.float32(0), entropy=jnp.float32(0))
    rs_t = tr.RoundState(R=_t(R0), E=_t(E), O=_t(O), tile_O=_t(tO), kmeans_error=None,
                         entropy=None)
    targs = [_t(Y), None, _t(Pr), _t(sigma), _t(theta)]
    for rnd, key in enumerate(jax.random.split(jax.random.PRNGKey(N), 2)):
        rt, order = _jax_schedule(ct, key)
        scal, blk_j = jpr._block_old_stats(cj, rs_j.tile_O, tr.n_tiles(ct), key)
        steps, blk_t = tr.block_old_stats(ct, rs_t.tile_O, rt, order)
        np.testing.assert_array_equal(steps.numpy(), np.asarray(scal))
        _close(blk_t, blk_j, rtol=1e-6, atol=1e-5)
        for write_r in (True, False):
            ref = jpr.pallas_rotate_update_round_v2(
                cj, None, jnp.asarray(Y), rs_j, jnp.asarray(Pr), jnp.asarray(sigma),
                jnp.asarray(theta), key, layout=lay_j, interpret=True, write_r=write_r)
            targs[1] = rs_t
            before = cuda_rotate.rotate_update_round_v2.launches
            out = cuda_rotate.rotate_update_round_v2(ct, *targs, tr.schedule_table([(rt, order)])[0],
                                                     lay_t, write_r)
            assert cuda_rotate.rotate_update_round_v2.launches == before
            if write_r:
                _close(out.R, ref.R, rtol=0, atol=R_ATOL)
                np.testing.assert_allclose(out.R.numpy()[:, :N].sum(0), 1.0, atol=1e-5)
                assert (out.R.numpy()[:, N:] == 0).all()
            else:
                assert out.R is rs_t.R
            for name in ("E", "O", "tile_O"):
                _close(getattr(out, name), getattr(ref, name), atol=1e-5)
            _close(float(out.kmeans_error), float(ref.kmeans_error))
            _close(float(out.entropy), float(ref.entropy))
        # chain: round 2 starts from round 1's carry in each package
        rs_j = ref._replace(R=jnp.asarray(R0))
        rs_t = out._replace(R=_t(R0))


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k7_twin_matches_pallas_round(N, Np, d, K, B_vec, T):
    _k7_rounds_against_pallas(N, Np, d, K, B_vec, T, with_G=False)


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k7_twin_reading_gram_table_matches_pallas_round(N, Np, d, K, B_vec, T):
    _k7_rounds_against_pallas(N, Np, d, K, B_vec, T, with_G=True)


@pytest.mark.parametrize("with_G", [False, True])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k7_twin_legacy_matches_pallas_round(N, Np, d, K, B_vec, T, with_G):
    _k7_rounds_against_pallas(N, Np, d, K, B_vec, T, with_G, variant="legacy")


def test_k7_wrapper_rejects_mixed_devices():
    _, ct, Z, Y, codes, Pr, sigma, theta = _problem(600, 640, 8, 5, (3,), 128, seed=1)
    cp = tr.make_codes_pad(ct, _t(codes))
    Zn, tO, O, E, _ = tr.reassign(ct, _t(Y), _t(sigma), _t(Pr), _t(Z), cp)
    rs = tr.RoundState(R=torch.zeros(5, 640), E=E, O=O, tile_O=tO, kmeans_error=None,
                       entropy=None)
    with pytest.raises(ValueError, match="sigma is on meta"):
        cuda_rotate.rotate_update_round_v2(ct, _t(Y), rs, _t(Pr), _t(sigma).to("meta"),
                                           _t(theta), tr.schedule_table([(0, [0, 1, 2, 3, 4])])[0],
                                           tr.CodesLayout(Zn, cp))
    with pytest.raises(ValueError, match="Y is on meta"):
        cuda_rotate.reassign(ct, _t(Y).to("meta"), _t(sigma), _t(Pr), _t(Z), cp)


def test_schedule_draws_and_blocks():
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(
        N=100_000, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate"))
    NT = tr.n_tiles(ct)
    szs, vstart = tr.block_sizes(ct)
    assert (NT, len(szs), sum(szs), vstart[-1] + szs[-1]) == (25, 20, 25, 25)
    assert szs == [2] * 5 + [1] * 15
    g = torch.Generator()
    g.manual_seed(3)
    sched = tr.draw_schedules(ct, g, 4)
    assert sched.shape == (4, 21) and sched.dtype == torch.int32
    for rt, order in tr.schedule_pairs(sched):
        assert 0 <= rt < NT and sorted(order) == list(range(20))
    tiles = [p for b in range(20) for p in tr.block_tiles(ct, 7, b)]
    assert sorted(tiles) == list(range(NT)) and tiles[0] == 7


def _slice_setup(N, Np, lamb, max_iter_cluster=4, variant="fused_vpu"):
    """tests/test_tiled.py:250-272's problem, for both packages, in the
    E-step op order ``variant``."""
    rng = np.random.default_rng(7)
    d, B = 8, 3
    batches = rng.integers(0, B, N)
    Z = rng.normal(size=(N, d)).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    opts_j = jconfig.harmony_options(max_iter_cluster=max_iter_cluster)
    opts_t = tconfig.harmony_options(max_iter_cluster=max_iter_cluster)
    kw = dict(n_cells=N, d=d, nclust=8, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=lamb is None)
    cj = jpre.resolve_config(design=jd, options=opts_j, **kw)
    ct = tpre.resolve_config(design=td, options=opts_t, **kw)
    over = dict(shuffle_mode="rotate", estep_sub_tile=512, mstep_tile=128, mstep_mode="tiled",
                N_pad=Np if Np != N else None, estep_variant=variant)
    cj = dataclasses.replace(cj, estep_impl="pallas", **over)
    ct = dataclasses.replace(ct, estep_impl="torch", mstep_impl="torch", **over)
    perm, _ = jtiled.build_batch_tiled_order(jd.codes, 128, seed=0)
    Zt = jpre.orient_embedding(Z, N)[:, perm]
    jd = dataclasses.replace(jd, codes=jd.codes[:, perm])
    td = dataclasses.replace(td, codes=td.codes[:, perm])
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, lamb, opts_j.tau)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, lamb, opts_t.tau)
    Y0 = Zt[:, rng.choice(N, cj.K, replace=False)]
    return cj, ct, jd, td, Zt, hj, ht, Y0


@pytest.mark.parametrize(
    "N,Np,lamb,obj_rtol,r_atol,mic",
    [(4096, 4096, None, 1e-5, 1e-4, 4), (4000, 4096, None, 1e-5, 1e-4, 4),
     (4096, 4096, 1.0, 5e-5, 1e-3, 4),
     # a budget past window_size + 2: every round writes R, early stop on
     (4096, 4096, None, 1e-5, 1e-4, 7)],
)
def test_rotate_slice_matches_jax_engine(N, Np, lamb, obj_rtol, r_atol, mic):
    _rotate_slice_against_jax(N, Np, lamb, obj_rtol, r_atol, mic, "fused_vpu")


@pytest.mark.parametrize("N,Np", [(4096, 4096), (4000, 4096)])
def test_rotate_slice_legacy_matches_jax_engine(N, Np):
    _rotate_slice_against_jax(N, Np, None, 1e-5, 1e-4, 4, "legacy")


def _rotate_slice_against_jax(N, Np, lamb, obj_rtol, r_atol, mic, variant):
    """Three Harmony rounds of the JAX engine against the port's, the same
    centroids and schedules, in the op order ``variant``."""
    cj, ct, jd, td, Zt, hj, ht, Y0 = _slice_setup(N, Np, lamb, mic, variant)
    key = jax.random.PRNGKey(3)
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, key)
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    assert tiled_j is not None and tiled_t is not None
    np.testing.assert_array_equal(tiled_t.tile_joint, tiled_j.tile_joint)
    cluster_j = jax.jit(lambda s: jengine.cluster(cj, s, tiled=tiled_j))
    correct_j = jax.jit(lambda s: jengine.correct(cj, s, tiled=tiled_j))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    for _ in range(3):
        # the schedules JAX's cluster draws from the state key
        _, sub = jax.random.split(sj.key)
        sched = _jax_table(ct, jax.random.split(sub, cj.max_iter_cluster))
        sj = correct_j(cluster_j(sj))
        st = tengine.correct(ct, tengine.cluster(ct, st, schedules=sched),
                             tengine.MStepLayout(tiled_t))
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    _close(tt["objective_kmeans"], tj["objective_kmeans"], rtol=obj_rtol)
    _close(tt["objective_harmony"], tj["objective_harmony"], rtol=obj_rtol)
    _close(st.Z_corr.numpy(), np.asarray(sj.Z_corr), rtol=0, atol=1e-4)
    _close(st.R.numpy(), np.asarray(sj.R), rtol=0, atol=r_atol)
    assert (st.R.numpy()[:, N:] == 0).all() and st.Z_corr.shape == (8, Np)


def test_padded_state_crosses_between_packages():
    cj, ct, jd, td, Zt, hj, ht, _ = _slice_setup(4000, 4096, None)
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(5))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 5, "cpu")
    arrays = tstate.state_to_arrays(st)
    for f in tstate.ARRAY_FIELDS:
        np.testing.assert_allclose(arrays[f], np.asarray(getattr(sj, f)), rtol=1e-6)
    back = tstate.state_to_arrays(tstate.state_from_arrays(
        ct, {f: np.asarray(getattr(sj, f)) for f in tstate.ARRAY_FIELDS}, "cpu"))
    for f in tstate.ARRAY_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(sj, f)))
    assert back["Z_orig"].shape == (8, 4096) and (back["codes"][:, 4000:] == 0).all()


def test_run_harmony_rotate_without_a_tiled_layout():
    """20 batches at 70k cells fail the mixture gate: the ingest order is a
    plain permutation and the M-step dense; at 40 batches it takes the
    segmented M-step, as the JAX package does."""
    from harmony_tpu_torch import run_harmony

    rng = np.random.default_rng(4)
    n, d = 70_000, 4
    batches = rng.integers(0, 20, n)
    Z = (rng.normal(size=(20, d)) * 0.5)[batches] + rng.normal(size=(n, d))
    res = run_harmony(Z, {"b": batches}, ["b"], nclust=6, max_iter=2, device="cpu",
                      shuffle_mode="rotate", return_object=True)
    assert res.config.Np == 71_680 and res.config.estep_sub_tile == 2048
    layout = tengine.mstep_layout(res.config, res.design.codes)
    assert layout.tiled is None and layout.segments is None
    plain_order = np.random.default_rng(0).permutation(n)
    np.testing.assert_array_equal(res.ingest_inv, np.argsort(plain_order))
    np.testing.assert_allclose(res.Z_orig, Z.T.astype(np.float32))
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
    assert np.isfinite(res.embeddings).all() and res.W.shape == (6, 21, d)
    res = run_harmony(Z, {"b": rng.integers(0, 40, n)}, ["b"], nclust=6, max_iter=1,
                      device="cpu", shuffle_mode="rotate", return_object=True)
    layout = tengine.mstep_layout(res.config, res.design.codes)
    assert layout.tiled is None and len(layout.segments) == 1
    assert np.isfinite(res.embeddings).all()
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
