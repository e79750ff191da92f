"""Virtual R on the rotate path of harmony_tpu_torch against harmony_tpu.

* (a) The K7 twin's last-round extras (``moments=``, ``emit_pen=True``)
  against ``pallas_rotate_update_round_v2`` in interpret mode, with the
  schedule its key draws, on the cases of ``test_torch_rotate``: M within
  rtol 1e-5 of its max, the penalty tables rtol 1e-6, the tile -> block
  map equal, E/O/tile_O as the plain round.
* (b) The K10 twin against ``pallas_virtual_correction``: atol 1e-5; fed
  the phase's Gram table from the K6 twin, as the kernel reads it, equal
  within 1e-6 to the twin that forms the distances, and against the
  Pallas kernel at atol 1e-5.
* (c) The K11 twin against ``pallas_materialize_r``: R atol 1e-6, and equal
  within 1e-6 to the R the K7 twin writes in the same round.
* (d) ``moe_correct_ridge(virtual=)`` against the JAX function on the same
  inputs (the JAX virtual phase's tables), the mixed/pad tail included,
  one and two covariates: Z_corr atol 1e-5.
* (e) Three Harmony rounds of the JAX engine with ``virtual_r=True`` and
  its run-end ``materialize_r``, against the port's engine with the same
  centroids and schedules: objective_kmeans rtol 1e-5, Z_corr and R atol
  1e-4. The JAX virtual state crosses to the port and materialises there.
* (f) The port's virtual run against its own materialised run, with the
  JAX package's own bounds (tests/test_multicov_fast.py:144-171): Z_corr
  atol 2e-4, objective rtol 1e-5, R atol 1e-6.
* (g) The default rotate path (K7 fusing the moments) against the K8
  path (the fused moments dropped before each correction): M rtol 1e-5
  of its max, three rounds at objective rtol 1e-5.
* (h) ``run_harmony(..., virtual_r=True)`` at the setup of
  tests/test_auto_mode.py:105-136: the virtual path engages, R columns sum
  to 1 and ``res.W`` reproduces the applied correction (atol 5e-4).
* (j) The Gram table rides on the state from the phase to the correction,
  which consumes it: no G is left after ``engine.correct``, and
  ``materialize_r`` gives the same R before and after; the correction
  without it (a state crossed from the JAX package) agrees within 1e-6,
  and a JAX virtual state corrects on the CPU as the JAX package does.
  Without G the correction writes R with K11 and applies it with K9, on
  the CPU as on the card (their plain versions here), and gives the bits
  of the K10 twin that forms the distances.
* (k) K10's launch plan over a sweep of K, d, B and covariates: where
  the earlier K10 (a CTA per 64 cells) took the shape, K10 takes it with
  two correction groups or one, or K11 and K9 take it; the shapes it
  turns away are K > 256, d > 192 or one group past shared memory.
* (i) Virtual R engages at K = d = 100, whose (K, d+1) moment table is
  wider than a CTA's threads hold in 4x4 register tiles at once, and on
  layout tiles that are not whole 64-cell pieces (160 cells), where it
  once raised.
* (l) ``estep_variant='legacy'``, the reference's two-normalise op order:
  (a), (b), (c) at their bounds; the mixed/pad tail's recomputed R
  (``_virtual_tail_r``) against the JAX function's at 1e-6 in both
  orders; three rounds as (e); a legacy JAX virtual state crossed into
  the port and materialised there at 1e-6; virtual against materialised
  as (f), one and two covariates.
* (m) K11's launch plan: where the earlier K11 (a CTA per 64 cells
  staging Y^T, Zn, its R table, the block's table, sigma, 2/sigma and the
  codes) took K, d, B and covariates, K11 takes them, in the first form
  that fits: v_chain (to 256 clusters), assign_chain, then the centroids
  read where they lie; two persistent CTAs an SM where both fit.

On CPU tensors the kernel wrappers run their plain versions, so the
port's side of every case is the plain PyTorch path the kernels are held
to on the card.
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
from harmony_tpu.ops import ridge as jridge
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import driver as tdriver
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import run_harmony
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate
from harmony_tpu_torch.ops import ridge as tridge
from harmony_tpu_torch.ops import rotate as tr
from harmony_tpu_torch.ops.tiled import build_batch_tiled_order

from test_torch_rotate import CASES, _close, _jax_schedule, _problem, _t, gram_table

N_JOINT, LAYOUT_TILE = 3, 128


def _last_round(N, Np, d, K, B_vec, T, write_r, with_G=False, variant="fused_vpu"):
    """One K7 round with the last-round extras in both packages, in the op
    order ``variant``, from the same re-entry (JAX's K6 in interpret mode)
    and schedule; ``with_G``: the port's round reads g from the Gram table
    of JAX's Zn. Returns (cj, ct, JAX (res, M, (pen, map)), the port's
    RoundState, the inputs the virtual functions take)."""
    cj, ct, Z, Y, codes, Pr, sigma, theta = _problem(N, Np, d, K, B_vec, T, seed=N + 2 * d,
                                                     variant=variant)
    rng = np.random.default_rng(N + K)
    cp_j = jpr.make_codes_pad(cj, jnp.asarray(codes))
    Zn, tO, O, E = jpr.pallas_reassign(cj, jnp.asarray(Y), jnp.asarray(sigma), jnp.asarray(Pr),
                                       jpr.pad_cells_to_tile(cj, jnp.asarray(Z)), cp_j,
                                       interpret=True)
    # any tile -> joint routing exercises the fusion; the last id is trash
    tj = rng.integers(0, N_JOINT + 1, Np // LAYOUT_TILE).astype(np.int32)
    Zo = np.zeros((d, Np), np.float32)
    Zo[:, :N] = 1.5 * rng.normal(size=(d, N))
    spec_j = jpr.MomentsSpec(Z_orig_pad=jnp.asarray(Zo), tile_joint=jnp.asarray(tj),
                             n_joint=N_JOINT, tile=LAYOUT_TILE)
    spec_t = tr.MomentsSpec(Z_orig=_t(Zo), tile_joint=tj, n_joint=N_JOINT, tile=LAYOUT_TILE)
    R0 = np.full((K, Np), 0.5, np.float32)
    rs_j = jpr.RoundState(R=jnp.asarray(R0), E=E, O=O, tile_O=tO,
                          kmeans_error=jnp.float32(0), entropy=jnp.float32(0))
    rs_t = tr.RoundState(R=_t(R0), E=_t(E), O=_t(O), tile_O=_t(tO), kmeans_error=None,
                         entropy=None)
    key = jax.random.PRNGKey(N + 1)
    rt, order = _jax_schedule(ct, key)
    ref = jpr.pallas_rotate_update_round_v2(
        cj, None, jnp.asarray(Y), rs_j, jnp.asarray(Pr), jnp.asarray(sigma), jnp.asarray(theta),
        key, layout=jpr.CodesLayout(Z_pad=Zn, codes_pad=cp_j), interpret=True, write_r=write_r,
        moments=spec_j, emit_pen=True)
    before = cuda_rotate.rotate_update_round_v2.launches
    out = cuda_rotate.rotate_update_round_v2(
        ct, _t(Y), rs_t, _t(Pr), _t(sigma), _t(theta), tr.schedule_table([(rt, order)])[0],
        tr.CodesLayout(Z_pad=_t(Zn), codes_pad=_t(cp_j),
                       G=gram_table(Y, Zn) if with_G else None),
        write_r, moments=spec_t, emit_pen=True)
    assert cuda_rotate.rotate_update_round_v2.launches == before
    inputs = dict(Y=Y, sigma=sigma, Zn=np.asarray(Zn), cp=np.asarray(cp_j), Zo=Zo, tj=tj,
                  Zr=np.asarray(jpr.pad_cells_to_tile(cj, jnp.asarray(Z))), Pr=Pr)
    return cj, ct, ref, out, inputs


def _check_last_round_extras(N, Np, d, K, B_vec, T, write_r, with_G, variant="fused_vpu"):
    _, _, (res_j, M_j, (pen_j, map_j)), out, _ = _last_round(N, Np, d, K, B_vec, T, write_r,
                                                             with_G, variant)
    M_j = np.asarray(M_j)
    assert out.M.shape == M_j.shape == (N_JOINT + 1, K, d + 1)
    _close(out.M, M_j, rtol=0, atol=1e-5 * np.abs(M_j).max())
    _close(out.pen, pen_j, rtol=1e-6)
    np.testing.assert_array_equal(out.blkmap.numpy(), np.asarray(map_j))
    assert out.blkmap.dtype == torch.int32
    if write_r:
        _close(out.R, res_j.R, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(out.R.numpy(), 0.5)  # the stale input R
    for name in ("E", "O", "tile_O"):
        _close(getattr(out, name), getattr(res_j, name), atol=1e-5)
    _close(float(out.kmeans_error), float(res_j.kmeans_error))
    _close(float(out.entropy), float(res_j.entropy))


@pytest.mark.parametrize("write_r", [True, False])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k7_last_round_extras_match_pallas(N, Np, d, K, B_vec, T, write_r):
    _check_last_round_extras(N, Np, d, K, B_vec, T, write_r, with_G=False)


@pytest.mark.parametrize("write_r", [True, False])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k7_last_round_reading_gram_table_matches_pallas(N, Np, d, K, B_vec, T, write_r):
    _check_last_round_extras(N, Np, d, K, B_vec, T, write_r, with_G=True)


@pytest.mark.parametrize("with_G", [False, True])
@pytest.mark.parametrize("write_r", [True, False])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k7_last_round_extras_legacy_match_pallas(N, Np, d, K, B_vec, T, write_r, with_G):
    _check_last_round_extras(N, Np, d, K, B_vec, T, write_r, with_G, "legacy")


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k10_twin_matches_pallas_virtual_correction(N, Np, d, K, B_vec, T):
    cj, ct, (_, _, (pen_j, map_j)), _, x = _last_round(N, Np, d, K, B_vec, T, False)
    rng = np.random.default_rng(d)
    W = (0.2 * rng.normal(size=(N_JOINT + 1, d, K))).astype(np.float32)
    W[N_JOINT] = 0.0
    ref = jpr.pallas_virtual_correction(
        cj, jnp.asarray(W), jnp.asarray(x["tj"]), LAYOUT_TILE, jnp.asarray(x["Y"]),
        jnp.asarray(x["sigma"]), pen_j, map_j, jnp.asarray(x["Zn"]), jnp.asarray(x["cp"]),
        jnp.asarray(x["Zo"]), interpret=True)
    before = cuda_rotate.virtual_correction.launches
    out = cuda_rotate.virtual_correction(
        ct, _t(W), x["tj"], LAYOUT_TILE, _t(x["Y"]), _t(x["sigma"]), _t(pen_j), _t(map_j),
        _t(x["Zn"]), _t(x["cp"]), _t(x["Zo"]))
    assert cuda_rotate.virtual_correction.launches == before
    _close(out, ref, rtol=0, atol=1e-5)
    # trash tiles pass Z_orig through
    trash = np.repeat(x["tj"] == N_JOINT, LAYOUT_TILE)
    np.testing.assert_array_equal(out.numpy()[:, trash], x["Zo"][:, trash])


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k10_twin_reading_gram_table_matches_pallas(N, Np, d, K, B_vec, T):
    cj, ct, (_, _, (pen_j, map_j)), _, x = _last_round(N, Np, d, K, B_vec, T, False)
    rng = np.random.default_rng(d + 1)
    W = (0.2 * rng.normal(size=(N_JOINT + 1, d, K))).astype(np.float32)
    W[N_JOINT] = 0.0
    ref = jpr.pallas_virtual_correction(
        cj, jnp.asarray(W), jnp.asarray(x["tj"]), LAYOUT_TILE, jnp.asarray(x["Y"]),
        jnp.asarray(x["sigma"]), pen_j, map_j, jnp.asarray(x["Zn"]), jnp.asarray(x["cp"]),
        jnp.asarray(x["Zo"]), interpret=True)
    # the phase's Zn and Gram table from the K6 twin, as the engine keeps them
    Zn, _, _, _, G = tr.reassign(ct, _t(x["Y"]), _t(x["sigma"]), _t(x["Pr"]), _t(x["Zr"]),
                                 _t(x["cp"]))
    assert G.shape == (Np, K)
    args = (ct, _t(W), x["tj"], LAYOUT_TILE, _t(x["Y"]), _t(x["sigma"]), _t(pen_j), _t(map_j),
            Zn, _t(x["cp"]), _t(x["Zo"]))
    before = cuda_rotate.virtual_correction.launches
    with_g = cuda_rotate.virtual_correction(*args, G)
    without = cuda_rotate.virtual_correction(*args)
    assert cuda_rotate.virtual_correction.launches == before
    _close(with_g, without, rtol=0, atol=1e-6)
    _close(with_g, ref, rtol=0, atol=1e-5)
    trash = np.repeat(x["tj"] == N_JOINT, LAYOUT_TILE)
    np.testing.assert_array_equal(with_g.numpy()[:, trash], x["Zo"][:, trash])
    # a table of another layout, or on another device, is refused
    for fn in (tr.virtual_correction, cuda_rotate.virtual_correction):
        with pytest.raises(ValueError, match=rf"G must be \({Np}, {K}\)"):
            fn(*args, G[:-1])
    with pytest.raises(ValueError, match="G is on meta"):
        cuda_rotate.virtual_correction(*args, G.to("meta"))


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k10_twin_legacy_matches_pallas(N, Np, d, K, B_vec, T):
    """K10's twin in the legacy order, forming the distances and reading
    the K6 twin's Gram table, against the Pallas kernel."""
    cj, ct, (_, _, (pen_j, map_j)), _, x = _last_round(N, Np, d, K, B_vec, T, False,
                                                       variant="legacy")
    rng = np.random.default_rng(d + 2)
    W = (0.2 * rng.normal(size=(N_JOINT + 1, d, K))).astype(np.float32)
    W[N_JOINT] = 0.0
    ref = jpr.pallas_virtual_correction(
        cj, jnp.asarray(W), jnp.asarray(x["tj"]), LAYOUT_TILE, jnp.asarray(x["Y"]),
        jnp.asarray(x["sigma"]), pen_j, map_j, jnp.asarray(x["Zn"]), jnp.asarray(x["cp"]),
        jnp.asarray(x["Zo"]), interpret=True)
    Zn, _, _, _, G = tr.reassign(ct, _t(x["Y"]), _t(x["sigma"]), _t(x["Pr"]), _t(x["Zr"]),
                                 _t(x["cp"]))
    args = (ct, _t(W), x["tj"], LAYOUT_TILE, _t(x["Y"]), _t(x["sigma"]), _t(pen_j), _t(map_j))
    without = cuda_rotate.virtual_correction(*args, _t(x["Zn"]), _t(x["cp"]), _t(x["Zo"]))
    with_g = cuda_rotate.virtual_correction(*args, Zn, _t(x["cp"]), _t(x["Zo"]), G)
    _close(without, ref, rtol=0, atol=1e-5)
    _close(with_g, ref, rtol=0, atol=1e-5)
    _close(with_g, without, rtol=0, atol=1e-6)
    trash = np.repeat(x["tj"] == N_JOINT, LAYOUT_TILE)
    np.testing.assert_array_equal(with_g.numpy()[:, trash], x["Zo"][:, trash])


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k11_twin_matches_pallas_materialize_and_k7(N, Np, d, K, B_vec, T):
    _check_k11(N, Np, d, K, B_vec, T, "fused_vpu")


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k11_twin_legacy_matches_pallas_materialize_and_k7(N, Np, d, K, B_vec, T):
    _check_k11(N, Np, d, K, B_vec, T, "legacy")


def _check_k11(N, Np, d, K, B_vec, T, variant):
    """The K11 twin against pallas_materialize_r and the R the K7 twin
    wrote in the same round, in the op order ``variant``."""
    cj, ct, (_, _, (pen_j, map_j)), out, x = _last_round(N, Np, d, K, B_vec, T, True,
                                                         variant=variant)
    ref = jpr.pallas_materialize_r(cj, jnp.asarray(x["Y"]), jnp.asarray(x["sigma"]), pen_j,
                                   map_j, jnp.asarray(x["Zn"]), jnp.asarray(x["cp"]),
                                   interpret=True)
    before = cuda_rotate.materialize_r.launches
    R = cuda_rotate.materialize_r(ct, _t(x["Y"]), _t(x["sigma"]), out.pen, out.blkmap,
                                  _t(x["Zn"]), _t(x["cp"]))
    assert cuda_rotate.materialize_r.launches == before
    assert R.shape == (K, Np)
    _close(R, ref, rtol=0, atol=1e-6)
    # the R the round itself wrote, rebuilt from its tables
    _close(R, out.R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(R.numpy()[:, :N].sum(0), 1.0, atol=1e-5)
    assert (R.numpy()[:, N:] == 0).all()
    assert tr.materialize_r(ct, _t(x["Y"]), _t(x["sigma"]), out.pen, out.blkmap, _t(x["Zn"]),
                            _t(x["cp"]), out_dtype=torch.float64).dtype == torch.float64


def _setup(B_vec, N, Np, lamb=None, seed=7, d=8, K=8, variant="fused_vpu"):
    """A batch-tiled rotate problem (N cells x d dims, K clusters, T = 512,
    layout tile 128) for both packages, virtual R on, in the E-step op
    order ``variant``: at d = K = 8 the shape of tests/test_tiled.py:307-325
    and tests/test_multicov_fast.py:87-119."""
    rng = np.random.default_rng(seed)
    meta = {f"v{c}": rng.integers(0, b, N).astype(np.int32) for c, b in enumerate(B_vec)}
    Z = rng.normal(size=(N, d)).astype(np.float32)
    jd = jpre.build_design(meta, list(meta))
    td = tpre.build_design(meta, list(meta))
    opts_j, opts_t = jconfig.harmony_options(), tconfig.harmony_options()
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=lamb is None)
    cj = jpre.resolve_config(design=jd, options=opts_j, **kw)
    ct = tpre.resolve_config(design=td, options=opts_t, **kw)
    over = dict(shuffle_mode="rotate", estep_sub_tile=512, mstep_tile=128, mstep_mode="tiled",
                N_pad=Np if Np != N else None, virtual_r=True, estep_variant=variant)
    cj = dataclasses.replace(cj, estep_impl="pallas", **over)
    ct = dataclasses.replace(ct, estep_impl="kernel", mstep_impl="kernel", **over)
    perm, _ = jtiled.build_batch_tiled_order(jd.codes, 128, seed=0)
    Zt = jpre.orient_embedding(Z, N)[:, perm]
    jd = dataclasses.replace(jd, codes=jd.codes[:, perm])
    td = dataclasses.replace(td, codes=td.codes[:, perm])
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, lamb, opts_j.tau)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, lamb, opts_t.tau)
    Y0 = Zt[:, rng.choice(N, cj.K, replace=False)]
    return cj, ct, jd, td, Zt, hj, ht, Y0


def _states(cj, ct, jd, td, Zt, hj, ht, Y0, key=3):
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(key))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, key, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    assert tiled_j is not None and tiled_t is not None
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    return sj, st, tiled_j, tiled_t


@pytest.mark.parametrize("B_vec,N", [((3,), 4000), ((2, 3), 4000), ((3,), 4096)])
def test_moe_correct_ridge_virtual_matches_jax(B_vec, N):
    setup = _setup(B_vec, N, 4096)
    cj, ct = setup[:2]
    sj, _, tiled_j, tiled_t = _states(*setup)
    sj, M, virt = jengine.cluster(cj, sj, tiled=tiled_j, return_moments=True, virtual=True)
    assert virt is not None and M is not None
    ref = jridge.moe_correct_ridge(cj, sj.Z_orig, sj.R, sj.O, sj.E, sj.codes, sj.batch_sizes,
                                   sj.lamb, sj.Y, tiled=tiled_j, tiled_moments=M, virtual=virt)
    virt_t = tr.VirtualR(*[_t(a) for a in virt])
    # the state's R is stale on a virtual run: the port must not read it
    stale = torch.full(tuple(sj.R.shape), float("nan"))
    out = tridge.moe_correct_ridge(ct, _t(sj.Z_orig), stale, _t(sj.O), _t(sj.E), _t(sj.codes),
                                   _t(sj.batch_sizes), _t(sj.lamb), _t(sj.Y), tiled=tiled_t,
                                   tiled_moments=_t(M), virtual=virt_t)
    assert ct.Np - tiled_t.n_pure > 0  # a mixed/pad tail is patched
    _close(out[0], ref[0], rtol=0, atol=1e-5)
    _close(out[1], ref[1], rtol=0, atol=1e-5)
    _close(out[2], ref[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["fused_vpu", "legacy"])
def test_virtual_tail_r_matches_jax(variant):
    """The mixed/pad tail's assignments, recomputed from the penalty tables
    of a JAX virtual phase (harmony_tpu/ops/ridge.py:550-585)."""
    setup = _setup((3,), 4000, 4096, variant=variant)
    cj, ct = setup[:2]
    sj, _, tiled_j, tiled_t = _states(*setup)
    sj, _, virt = jengine.cluster(cj, sj, tiled=tiled_j, return_moments=True, virtual=True)
    assert tiled_t.n_pure == tiled_j.n_pure < ct.Np
    ref = jridge._virtual_tail_r(cj, virt, tiled_j.n_pure)
    out = tridge._virtual_tail_r(ct, tr.VirtualR(*[_t(a) for a in virt]), tiled_t.n_pure)
    assert out.shape == (ct.K, ct.Np - tiled_t.n_pure)
    _close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("N", [4096, 4000])
def test_virtual_slice_matches_jax_engine(N):
    _virtual_slice_against_jax(N, "fused_vpu")


@pytest.mark.parametrize("N", [4096, 4000])
def test_virtual_slice_legacy_matches_jax_engine(N):
    _virtual_slice_against_jax(N, "legacy")


def _virtual_slice_against_jax(N, variant):
    """Three rounds of the JAX engine with virtual R and its run-end
    materialize_r against the port's, in the op order ``variant``."""
    setup = _setup((3,), N, 4096, variant=variant)
    cj, ct = setup[:2]
    sj, st, tiled_j, tiled_t = _states(*setup)
    round_j = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled_j))
    for _ in range(3):
        _, sub = jax.random.split(sj.key)
        sched = tr.schedule_table(
            [_jax_schedule(ct, k) for k in jax.random.split(sub, cj.max_iter_cluster)])
        sj = round_j(sj)
        st = tengine.harmony_round(ct, st, schedules=sched, layout=tengine.MStepLayout(tiled_t))
    assert sj.virt_pen is not None and st.virt_pen is not None
    # the phase's layout is the tensor K6 wrote, carried by reference
    assert st.virt_Zn.shape == (8, 4096)
    _close(st.virt_pen, sj.virt_pen, rtol=1e-5)
    np.testing.assert_array_equal(st.virt_blkmap.numpy(), np.asarray(sj.virt_blkmap))
    mj, mt = jengine.materialize_r(cj, sj), tengine.materialize_r(ct, st)
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    _close(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    _close(tt["objective_harmony"], tj["objective_harmony"], rtol=1e-5)
    _close(st.Z_corr.numpy(), np.asarray(sj.Z_corr), rtol=0, atol=1e-4)
    _close(mt.R.numpy(), np.asarray(mj.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(mt.R.numpy()[:, :N].sum(0), 1.0, atol=1e-5)
    assert (mt.R.numpy()[:, N:] == 0).all()


def test_virtual_state_crosses_between_packages():
    _cross_virtual_state("fused_vpu")


def test_legacy_virtual_state_crosses_between_packages():
    _cross_virtual_state("legacy")


def _cross_virtual_state(variant):
    """A JAX virtual state (op order ``variant``) crosses to the port and
    materialises there as in the JAX package."""
    setup = _setup((2, 3), 4000, 4096, variant=variant)
    cj, ct = setup[:2]
    sj, st, tiled_j, tiled_t = _states(*setup)
    # a state that did not take virtual R carries none of the fields
    assert not set(tstate.VIRTUAL_FIELDS) & set(tstate.state_to_arrays(st))
    sj = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled_j))(sj)
    fields = tstate.ARRAY_FIELDS + tstate.VIRTUAL_FIELDS
    st = tstate.state_from_arrays(ct, {f: np.asarray(getattr(sj, f)) for f in fields}, "cpu")
    assert st.virt_blkmap.dtype == torch.int32
    R = tengine.materialize_r(ct, st).R
    _close(R, jengine.materialize_r(cj, sj).R, rtol=0, atol=1e-6)
    back = tstate.state_to_arrays(st)
    for f in tstate.VIRTUAL_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(sj, f)))


@pytest.mark.parametrize("B_vec,N", [((3,), 4000), ((2, 3), 4096)])
def test_correct_consumes_the_gram_table(B_vec, N):
    setup = _setup(B_vec, N, 4096)
    ct = setup[1]
    _, st, _, tiled = _states(*setup)
    st = tengine.cluster(ct, st, tiled=tiled)
    # the phase's table rides on the state to the correction, not across
    assert st.virt_G is not None and st.virt_G.shape == (4096, ct.K)
    assert "virt_G" not in tstate.state_to_arrays(st)
    R_last = tengine.materialize_r(ct, st).R
    out = tengine.correct(ct, st, tengine.MStepLayout(tiled))
    assert out.virt_G is None and out.tiled_moments is None and out.virt_pen is not None
    np.testing.assert_array_equal(tengine.materialize_r(ct, out).R.numpy(), R_last.numpy())
    # the same correction forming the distances again, as on a crossed state
    again = tengine.correct(ct, dataclasses.replace(st, virt_G=None),
                            tengine.MStepLayout(tiled))
    _close(out.Z_corr, again.Z_corr, rtol=0, atol=1e-6)
    _close(out.Y, again.Y, rtol=0, atol=1e-6)


def test_state_crossed_from_jax_corrects_without_gram_table():
    setup = _setup((2, 3), 4000, 4096)
    cj, ct = setup[:2]
    sj, _, tiled_j, tiled_t = _states(*setup)
    sj, M, virt = jengine.cluster(cj, sj, tiled=tiled_j, return_moments=True, virtual=True)
    arrays = {f: np.asarray(getattr(sj, f)) for f in tstate.ARRAY_FIELDS}
    arrays.update(virt_pen=np.asarray(virt.pen), virt_blkmap=np.asarray(virt.blkmap),
                  virt_Zn=np.asarray(virt.Zn_pad), virt_Y=np.asarray(virt.Y))
    st = tstate.state_from_arrays(ct, arrays, "cpu")
    assert st.virt_G is None and st.virt_pen is not None
    out = tengine.correct(ct, dataclasses.replace(st, tiled_moments=_t(M)),
                          tengine.MStepLayout(tiled_t))
    ref = jridge.moe_correct_ridge(cj, sj.Z_orig, sj.R, sj.O, sj.E, sj.codes, sj.batch_sizes,
                                   sj.lamb, sj.Y, tiled=tiled_j, tiled_moments=M, virtual=virt)
    assert out.virt_G is None
    _close(out.Z_corr, ref[0], rtol=0, atol=1e-5)
    _close(out.Y, ref[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("B_vec,N", [((3,), 4000), ((2, 3), 4096)])
def test_correction_without_gram_table_writes_r_then_applies_it(B_vec, N, monkeypatch):
    setup = _setup(B_vec, N, 4096)
    ct = setup[1]
    _, st, _, tiled = _states(*setup)
    st = tengine.cluster(ct, st, tiled=tiled)
    calls = []

    def spy(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(name) or fn(*a, **k))

    spy(cuda_rotate, "virtual_correction")
    spy(cuda_rotate, "materialize_r")
    spy(cuda_ridge, "tiled_correction")
    layout = tengine.MStepLayout(tiled)
    with_g = tengine.correct(ct, st, layout)
    assert calls == ["virtual_correction"]
    calls.clear()
    crossed = dataclasses.replace(st, virt_G=None)
    without = tengine.correct(ct, crossed, layout)
    assert calls == ["materialize_r", "tiled_correction"]
    _close(with_g.Z_corr, without.Z_corr, rtol=0, atol=1e-6)
    # the K10 twin forming the distances gives the same bits
    virt = tengine._virtual_context(ct, crossed)
    nj = tiled.joint_codes.shape[1]
    Wj = torch.randn(nj + 1, ct.d, ct.K, generator=torch.Generator().manual_seed(0))
    Wj[-1] = 0.0
    tj = tridge.full_tile_joint(ct, tiled)
    args = (ct, Wj, tj, tiled.tile)
    routed = tridge.virtual_tile_correction(*args, virt)
    twin = tr.virtual_correction(*args, virt.Y, virt.sigma, virt.pen, virt.blkmap, virt.Zn_pad,
                                 virt.codes_pad, virt.Z_orig_pad)
    assert torch.equal(routed, twin)


def _earlier_k10_took(K, d, B, ncov):
    """The earlier K10's shared memory (a CTA per 64 cells staging Y^T,
    a piece of Zn, its R table, block table, sigma and 2/sigma, the
    joint's betas and the codes)."""
    dp = cuda_ridge._ceil4(d)
    floats = K * d + d * 64 + K * 65 + K * B + 2 * K + K * dp + ncov * 64
    return 4 * floats <= cuda_rotate._SMEM_MAX


@pytest.mark.parametrize("ncov", [1, 2])
@pytest.mark.parametrize("K_range", [(2, 129), (129, 257), (257, 520)])
def test_virtual_correction_takes_every_shape_the_earlier_k10_took(K_range, ncov):
    span = -(-4096 // 132)  # 500k cells at layout tile 128 on 132 SMs
    took = 0
    for K in range(*K_range, 3):
        for d in list(range(1, 80, 3)) + list(range(80, 300, 11)):
            for B in (1, 2, 3, 10, 26, 40, 100, 200, 400):
                if not _earlier_k10_took(K, d, B, ncov):
                    continue
                took += 1
                plan = cuda_rotate.virtual_plan(K, d, B, ncov, span)
                if plan is not None:
                    groups, smem = plan
                    assert smem == cuda_rotate.virtual_smem_bytes(K, d, B, ncov, span, groups)
                    assert smem <= cuda_rotate._SMEM_MAX and K <= 256 and d <= 192
                    assert groups == 1 or d <= 64
                    continue
                # K11 writes R, K9 applies it
                assert cuda_rotate.materialize_r_plan(K, d, B, ncov).smem <= cuda_rotate._SMEM_MAX
                cuda_ridge.k9_plan(K, d)
    assert took > 0
    # the main shape with two groups; one group where two do not fit
    assert cuda_rotate.virtual_plan(100, 50, 10, 1, span)[0] == 2
    assert cuda_rotate.virtual_plan(128, 50, 10, 1, span)[0] == 1
    assert cuda_rotate.virtual_plan(100, 50, 100, 1, span)[0] == 1
    assert cuda_rotate.virtual_plan(100, 100, 10, 1, span)[0] == 1
    assert cuda_rotate.virtual_plan(300, 50, 10, 1, span) is None
    assert cuda_rotate.virtual_plan(50, 200, 10, 1, span) is None


def _earlier_k11_took(K, d, B, ncov):
    """The earlier K11's shared memory (a CTA per 64 cells staging Y^T, a
    piece of Zn, its (K x 65) table, the block's table, sigma, 2/sigma and
    the codes)."""
    floats = K * d + d * 64 + K * 65 + K * B + 2 * K + ncov * 64
    return 4 * floats <= cuda_rotate._SMEM_MAX


def _k11_floats(K, d, B, ncov, kj, ys_shared):
    c4 = lambda n: -(-n // 4) * 4
    f = (d * 8 * -(-K // 8) if ys_shared else 0) + 64 * d
    f += 64 * K + 68 * K if kj else c4(65 * K) + c4(2 * K)
    return f + c4(K * B) + 64 * ncov + c4(ncov)


@pytest.mark.parametrize("ncov", [1, 2, 3])
@pytest.mark.parametrize("K_range", [(1, 129), (129, 257), (257, 520)])
def test_materialize_r_takes_every_shape_the_earlier_k11_took(K_range, ncov):
    took = 0
    smem = lambda *form: 4 * _k11_floats(K, d, B, ncov, *form)
    for K in range(*K_range, 3):
        kj = cuda_rotate.chain_lanes(K)
        for d in list(range(1, 80, 3)) + list(range(80, 310, 11)):
            for B in (1, 2, 3, 10, 26, 40, 100, 200, 400, 566):
                if not _earlier_k11_took(K, d, B, ncov):
                    continue
                took += 1
                plan = cuda_rotate.materialize_r_plan(K, d, B, ncov)
                assert plan.smem == smem(plan.kj, plan.ys_shared) <= cuda_rotate._SMEM_MAX
                assert plan.kj in (0, kj) and (kj > 0) == (K <= 256)
                # the first form that fits: v_chain, assign_chain, then the
                # centroids read where they lie
                forms = ([(kj, True)] if kj else []) + [(0, True), (0, False)]
                first = forms.index((plan.kj, plan.ys_shared))
                assert all(smem(*f) > cuda_rotate._SMEM_MAX for f in forms[:first])
    assert took > 0


def test_materialize_r_plan_and_grid():
    # the main shape: v_chain at four values a lane, Y staged, two CTAs an SM
    plan = cuda_rotate.materialize_r_plan(100, 50, 10, 1)
    assert plan == (4, True, 4 * _k11_floats(100, 50, 10, 1, 4, True))
    assert cuda_rotate.materialize_r_grid(503_808 // 64, plan.smem, 132) == 264
    assert cuda_rotate.materialize_r_grid(10, plan.smem, 132) == 10
    # one CTA an SM where two do not fit
    wide = cuda_rotate.materialize_r_plan(256, 50, 10, 1)
    assert wide[:2] == (8, True) and wide.smem > 115_712
    assert cuda_rotate.materialize_r_grid(7872, wide.smem, 132) == 132
    # past 256 clusters the chain of K7; past shared memory Y where it lies
    assert cuda_rotate.materialize_r_plan(300, 50, 10, 1)[:2] == (0, True)
    assert cuda_rotate.materialize_r_plan(400, 50, 10, 3)[:2] == (0, True)
    assert cuda_rotate.materialize_r_plan(100, 300, 20, 1)[:2] == (0, False)
    assert [cuda_rotate.chain_lanes(K) for K in (1, 32, 33, 64, 65, 128, 129, 256, 257)] == [
        1, 1, 2, 2, 4, 4, 8, 8, 0]
    with pytest.raises(ValueError, match="K=400, d=300, B=100"):
        cuda_rotate.materialize_r_plan(400, 300, 100, 1)


@pytest.mark.parametrize("B_vec", [(3,), (2, 3)])
def test_virtual_run_legacy_matches_materialised_run(B_vec):
    _virtual_against_materialised(B_vec, "legacy")


@pytest.mark.parametrize("B_vec", [(3,), (2, 3), (2, 2, 3)])
def test_virtual_run_matches_materialised_run(B_vec):
    _virtual_against_materialised(B_vec, "fused_vpu")


def _virtual_against_materialised(B_vec, variant):
    """The port's virtual run against its own materialised run, with the
    JAX package's bounds (tests/test_multicov_fast.py:144-171), in the op
    order ``variant``."""
    setup = _setup(B_vec, 4096, 4096, lamb=1.0, variant=variant)
    ct, td, Zt, ht = setup[1], setup[3], setup[4], setup[6]
    layout = tengine.mstep_layout(ct, td.codes)
    out = {}
    for virtual in (True, False):
        cfg = dataclasses.replace(ct, virtual_r=virtual)
        st = tstate.init_state(cfg, Zt, td, ht.sigma, ht.theta, ht.lamb, 5, "cpu")
        out[virtual] = tdriver.run(cfg, st, layout=layout)
    assert out[True].virt_pen is not None and out[False].virt_pen is None
    _close(out[True].Z_corr, out[False].Z_corr, rtol=0, atol=2e-4)
    _close(out[True].trace_lists(ct)["objective_harmony"],
           out[False].trace_lists(ct)["objective_harmony"], rtol=1e-5)
    _close(out[True].R, out[False].R, rtol=0, atol=1e-6)


def test_fused_moments_match_the_k8_path():
    """The default (materialised) rotate path: K7's last round fuses the
    moments; with the fused moments dropped from each phase's state the
    correction runs K8 on R."""
    setup = _setup((3,), 4000, 4096)
    ct = dataclasses.replace(setup[1], virtual_r=False)
    runs = {}
    for fused in (True, False):
        _, st, _, tiled = _states(*setup)  # the same generator seed: the same schedules
        for r in range(3):
            phase = tengine.cluster(ct, st, tiled=tiled)
            assert phase.tiled_moments is not None and phase.virt_pen is None
            if fused and r == 0:
                Zo = tr.pad_cells_to_tile(ct, phase.Z_orig.float())
                M = cuda_ridge.tile_moments_twin(phase.R.float(), Zo, tiled.tile,
                                                 tridge.full_tile_joint(ct, tiled),
                                                 int(tiled.joint_codes.shape[1]))
                _close(phase.tiled_moments, M, rtol=0, atol=1e-5 * float(M.abs().max()))
            if not fused:
                phase = dataclasses.replace(phase, tiled_moments=None)
            st = tengine.correct(ct, phase, tengine.MStepLayout(tiled))
        runs[fused] = st
    _close(runs[True].trace_lists(ct)["objective_kmeans"],
           runs[False].trace_lists(ct)["objective_kmeans"], rtol=1e-5)
    _close(runs[True].Z_corr, runs[False].Z_corr, rtol=0, atol=2e-4)


def test_run_harmony_virtual_r_on_cpu():
    rng = np.random.default_rng(9)
    N, d, B = 4096, 8, 3
    batches = rng.integers(0, B, N)
    Z = rng.normal(size=(N, d)).astype(np.float32)
    res = run_harmony(Z, {"dataset": batches.astype(str)}, ["dataset"], nclust=6, max_iter=2,
                      seed=0, shuffle_mode="rotate", virtual_r=True, device="cpu",
                      options=tconfig.harmony_options(block_size=0.25), return_object=True,
                      early_stop=False)
    assert res.state.virt_pen is not None, "virtual path did not engage"
    assert res.config.virtual_r and res.config.estep_impl == "kernel"
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-5)
    assert np.isfinite(res.embeddings).all()
    W = res.W
    # in engine (ingest) order, as tests/test_auto_mode.py:123-136 checks it
    R_eng = res.state.R.numpy()[:, :N]
    codes_eng = res.state.codes.numpy()[:, :N]
    corr = np.zeros((d, N), np.float32)
    for c, off in enumerate(res.config.covariate_offsets):
        Wc = W[:, 1 + off: 1 + off + res.config.B_vec[c], :]
        corr += np.einsum("kn,knd->dn", R_eng, np.take(Wc, codes_eng[c], axis=1))
    np.testing.assert_allclose(res.state.Z_corr.numpy()[:, :N],
                               res.state.Z_orig.numpy()[:, :N] - corr, atol=5e-4)
    assert "materialize_r" in res.phase_seconds()


def test_virtual_r_engages_at_wide_moment_tables():
    """K = d = 100: 25 x 26 4x4 tiles of the (K, d+1) table, more than the
    256 threads of a K7 CTA hold two at a time. The phase still takes
    virtual R and fuses the moments, equal to K8's on the R it rebuilds."""
    setup = _setup((3,), 4000, 4096, d=100, K=100)
    ct = setup[1]
    _, st, _, tiled = _states(*setup)
    out = tengine.cluster(ct, st, tiled=tiled)
    assert out.virt_pen is not None and out.tiled_moments is not None
    R = tengine.materialize_r(ct, out).R
    M = cuda_ridge.tile_moments_twin(R.float(), tr.pad_cells_to_tile(ct, out.Z_orig.float()),
                                     tiled.tile, tridge.full_tile_joint(ct, tiled),
                                     int(tiled.joint_codes.shape[1]))
    assert out.tiled_moments.shape == (M.shape[0], 100, 101)
    _close(out.tiled_moments, M, rtol=0, atol=1e-5 * float(M.abs().max()))


def test_virtual_r_raises_where_the_moments_cannot_fuse():
    """Layout tiles that are not whole 64-cell pieces (160 cells, T =
    2560) once raised "ROADMAP A9, virtual R on other layout tiles". K7 now
    splits a piece's moments at the tile boundary, so nothing raises: the
    virtual phase runs and fuses the moments, equal to K8's on the R it
    rebuilds, and so does the materialised one (tests/test_torch_virtual_tiles.py
    holds both against the JAX package)."""
    rng = np.random.default_rng(5)
    N, d, K, T, tile = 16_384, 8, 8, 2560, 160
    meta = {"v0": rng.integers(0, 3, N).astype(np.int32)}
    design = tpre.build_design(meta, ["v0"])
    opts = tconfig.harmony_options(block_size=0.25)
    ct = tpre.resolve_config(design=design, options=opts, n_cells=N, d=d, nclust=K,
                             max_iter=1, early_stop=False, verbose=False)
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        ct, shuffle_mode="rotate", estep_sub_tile=T, mstep_tile=tile, mstep_mode="tiled",
        virtual_r=True, estep_impl="kernel", mstep_impl="kernel"))
    perm, _ = build_batch_tiled_order(design.codes, tile, seed=0)
    design = dataclasses.replace(design, codes=design.codes[:, perm])
    Zt = tpre.orient_embedding(rng.normal(size=(N, d)).astype(np.float32), N)[:, perm]
    hp = tpre.expand_hyperparams(design, K, None, 0.1, None, opts.tau)
    tiled = tengine.mstep_layout(ct, design.codes).tiled
    assert ct.estep_sub_tile == T and tiled.tile == tile and tile % 64
    for virtual in (True, False):
        cfg = dataclasses.replace(ct, virtual_r=virtual)
        st = tstate.init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, 3, "cpu")
        st = tengine.init_cluster_from(cfg, st, Zt[:, rng.choice(N, K, replace=False)])
        out = tengine.cluster(cfg, st, tiled=tiled)
        assert out.tiled_moments is not None and (out.virt_pen is not None) == virtual
        R = tengine.materialize_r(cfg, out).R
        M = cuda_ridge.tile_moments_twin(R.float(), tr.pad_cells_to_tile(cfg, out.Z_orig.float()),
                                         tile, tridge.full_tile_joint(cfg, tiled),
                                         int(tiled.joint_codes.shape[1]))
        _close(out.tiled_moments, M, rtol=0, atol=1e-5 * float(M.abs().max()))
