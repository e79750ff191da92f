"""The batch-tiled layout and M-step of harmony_tpu_torch against harmony_tpu.

* ``ops/tiled.py``: the ingest order of ``build_batch_tiled_order`` is
  identical for the same seed; ``detect_tiled_layout``,
  ``choose_tiled_tile``, ``count_joint_levels`` and ``tiled_mixture_ok``
  agree.
* The K8/K9 twins against ``pallas_tile_moments``/
  ``pallas_tiled_correction`` in interpret mode: rtol 1e-5.
* The order K9 and K10 walk, K8's per-joint plan read chunk by chunk
  (``cuda_ridge.plan_order``): every layout tile of the padded axis once,
  joint by joint inside a chunk of its own joint, ascending, the trash
  tiles in the trash chunks, a partial last tile included.
* K9's launch plan (``cuda_ridge.k9_plan``) over a sweep of K and d: it
  takes every shape the earlier K9 took (d <= 128 and a joint's betas and
  one 64-cell piece of R in shared memory), two staged slices where they
  fit, and its threads' 4-dim tiles cover every dim.
* ``moe_correct_ridge(..., tiled=)`` (Z_corr, Y_new, W) against JAX's on
  the same layout, one and two covariates, pad cells, a dropped batch:
  Z_corr and W atol 1e-5; Y_new atol 1e-4, because with a fixed lambda the
  intercept solve cancels (u = r_tot - sum_b O_b^2 / (O_b + lambda)) and
  amplifies fp32 reordering of the moments: the JAX package's own tiled
  and dense paths differ by up to 8.6e-5 in Y_new on these inputs.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harmony_tpu import ops as jops
from harmony_tpu.config import HarmonyConfig as JConfig
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu.ops.pallas_ridge import pallas_tile_moments, pallas_tiled_correction
from harmony_tpu.ops.ridge import moe_correct_ridge as j_moe
from harmony_tpu_torch.config import HarmonyConfig as TConfig
from harmony_tpu_torch.ops import cuda_ridge
from harmony_tpu_torch.ops import tiled as ttiled
from harmony_tpu_torch.ops.ridge import full_tile_joint, moe_correct_ridge

ATOL = 1e-5
Y_ATOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


def _codes(N, B_vec, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    p = lambda b: np.arange(1, b + 1) / np.arange(1, b + 1).sum() if skew else None
    return np.stack([rng.choice(b, size=N, p=p(b)) for b in B_vec]).astype(np.int32)


@pytest.mark.parametrize("B_vec", [(4,), (2, 3), (3, 2, 2)])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_ingest_order_and_layout_are_identical(B_vec, skew, seed):
    codes = _codes(5000, B_vec, seed=seed, skew=skew)
    for tile in (128, 256):
        pj, lj = jtiled.build_batch_tiled_order(codes, tile, seed)
        pt, lt = ttiled.build_batch_tiled_order(codes, tile, seed)
        np.testing.assert_array_equal(pt, pj)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a, b)
        dj = jtiled.detect_tiled_layout(codes[:, pj], 5000, tile)
        dt = ttiled.detect_tiled_layout(codes[:, pt], 5000, tile)
        assert (dj is None) == (dt is None)
        if dj is not None:
            for a, b in zip(dt, dj):
                np.testing.assert_array_equal(a, b)
    assert ttiled.count_joint_levels(codes) == jtiled.count_joint_levels(codes)
    assert ttiled.detect_tiled_layout(codes, 5000, 128) is None
    assert jtiled.detect_tiled_layout(codes, 5000, 128) is None


@pytest.mark.parametrize(
    "Np,n_blocks,mstep_tile,n_joint",
    [(1_000_000, 20, 256, 10), (1_000_000, 20, 256, 100), (250_000, 20, 256, 100),
     (503_808, 20, 256, 10), (20_480, 20, 128, 10), (102_400, 20, 256, 3)],
)
def test_tile_choice_matches(Np, n_blocks, mstep_tile, n_joint):
    cfg = SimpleNamespace(Np=Np, n_blocks=n_blocks, mstep_tile=mstep_tile)
    assert ttiled.choose_tiled_tile(cfg, n_joint) == jtiled.choose_tiled_tile(cfg, n_joint)
    for tile in (128, 256):
        for factor in (2.0, 4.0):
            assert ttiled.tiled_mixture_ok(Np, tile, n_blocks, n_joint, factor) == \
                jtiled.tiled_mixture_ok(Np, tile, n_blocks, n_joint, factor)


def _layout_problem(N, d, K, B_vec, tile, seed, pad=0):
    """Batch-tiled codes, R a simplex with zero pad columns, Z, per-joint betas."""
    rng = np.random.default_rng(seed)
    codes = _codes(N, B_vec, seed=seed)
    perm, layout = jtiled.build_batch_tiled_order(codes, tile, seed)
    codes = np.concatenate([codes[:, perm], np.zeros((len(B_vec), pad), np.int32)], axis=1)
    Np = N + pad
    R = np.zeros((K, Np), np.float32)
    R[:, :N] = rng.dirichlet(np.ones(K), N).T
    Z = np.zeros((d, Np), np.float32)
    Z[:, :N] = rng.normal(size=(d, N))
    nj = layout.joint_codes.shape[1]
    W = (rng.normal(size=(nj + 1, d, K)) * 0.1).astype(np.float32)
    W[nj] = 0.0
    return codes, layout, R, Z, W


@pytest.mark.parametrize(
    "N,d,K,B_vec,tile,pad",
    [(4000, 6, 7, (3,), 128, 0), (4000, 6, 7, (3,), 128, 96), (5000, 5, 4, (2, 3), 128, 0),
     (6000, 9, 5, (3,), 256, 144)],
)
def test_k8_k9_twins_match_pallas(N, d, K, B_vec, tile, pad):
    codes, layout, R, Z, W = _layout_problem(N, d, K, B_vec, tile, seed=N + pad, pad=pad)
    nj = layout.joint_codes.shape[1]
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, N_pad=N + pad if pad else None,
              estep_sub_tile=512)
    cj, ct = JConfig(**kw), TConfig(**kw)
    tj_j = jnp.asarray(layout.tile_joint)
    Mj = np.asarray(pallas_tile_moments(cj, jnp.asarray(R), jnp.asarray(Z), tile, tj_j, nj,
                                        interpret=True))
    Cj = np.asarray(pallas_tiled_correction(cj, jnp.asarray(W), tj_j, jnp.asarray(R),
                                            jnp.asarray(Z), tile, interpret=True))
    tj = full_tile_joint(ct, layout)
    before = (cuda_ridge.tile_moments.launches, cuda_ridge.tiled_correction.launches)
    Mt = cuda_ridge.tile_moments(_t(R), _t(Z), tile, tj, nj)
    Ct = cuda_ridge.tiled_correction(_t(W), tj, _t(R), _t(Z), tile)
    assert (cuda_ridge.tile_moments.launches, cuda_ridge.tiled_correction.launches) == before
    np.testing.assert_allclose(Mt.numpy(), Mj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(Ct.numpy(), Cj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "N,Np,B_vec,tile",
    [(5000, 5000, (3,), 128), (6000, 6144, (2, 3), 256), (30_011, 30_011, (3, 4), 128),
     (4000, 4096, (4,), 64)],
)
def test_plan_order_covers_every_tile_once(N, Np, B_vec, tile):
    codes = _codes(N, B_vec, seed=N)
    _, layout = jtiled.build_batch_tiled_order(codes, tile, seed=1)
    tj = full_tile_joint(SimpleNamespace(Np=Np), layout)
    nj = layout.joint_codes.shape[1]
    nt = -(-Np // tile)
    assert tj.shape == (nt,)  # the last tile is partial at 5,000 and 30,011 cells
    # K8's plan at its chunk size, of about 512 cells
    chunks, start, n_chunks = cuda_ridge._moments_plan(tj.tobytes(), nj, "cpu",
                                                       max(1, 512 // tile))
    order = cuda_ridge.plan_order(tj, "cpu")
    assert order.dtype == torch.int32
    order = order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(nt))  # each tile once
    # joint by joint (the trash row n_joint last), ascending within a joint
    np.testing.assert_array_equal(order, np.argsort(tj, kind="stable"))
    # and the plan's chunks read in order: each inside a chunk of its own joint
    ch, st = chunks.numpy(), start.numpy()
    np.testing.assert_array_equal(order, ch[ch >= 0])
    for j in range(nj + 1):
        rows = ch[st[j] : st[j + 1]]
        tiles = rows[rows >= 0]
        assert (tj[tiles] == j).all() and (np.diff(tiles) > 0).all()
    assert set(order[tj[order] == nj]) == set(np.flatnonzero(tj == nj))
    assert (tj == nj).any() and n_chunks == len(ch)


def _earlier_k9_took(K, d):
    """The earlier K9's range: 4x4 tiles of 256 threads (d <= 128), and a
    joint's betas beside one 64-cell piece of R."""
    return d <= 128 and 4 * K * (cuda_ridge._ceil4(d) + 64) <= cuda_ridge._SMEM_MAX


@pytest.mark.parametrize("K_range", [(1, 129), (129, 257), (257, 513), (513, 1025)])
def test_k9_plan_takes_every_shape_the_earlier_k9_took(K_range):
    took = 0
    for K in range(*K_range):
        for d in list(range(1, 70)) + list(range(70, 400, 7)):
            if not _earlier_k9_took(K, d):
                continue
            took += 1
            stages, threads, smem = cuda_ridge.k9_plan(K, d)
            dp = cuda_ridge._ceil4(d)
            assert smem == 4 * K * (dp + 64 * stages) <= cuda_ridge._SMEM_MAX
            assert stages == (2 if 4 * K * (dp + 128) <= cuda_ridge._SMEM_MAX else 1)
            # a thread's 4-dim tiles, threads / 8 of them side by side, cover d
            assert threads % 32 == 0 and 128 <= threads <= 512
            assert threads >= min(512, 8 * -(-d // 4))
    assert took > 0
    # the main shape: two slices, three CTAs an SM; past shared memory it raises
    assert cuda_ridge.k9_plan(100, 50) == (2, 128, 72_000)
    assert cuda_ridge.k9_plan(320, 50)[0] == 2 and cuda_ridge.k9_plan(400, 50)[0] == 1
    assert cuda_ridge.k9_plan(50, 300)[1] == 512
    with pytest.raises(ValueError, match="over the 232448"):
        cuda_ridge.k9_plan(1000, 4)


def test_tiled_wrappers_check_their_inputs():
    R, Z = torch.rand(3, 512), torch.rand(4, 512)
    with pytest.raises(ValueError, match="one entry per 128-cell tile"):
        cuda_ridge.tile_moments(R, Z, 128, np.zeros(3, np.int32), 1)
    with pytest.raises(ValueError, match="disagree"):
        cuda_ridge.tile_moments(R, torch.rand(4, 500), 128, np.zeros(4, np.int32), 1)
    with pytest.raises(ValueError, match="W_joint"):
        cuda_ridge.tiled_correction(torch.zeros(2, 4, 5), np.zeros(4, np.int32), R, Z, 128)
    with pytest.raises(ValueError, match="Z is on meta"):
        cuda_ridge.tile_moments(R, Z.to("meta"), 128, np.zeros(4, np.int32), 1)


def _ridge_problem(N, d, K, B_vec, T, seed, pad=0):
    """The JAX suite's batch-tiled ridge problem (tests/test_tiled.py:79)."""
    rng = np.random.default_rng(seed)
    codes = _codes(N, B_vec, seed=seed)
    perm, layout = jtiled.build_batch_tiled_order(codes, T, seed=seed)
    codes = codes[:, perm]
    Np = N + pad
    codes_p = np.concatenate([codes, np.zeros((len(B_vec), pad), np.int32)], axis=1)
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, N_pad=Np if pad else None,
              estep_sub_tile=T)
    cj, ct = JConfig(**kw), TConfig(**kw)
    Z = np.zeros((d, Np), np.float32)
    Z[:, :N] = rng.normal(size=(d, N))
    R = np.zeros((K, Np), np.float32)
    R[:, :N] = rng.uniform(0.01, 1.0, size=(K, N))
    R[:, :N] /= R[:, :N].sum(axis=0, keepdims=True)
    counts = np.concatenate(
        [np.bincount(codes[c], minlength=b) for c, b in enumerate(B_vec)]).astype(np.float32)
    Y = np.asarray(jops.l2_normalize_columns(jnp.asarray(rng.normal(size=(d, K)), jnp.float32)))
    lamb = np.concatenate([[0.0], np.ones(cj.B)]).astype(np.float32)
    return cj, ct, layout, Z, R, codes_p, counts, lamb, Y


@pytest.mark.parametrize(
    "B_vec,pad,drop,estimate",
    [((3,), 0, False, False), ((3,), 96, False, True), ((2, 3), 0, False, False),
     ((2, 3), 64, False, True), ((3,), 0, True, False), ((2, 3), 0, True, True)],
)
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_tiled_mstep_matches_jax(B_vec, pad, drop, estimate, impl):
    cj, ct, layout, Z, R, codes, counts, lamb, Y = _ridge_problem(
        4000, 6, 7, B_vec, 128, seed=5 + pad, pad=pad)
    if drop:
        # batch 0 rare in cluster 0: dropped under the cutoff
        R[0] = np.where(codes[0] == 0, 1e-7, R[0])
        cj = dataclasses.replace(cj, batch_prop_cutoff=0.02)
        ct = dataclasses.replace(ct, batch_prop_cutoff=0.02)
    cj = dataclasses.replace(cj, lambda_estimation=estimate)
    ct = dataclasses.replace(ct, lambda_estimation=estimate, mstep_impl=impl)
    O = np.asarray(jops.compute_O(jnp.asarray(R), jnp.asarray(codes), cj.covariate_offsets, cj.B))
    E = (O.sum(axis=1, keepdims=True) / 4000 * counts[None, :]).astype(np.float32)
    args = (Z, R, O, E, codes, counts, lamb, Y)
    Zj, Yj, Wj = j_moe(cj, *[jnp.asarray(a) for a in args], tiled=layout)
    tiled = ttiled.detect_tiled_layout(codes, 4000, 128)
    Zt, Yt, Wt = moe_correct_ridge(ct, *[_t(a) for a in args], tiled=tiled)
    if drop:
        from harmony_tpu_torch.ops.ridge import compute_masks

        assert not bool(compute_masks(ct, _t(O), _t(counts))[0].all())
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=ATOL)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), atol=Y_ATOL)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=ATOL)
    # the tiled path is the dense path's function (tests/test_tiled.py:113)
    Zd, _, Wd = moe_correct_ridge(dataclasses.replace(ct, mstep_impl="torch"),
                                  *[_t(a) for a in args])
    np.testing.assert_allclose(Zt.numpy(), Zd.numpy(), atol=2e-4)
    np.testing.assert_allclose(Wt.numpy(), Wd.numpy(), atol=2e-4)
