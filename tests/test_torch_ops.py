"""harmony_tpu_torch ops against harmony_tpu ops on identical inputs.

Elementwise and small-reduction ops agree to rtol 1e-6 (fp32, another
summation order); k-means seeding picks the same cells when fed the draws
``jax.random`` made; a Lloyd round agrees to atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from harmony_tpu import ops as jops
from harmony_tpu.config import HarmonyConfig as JConfig
from harmony_tpu.ops import kmeans as jkmeans
from harmony_tpu.ops.stats import one_hot_design as j_one_hot_design
from harmony_tpu_torch import ops as tops
from harmony_tpu_torch.config import HarmonyConfig as TConfig
from harmony_tpu_torch.ops import estep as testep, kmeans as tkmeans

RTOL = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _inputs(N=120, d=6, K=5, B_vec=(3,), seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(d, N)).astype(np.float32)
    Z[:, 3] = 0.0  # a zero column exercises the guards
    Zn = np.asarray(jops.l2_normalize_columns(jnp.asarray(Z)))
    Y = np.asarray(jops.l2_normalize_columns(
        jnp.asarray(rng.normal(size=(d, K)).astype(np.float32))))
    codes = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    sigma = rng.uniform(0.05, 0.2, K).astype(np.float32)
    B = sum(B_vec)
    theta = rng.uniform(0.5, 2.0, B).astype(np.float32)
    Pr_b = np.concatenate([np.bincount(c, minlength=b) for c, b in zip(codes, B_vec)]) / N
    return Z, Zn, Y, codes, sigma, theta, Pr_b.astype(np.float32)


def test_normalize_matches():
    Z = _inputs()[0]
    np.testing.assert_allclose(
        tops.l2_normalize_columns(_t(Z)).numpy(),
        np.asarray(jops.l2_normalize_columns(jnp.asarray(Z))), rtol=RTOL)
    A = np.abs(Z)
    np.testing.assert_allclose(
        tops.l1_normalize_columns(_t(A)).numpy(),
        np.asarray(jops.l1_normalize_columns(jnp.asarray(A))), rtol=RTOL)


@pytest.mark.parametrize("B_vec", [(3,), (2, 4)])
def test_assign_and_stats_match(B_vec):
    _, Zn, Y, codes, sigma, theta, Pr_b = _inputs(B_vec=B_vec)
    cfgj = JConfig(N=Zn.shape[1], d=Zn.shape[0], K=Y.shape[1], B=sum(B_vec), B_vec=B_vec)
    offs = cfgj.covariate_offsets
    dj = jops.compute_distances(jnp.asarray(Y), jnp.asarray(Zn))
    dt = tops.compute_distances(_t(Y), _t(Zn))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL, atol=1e-7)
    Rj = jops.initial_assignments(dj, jnp.asarray(sigma))
    Rt = tops.initial_assignments(_t(np.asarray(dj)), _t(sigma))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=RTOL, atol=1e-12)
    R = np.asarray(Rj)
    np.testing.assert_array_equal(
        tops.one_hot_design(_t(codes), offs, cfgj.B).numpy(),
        np.asarray(j_one_hot_design(jnp.asarray(codes), offs, cfgj.B)))
    np.testing.assert_allclose(
        tops.compute_O(_t(R), _t(codes), offs, cfgj.B).numpy(),
        np.asarray(jops.compute_O(jnp.asarray(R), jnp.asarray(codes), offs, cfgj.B)),
        rtol=RTOL)
    np.testing.assert_allclose(
        tops.compute_E(_t(R), _t(Pr_b)).numpy(),
        np.asarray(jops.compute_E(jnp.asarray(R), jnp.asarray(Pr_b))), rtol=RTOL)
    pen = np.random.default_rng(1).uniform(0.5, 2, (Y.shape[1], cfgj.B)).astype(np.float32)
    np.testing.assert_allclose(
        tops.penalty_for_cells(_t(pen), _t(codes), offs).numpy(),
        np.asarray(jops.penalty_for_cells(jnp.asarray(pen), jnp.asarray(codes), offs)),
        rtol=RTOL)


@pytest.mark.parametrize("B_vec", [(3,), (2, 4)])
def test_objectives_match(B_vec):
    _, Zn, Y, codes, sigma, theta, Pr_b = _inputs(B_vec=B_vec, N=300)
    K, N, B = Y.shape[1], Zn.shape[1], sum(B_vec)
    cfgj = JConfig(N=N, d=Zn.shape[0], K=K, B=B, B_vec=B_vec)
    cfgt = TConfig(N=N, d=Zn.shape[0], K=K, B=B, B_vec=B_vec)
    dist = np.asarray(jops.compute_distances(jnp.asarray(Y), jnp.asarray(Zn)))
    R = np.array(jops.initial_assignments(jnp.asarray(dist), jnp.asarray(sigma)))
    R[:, 5] = 0.0  # x log x at 0
    O = np.asarray(jops.compute_O(jnp.asarray(R), jnp.asarray(codes), cfgj.covariate_offsets, B))
    E = np.asarray(jops.compute_E(jnp.asarray(R), jnp.asarray(Pr_b)))
    j = jops.compute_objective(cfgj, *map(jnp.asarray, (R, dist, O, E, codes, sigma, theta)))
    t = tops.compute_objective(cfgt, *map(_t, (R, dist, O, E, codes, sigma, theta)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL)
    kerr, ent = np.float32(12.5), np.float32(-3.25)
    j = jops.objective_from_stats(cfgj, jnp.float32(kerr), jnp.float32(ent),
                                  *map(jnp.asarray, (O, E, sigma, theta)))
    t = testep.objective_from_stats(cfgt, _t(kerr), _t(ent), *map(_t, (O, E, sigma, theta)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(float(a), float(b), rtol=RTOL)


@pytest.mark.parametrize("N,block_size", [(600, 0.05), (100, 0.3), (25, 0.05), (1003, 0.07)])
def test_make_blocks_matches(N, block_size):
    cfgj = JConfig(N=N, d=2, K=2, B=1, B_vec=(1,), block_size=block_size)
    cfgt = TConfig(N=N, d=2, K=2, B=1, B_vec=(1,), block_size=block_size)
    perm = np.random.default_rng(N).permutation(N).astype(np.int32)
    ij, vj = jops.make_blocks(cfgj, jnp.asarray(perm))
    it, vt = tops.make_blocks(cfgt, _t(perm))
    assert it.dtype == torch.int64
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _jax_seed_draws(key, K, n_valid):
    """The draws jax's _seed_centroids makes from ``key`` (kmeans.py:33-55)."""
    k0, k1 = jax.random.split(key)
    init_idx = jax.random.randint(k0, (K,), 0, n_valid)
    tiny = jnp.finfo(jnp.float32).tiny
    u = [jax.random.uniform(kk, (n_valid,), minval=tiny, maxval=1.0)
         for kk in jax.random.split(k1, K)]
    return np.asarray(init_idx), [np.asarray(x) for x in u]


@pytest.mark.parametrize("seed", [0, 3])
def test_seed_centroids_pick_the_same_cells(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(5, 200)).astype(np.float32)
    X = np.asarray(jops.l2_normalize_columns(jnp.asarray(X)))
    key = jax.random.PRNGKey(seed)
    K = 7
    Yj = np.asarray(jkmeans._seed_centroids(key, jnp.asarray(X), K, 200))
    idx, u = _jax_seed_draws(key, K, 200)
    Yt = tkmeans._seed_centroids(_t(X), K, 200, init_idx=_t(idx), uniforms=[_t(a) for a in u])
    np.testing.assert_array_equal(Yt.numpy(), Yj)
    # and the full kmeans_centers (seed + 10 Lloyd rounds) agrees
    Cj = np.asarray(jkmeans.kmeans_centers(key, jnp.asarray(X), K))
    Ct = tkmeans.kmeans_centers(_t(X), K, init_idx=_t(idx), uniforms=[_t(a) for a in u])
    np.testing.assert_allclose(Ct.numpy(), Cj, atol=1e-6)


def test_seed_centroids_from_generator_are_distinct():
    X = torch.nn.functional.normalize(torch.randn(4, 50, generator=torch.Generator().manual_seed(1)), dim=0)
    g = torch.Generator().manual_seed(0)
    Y = tkmeans._seed_centroids(X, 10, 50, generator=g)
    assert torch.unique(Y, dim=1).shape[1] == 10


def test_lloyd_round_matches():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(6, 300)).astype(np.float32)
    Y = X[:, rng.choice(300, 8, replace=False)]
    Y[:, 0] = 50.0  # an empty cluster keeps its centroid
    Yj = np.asarray(jkmeans._lloyd_round(jnp.asarray(X), jnp.asarray(Y), 300))
    Yt = tkmeans._lloyd_round(_t(X), _t(Y), 300)
    np.testing.assert_allclose(Yt.numpy(), Yj, atol=1e-6)
    np.testing.assert_array_equal(Yt.numpy()[:, 0], Y[:, 0])
