"""The M-step of harmony_tpu_torch against harmony_tpu.

* The K4/K5 twins against ``pallas_moments``/``pallas_correction`` in
  interpret mode: rtol 1e-5.
* ``moe_correct_ridge`` (Z_corr, Y_new, W) against JAX's with the kernel
  branch ('kernel' here, 'pallas' there) and the dense path ('torch' here,
  'xla' there), for fixed and estimated lambda, two covariates, a batch
  dropped under ``batch_prop_cutoff``, and each solver: atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harmony_tpu import ops as jops
from harmony_tpu.config import HarmonyConfig as JConfig
from harmony_tpu.ops.pallas_ridge import pallas_correction, pallas_moments
from harmony_tpu.ops.ridge import compute_masks as j_compute_masks
from harmony_tpu_torch.config import HarmonyConfig as TConfig
from harmony_tpu_torch.ops import cuda_ridge
from harmony_tpu_torch.ops.ridge import compute_masks, moe_correct_ridge

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


@pytest.mark.parametrize("N,d,K,B", [(300, 6, 4, 3), (1003, 13, 7, 3), (257, 9, 5, 1)])
def test_kernel_twins_match_pallas(N, d, K, B):
    rng = np.random.default_rng(N)
    R = rng.dirichlet(np.ones(K), N).T.astype(np.float32)
    Z = rng.normal(size=(d, N)).astype(np.float32)
    codes = rng.integers(0, B, N).astype(np.int32)
    W = (rng.normal(size=(K, B, d)) * 0.1).astype(np.float32)
    cfg = JConfig(N=N, d=d, K=K, B=B, B_vec=(B,), estep_sub_tile=128)
    oh = jnp.asarray(np.eye(B, dtype=np.float32)[codes])
    Mj = np.asarray(pallas_moments(cfg, jnp.asarray(R), jnp.asarray(Z), oh, interpret=True))
    Cj = np.asarray(pallas_correction(cfg, jnp.asarray(W), jnp.asarray(R), jnp.asarray(Z), oh,
                                      interpret=True))
    before = (cuda_ridge.moments.launches, cuda_ridge.correction.launches)
    Mt = cuda_ridge.moments(_t(R), _t(Z), _t(codes), B)
    Ct = cuda_ridge.correction(_t(W), _t(R), _t(Z), _t(codes))
    assert (cuda_ridge.moments.launches, cuda_ridge.correction.launches) == before
    np.testing.assert_allclose(Mt.numpy(), Mj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Ct.numpy(), Cj, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(Mt.numpy(), cuda_ridge.moments_twin(
        _t(R), _t(Z), _t(codes), B).numpy())


def test_kernel_wrappers_check_their_inputs():
    R, Z = torch.rand(3, 10), torch.rand(4, 10)
    with pytest.raises(TypeError, match="int32"):
        cuda_ridge.moments(R, Z, torch.zeros(10, dtype=torch.int64), 2)
    with pytest.raises(TypeError, match="float32"):
        cuda_ridge.moments(R.double(), Z, torch.zeros(10, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ridge.correction(torch.rand(3, 2, 4).transpose(0, 1), R, Z,
                              torch.zeros(10, dtype=torch.int32))
    with pytest.raises(ValueError, match="disagree"):
        cuda_ridge.moments(R, Z[:, :9].contiguous(), torch.zeros(10, dtype=torch.int32), 2)


def _ridge_problem(N, d, K, B_vec, seed, rare=False):
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    Z = rng.normal(size=(d, N)).astype(np.float32)
    logits = rng.normal(size=(K, N)) * 2
    if rare:
        # batch 0 of covariate 0 sits almost only in cluster 0, so its
        # average responsibility elsewhere falls under the cutoff
        logits[:, codes[0] == 0] = -30.0
        logits[0, codes[0] == 0] = 30.0
    R = np.exp(logits - logits.max(0))
    R = (R / R.sum(0)).astype(np.float32)
    B = sum(B_vec)
    O = np.asarray(jops.compute_O(jnp.asarray(R), jnp.asarray(codes),
                                  JConfig(N=N, d=d, K=K, B=B, B_vec=B_vec).covariate_offsets, B))
    sizes = np.concatenate([np.bincount(c, minlength=b) for c, b in zip(codes, B_vec)])
    E = (R.sum(1, keepdims=True) * (sizes / N)[None, :]).astype(np.float32)
    lamb = np.concatenate([[0.0], rng.uniform(0.5, 2.0, B)]).astype(np.float32)
    Y = rng.normal(size=(d, K)).astype(np.float32)
    return [Z, R, O, E, codes, sizes.astype(np.float32), lamb, Y]


@pytest.mark.parametrize(
    "B_vec,lambda_estimation,impl,cutoff,solver",
    [
        ((4,), False, "kernel", 1e-5, "auto"),
        ((4,), True, "kernel", 1e-5, "auto"),
        ((4,), False, "torch", 1e-5, "auto"),
        ((4,), True, "torch", 1e-5, "auto"),
        ((4,), False, "kernel", 0.05, "auto"),  # a dropped batch
        ((4,), True, "torch", 0.05, "auto"),  # a dropped batch
        ((3, 2), False, "torch", 1e-5, "auto"),  # two covariates
        ((3, 2), True, "kernel", 0.05, "auto"),  # two covariates: dense path
        ((4,), False, "torch", 1e-5, "cholesky"),
        ((4,), False, "torch", 1e-5, "solve"),
        ((4,), False, "kernel", 1e-5, "arrowhead"),
        ((3, 2), False, "torch", 1e-5, "solve"),
    ],
)
def test_moe_correct_ridge_matches_jax(B_vec, lambda_estimation, impl, cutoff, solver):
    N, d, K = 400, 7, 5
    a = _ridge_problem(N, d, K, B_vec, seed=len(B_vec) * 10 + int(cutoff > 1e-3),
                       rare=cutoff > 1e-3)
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, alpha=0.2,
              batch_prop_cutoff=cutoff, lambda_estimation=lambda_estimation,
              ridge_solver=solver)
    cfgj = JConfig(**kw, mstep_impl="pallas" if impl == "kernel" else "xla",
                   estep_sub_tile=128)
    cfgt = TConfig(**kw, mstep_impl=impl)
    if cutoff > 1e-3:
        keep, _ = compute_masks(cfgt, _t(a[2]), _t(a[5]))
        assert not bool(keep.all())  # the cutoff really drops a batch
    Zj, Yj, Wj = jops.moe_correct_ridge(cfgj, *map(jnp.asarray, a))
    Zt, Yt, Wt = moe_correct_ridge(cfgt, *map(_t, a))
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=ATOL)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), atol=ATOL)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=ATOL)


def test_compute_masks_matches():
    a = _ridge_problem(300, 4, 6, (3, 2), seed=5, rare=True)
    kw = dict(N=300, d=4, K=6, B=5, B_vec=(3, 2), batch_prop_cutoff=0.05)
    kj, aj = j_compute_masks(JConfig(**kw), jnp.asarray(a[2]), jnp.asarray(a[5]))
    kt, at = compute_masks(TConfig(**kw), _t(a[2]), _t(a[5]))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_arrowhead_needs_one_covariate():
    a = _ridge_problem(100, 4, 3, (2, 2), seed=1)
    cfg = TConfig(N=100, d=4, K=3, B=4, B_vec=(2, 2), ridge_solver="arrowhead",
                  mstep_impl="torch")
    with pytest.raises(ValueError, match="single covariate"):
        moe_correct_ridge(cfg, *map(_t, a))
    cfg = dataclasses.replace(cfg, ridge_solver="lu")
    with pytest.raises(ValueError, match="unknown ridge_solver"):
        moe_correct_ridge(cfg, *map(_t, a))
