"""The K1 twin (ops.estep.block_update_round) against the JAX round.

Same inputs and the same injected permutation go through
``harmony_tpu.ops.block_update_round``, through the Pallas kernel
``pallas_block_update_round`` in interpret mode, and through the port's
plain twin (and its CUDA wrapper, which on CPU tensors runs the twin).
Tolerances: R atol 1e-5 (dist/sigma scales a 1e-7 product difference by
~10); E/O, k-means error and entropy rtol 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harmony_tpu import ops as jops
from harmony_tpu.config import HarmonyConfig as JConfig
from harmony_tpu.ops.pallas_estep import pallas_block_update_round
from harmony_tpu_torch.config import HarmonyConfig as TConfig
from harmony_tpu_torch.ops import cuda_estep
from harmony_tpu_torch.ops.estep import block_update_round

R_ATOL, SUM_RTOL = 1e-5, 1e-5


def _problem(N, d, K, B_vec, seed, block_size=0.05):
    rng = np.random.default_rng(seed)
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, block_size=block_size)
    cfgj, cfgt = JConfig(**kw), TConfig(**kw)
    Z = np.asarray(jops.l2_normalize_columns(jnp.asarray(rng.normal(size=(d, N)), jnp.float32)))
    Y = np.asarray(jops.l2_normalize_columns(jnp.asarray(rng.normal(size=(d, K)), jnp.float32)))
    codes = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    Pr_b = (np.concatenate([np.bincount(c, minlength=b) for c, b in zip(codes, B_vec)])
            / N).astype(np.float32)
    sigma = rng.uniform(0.08, 0.15, K).astype(np.float32)
    theta = rng.uniform(1.0, 2.0, cfgj.B).astype(np.float32)
    dist = jops.compute_distances(jnp.asarray(Y), jnp.asarray(Z))
    R = jops.initial_assignments(dist, jnp.asarray(sigma))
    E = jops.compute_E(R, jnp.asarray(Pr_b))
    O = jops.compute_O(R, jnp.asarray(codes), cfgj.covariate_offsets, cfgj.B)
    perm = rng.permutation(N).astype(np.int32)
    arrays = [Z, Y, np.asarray(R), np.asarray(E), np.asarray(O), codes, Pr_b,
              sigma, theta, perm]
    return cfgj, cfgt, arrays


def _compare(out, ref):
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=R_ATOL)
    np.testing.assert_allclose(out.E.numpy(), np.asarray(ref.E), rtol=SUM_RTOL, atol=1e-7)
    np.testing.assert_allclose(out.O.numpy(), np.asarray(ref.O), rtol=SUM_RTOL, atol=1e-6)
    np.testing.assert_allclose(float(out.kmeans_error), float(ref.kmeans_error), rtol=SUM_RTOL)
    np.testing.assert_allclose(float(out.entropy), float(ref.entropy), rtol=SUM_RTOL)


@pytest.mark.parametrize(
    "N,d,K,B_vec,block_size,sub_tile",
    [
        (600, 8, 5, (3,), 0.05, 128),  # one covariate
        (600, 8, 5, (2, 3), 0.05, 128),  # two covariates
        (500, 6, 4, (2, 2, 3), 0.05, 128),  # three covariates
        (1003, 13, 7, (3, 4), 0.07, 32),  # ragged: 14 blocks of 70, last of 23
        (100, 6, 4, (3,), 0.3, 16),  # last block smaller: 30/30/30/10
        (2560, 8, 5, (3,), 0.05, 128),  # S = 128: exactly one sub-tile
        (2580, 8, 5, (3,), 0.05, 128),  # S = 129: one cell past the sub-tile
    ],
)
def test_twin_matches_jax_round_and_pallas_kernel(N, d, K, B_vec, block_size, sub_tile):
    cfgj, cfgt, a = _problem(N, d, K, B_vec, seed=N + K, block_size=block_size)
    ja = [jnp.asarray(x) for x in a]
    ref = jops.block_update_round(cfgj, *ja)
    pal = pallas_block_update_round(cfgj, *ja, sub_tile=sub_tile, interpret=True)
    out = block_update_round(cfgt, *[torch.as_tensor(np.array(x)) for x in a])
    _compare(out, ref)
    _compare(out, pal)


def test_cuda_wrapper_runs_the_twin_on_cpu_tensors():
    """On CPU tensors the wrapper is the twin carrying R in block order,
    as the kernels write it."""
    _, cfgt, a = _problem(300, 6, 4, (2, 3), seed=1)
    t = [torch.as_tensor(np.array(x)) for x in a]
    before = cuda_estep.block_update_round.launches
    out = cuda_estep.block_update_round(cfgt, *t)
    ref = block_update_round(cfgt, *t, carry=True)
    assert cuda_estep.block_update_round.launches == before
    for x, y in zip(out, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("N,d,K,B_vec,block_size", [(300, 6, 4, (2, 3), 0.05),
                                                   (1003, 13, 7, (3, 4), 0.07)])
def test_carried_order_matches_the_cells_order(N, d, K, B_vec, block_size):
    """Two rounds with R carried in block order, then put back, give the
    rounds in the cells' order exactly; the wrapper on CPU tensors too."""
    _, cfgt, a = _problem(N, d, K, B_vec, seed=N, block_size=block_size)
    t = [torch.as_tensor(np.array(x)) for x in a]
    Z, Y, R, E, O, codes, Pr_b, sigma, theta, p1 = t
    p2 = torch.as_tensor(np.random.default_rng(N).permutation(N))
    rest = (codes, Pr_b, sigma, theta)
    a1 = block_update_round(cfgt, Z, Y, R, E, O, *rest, p1)
    a2 = block_update_round(cfgt, Z, Y, a1.R, a1.E, a1.O, *rest, p2)
    for fn in (functools.partial(block_update_round, carry=True),
               cuda_estep.block_update_round):
        c1 = fn(cfgt, Z, Y, R, E, O, *rest, p1)
        assert torch.equal(c1.R, a1.R[:, p1.long()])
        c2 = fn(cfgt, Z, Y, c1.R, c1.E, c1.O, *rest, p2, order=p1)
        back = torch.empty_like(c2.R).index_copy_(1, p2.long(), c2.R)
        assert torch.equal(back, a2.R)
        for x, y in zip(c2[1:], a2[1:]):
            assert torch.equal(x, y)


def test_cuda_wrapper_rejects_mixed_devices():
    _, cfgt, a = _problem(100, 4, 3, (2,), seed=2)
    t = [torch.as_tensor(np.array(x)) for x in a]
    t[1] = t[1].to("meta")
    with pytest.raises(ValueError, match="Y is on meta"):
        cuda_estep.block_update_round(cfgt, *t)


@pytest.mark.parametrize(
    "K,d,B,ncov,ncells,T,one_wave",
    [
        (100, 50, 10, 1, 25_000, 96, True),  # 500k cells in 20 blocks: two CTAs an SM
        (7, 13, 7, 2, 51, 16, True),  # a tiny block: the least T
        (100, 50, 40, 1, 4_000, 32, True),  # 80k cells, 40 batches: one CTA an SM
        (100, 50, 10, 1, 100_000, 128, False),  # no T fills one wave: the largest
        (300, 100, 10, 1, 25_000, 48, False),  # the largest that fits shared memory
    ],
)
def test_cell_tile_fits_shared_memory(K, d, B, ncov, ncells, T, one_wave):
    """The least T whose CTAs fill an H100's 132 SMs in one wave (two CTAs
    an SM where shared memory allows), else the largest that fits."""
    assert cuda_estep.cell_tile(K, d, B, ncov, ncells, 132) == T
    smem = cuda_estep.assign_smem_bytes(K, d, B, ncov, T)
    assert smem <= 232_448
    per_sm = min(2, 233_472 // (smem + 1024))
    assert (-(-ncells // T) <= per_sm * 132) == one_wave


def test_cell_tile_refuses_shapes_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_estep.cell_tile(1000, 100, 10, 1, 25_000, 132)
