"""The bf16 product form (ROADMAP B.1) of harmony_tpu_torch's rotate kernels.

A bfloat16 or float16 engine under the resolved 'bfloat16' precision
(``HarmonyConfig.bf16_products``) forms K6's and K11's g = Y^T Zn and K10's
W R on operands rounded to bf16, as the JAX package's bf16 pass does on a
TPU (harmony_tpu/engine.py:783-798); the kernels run the products on the
tensor cores, the plain versions here (their twins) as fp32 products of
the rounded operands. On the CPU the wrappers run those twins.

* The twins against a float64 product of the same bf16-rounded operands:
  g (K6's G, K11's and K10's recomputation) and the correction within
  fp32 summation error.
* The switch: ``bf16_products`` exactly for a reduced-precision engine
  under 'bfloat16' ('auto' resolving to it); a reduced engine under
  'float32' or 'highest', and every float32 engine, keep the fp32 products
  bit for bit (the same G, R and Z_corr as the direct fp32 formulas), and
  the product form does move g.
* The bf16 engine with the product form (precision set explicitly) still
  within the JAX bf16 engine's bounds (test_torch_bf16_engine.py's).
* The operand tables the kernels read (``y_bf16``, ``w_bf16``) and the
  product forms' launch plans (their shared-memory mirrors).
"""

import dataclasses

import numpy as np
import pytest
import torch

from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate, rotate

from test_torch_bf16_engine import _compare, _layouts, _rotate_rounds, _states
from test_torch_virtual import _setup

BF = torch.bfloat16


def _problem(dtype="bfloat16", precision="bfloat16", N=5000, d=12, K=9, B_vec=(3,), seed=0):
    """A rotate problem on the stats-carrying route at the engine dtype and
    precision given, K6's twin's Zn and G, seeded penalty tables and betas:
    (cfg, Y, sigma, Pr_b, Z_raw, codes_pad, Zn, G, pen, blkmap, W,
    tile_joint, layout tile, Z_orig)."""
    rng = np.random.default_rng(seed)
    cfg = tconfig.finalize_engine_config(tconfig.HarmonyConfig(
        N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, shuffle_mode="rotate", dtype=dtype,
        matmul_precision=precision))
    Np = cfg.Np
    dt = getattr(torch, dtype)
    Z = torch.zeros(d, Np, dtype=dt)
    Z[:, :N] = torch.from_numpy(rng.normal(size=(d, N)) * 2).to(dt)
    codes = torch.zeros(len(B_vec), Np, dtype=torch.int32)
    for c, b in enumerate(B_vec):
        codes[c, :N] = torch.from_numpy(rng.integers(0, b, N).astype(np.int32))
    codes_pad = rotate.make_codes_pad(cfg, codes)
    Zn0 = Z[:, :N].double()
    Y = Zn0[:, rng.choice(N, K, replace=False)] + 0.1 * torch.from_numpy(rng.normal(size=(d, K)))
    Y = (Y / Y.norm(dim=0)).float()
    sigma = torch.full((K,), 0.1)
    Pr_b = torch.full((cfg.B,), 1.0 / cfg.B)
    Zn, tO, O, E, G = rotate.reassign(cfg, Y, sigma, Pr_b, Z, codes_pad)
    nb = len(rotate.block_sizes(cfg)[0])
    pen = torch.from_numpy(0.5 + rng.random((nb, K, cfg.B))).float()
    blkmap = rotate.block_of_tiles(cfg, 3, "cpu")
    tile = 128
    tj = rng.integers(0, 3, Np // tile).astype(np.int32)
    W = torch.from_numpy(rng.normal(size=(4, d, K)) * 0.3).float()
    W[3] = 0.0
    Zo = torch.from_numpy(rng.normal(size=(d, Np))).to(dt)
    return cfg, Y, sigma, Pr_b, Z, codes_pad, Zn, G, pen, blkmap, W, tj, tile, Zo


def _bf64(t):
    return t.to(BF).double()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_product_twins_match_float64_of_rounded_operands(dtype):
    (cfg, Y, sigma, Pr_b, Z, codes_pad, Zn, G, pen, blkmap, W, tj, tile,
     Zo) = _problem(dtype)
    assert cfg.bf16_products
    # K6's G: the bf16-rounded Y^T and Zn, products exact, sums in fp32
    g64 = (_bf64(Y.t()) @ _bf64(Zn)).t()
    assert G.dtype == torch.float32
    np.testing.assert_allclose(G.double().numpy(), g64.numpy(), rtol=0, atol=1e-6)
    # K11's and K10's recomputation forms the same g from Y and Zn
    vargs = (Y, sigma, pen, blkmap, Zn, codes_pad)
    R_own = rotate.materialize_r(cfg, *vargs)
    R_G = rotate._virtual_r(cfg, *vargs, G=G)[:, : cfg.Np]
    np.testing.assert_allclose(R_own.numpy(), R_G.numpy(), rtol=0, atol=1e-6)
    # K10's correction: the bf16-rounded betas and R, products exact, sums
    # in fp32 (Z_orig upcast, so the fp32 result is compared unrounded)
    Zc = rotate.virtual_correction(cfg, W, tj, tile, *vargs, Zo.float(), G)
    R = rotate._virtual_r(cfg, *vargs, G=G)
    Wt = _bf64(W)[torch.as_tensor(tj).long()]  # (tiles, d, K)
    Rt = _bf64(R).reshape(cfg.K, -1, tile).permute(1, 0, 2)  # (tiles, K, tile)
    corr = torch.bmm(Wt, Rt).permute(1, 0, 2).reshape(cfg.d, -1)
    np.testing.assert_allclose(Zc.double().numpy(), (Zo.double() - corr).numpy(), rtol=0,
                               atol=1e-5)
    # in the storage dtype: one rounding of that value
    Zs = rotate.virtual_correction(cfg, W, tj, tile, *vargs, Zo, G)
    assert Zs.dtype == Zo.dtype
    assert torch.equal(Zs, Zc.to(Zo.dtype))


@pytest.mark.parametrize("dtype,precision,on", [
    ("bfloat16", "bfloat16", True), ("float16", "bfloat16", True), ("bfloat16", "auto", True),
    ("float16", "auto", True), ("bfloat16", "float32", False), ("float16", "highest", False),
    ("float32", "bfloat16", False), ("float32", "auto", False), ("float32", "float32", False)])
def test_fp32_products_unless_a_reduced_engine_takes_the_bf16_pass(dtype, precision, on):
    (cfg, Y, sigma, Pr_b, Z, codes_pad, Zn, G, pen, blkmap, W, tj, tile,
     Zo) = _problem(dtype, precision)
    assert cfg.bf16_products == on
    fp32_G = (Y.t() @ Zn).t()
    vargs = (Y, sigma, pen, blkmap, Zn, codes_pad)
    R = rotate._virtual_r(cfg, *vargs, G=G)
    Zc = rotate.virtual_correction(cfg, W, tj, tile, *vargs, Zo, G)
    if on:
        # the bf16 pass moves g (by up to ~2^-8 of |y||zn|) and the correction
        assert not torch.equal(G, fp32_G)
        assert float((G - fp32_G).abs().max()) < 2.0 ** -7
        return
    # the fp32 products bit for bit: the formulas the port ran before the
    # product form (K6's G, K11's g from Y and Zn, K10's W R)
    assert torch.equal(G, fp32_G.contiguous())
    g3 = rotate._gram_tiles(Y.t(), Zn.reshape(cfg.d, -1, cfg.estep_sub_tile))
    assert torch.equal(g3.reshape(cfg.K, -1), (Y.t() @ Zn))
    ref = cuda_ridge.tiled_correction_twin(W, tj, R, Zo.float(), tile).to(Zo.dtype)
    assert torch.equal(Zc, ref)


def test_bf16_engine_with_the_product_form_matches_jax_bf16_engine():
    cj, ct, jd, td, Zt, hj, ht, Y0 = _setup((3,), 4096, 4096)
    cj = dataclasses.replace(cj, dtype="bfloat16")
    ct = dataclasses.replace(ct, dtype="bfloat16", matmul_precision="bfloat16")
    assert ct.bf16_products
    sj, st = _states(cj, ct, jd, td, Zt, hj, ht, Y0)
    tiled_j, tiled_t = _layouts(cj, ct, sj, st)
    sj, st = _rotate_rounds(cj, ct, sj, st, tiled_j, tiled_t)
    assert st.virt_pen is not None
    _compare(sj, st, cj, ct, tengine.materialize_r(ct, st).R)


@pytest.mark.parametrize("d,K", [(12, 9), (50, 100), (13, 300), (300, 32)])
def test_operand_tables_and_plans_of_the_product_form(d, K):
    rng = np.random.default_rng(d + K)
    Y = torch.from_numpy(rng.normal(size=(d, K))).float()
    K8 = -(-K // 8) * 8
    Yb = cuda_rotate.y_bf16(Y, K8)
    S = cuda_rotate.mma_stride(d)
    # rows of d rounded up to 16 plus 8 values: 4 mod 8 words
    assert Yb.shape == (K8, S) and Yb.dtype == BF and (S // 2) % 8 == 4
    assert torch.equal(Yb[:K, :d], Y.t().to(BF))
    assert not Yb[K:].any() and not Yb[:, d:].any()
    W = torch.from_numpy(rng.normal(size=(3, d, K))).float()
    Wb = cuda_rotate.w_bf16(W)
    assert Wb.shape == (3, -(-d // 16) * 16, cuda_rotate.mma_stride(K))
    assert torch.equal(Wb[:, :d, :K], W.to(BF))
    assert not Wb[:, d:].any() and not Wb[:, :, K:].any()
    # the product forms' tables: K6 stages Y^T and the piece in bf16 rows
    # in place of the fp32 form's Y (d x K8 floats)
    for splits in (1, 2, 4):
        diff = (cuda_rotate.reassign_smem_bytes(K, d, 10, 1, splits, True)
                - cuda_rotate.reassign_smem_bytes(K, d, 10, 1, splits))
        assert diff == 4 * (K8 * S // 2 + 32 * S - d * K8)
    p32 = cuda_rotate.materialize_r_plan(K, d, 10, 1)
    pmm = cuda_rotate.materialize_r_plan(K, d, 10, 1, True)
    assert pmm.kj in (p32.kj, 0) and pmm.smem <= cuda_rotate._SMEM_MAX
    assert pmm.smem == cuda_rotate.materialize_r_smem_bytes(K, d, 10, 1, pmm.kj, pmm.ys_shared,
                                                            True)
    # K10's groups stage bf16 betas (d rounded up to 16 rows of
    # mma_stride(K)) in place of (K x ceil4(d)) floats
    v32 = cuda_rotate.virtual_plan(K, d, 10, 1, 30)
    vmm = cuda_rotate.virtual_plan(K, d, 10, 1, 30, True)
    assert (v32 is None) == (vmm is None)
    if vmm is not None:
        groups, smem = vmm
        assert smem == cuda_rotate.virtual_smem_bytes(K, d, 10, 1, 30, groups, True)
