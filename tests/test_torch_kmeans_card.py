"""The Lloyd kernel pair (csrc/kmeans.cu) beside its plain version.

On the CPU: the layouts ``lloyd_plan`` picks, the CTAs' ranges of tiles
``lloyd_grid`` sets, and the wrapper running ``lloyd_round_twin`` for CPU
tensors without counting a launch.

Marked ``card`` (skipped without a CUDA card; on the card run
``python3 -m pytest tests/test_torch_kmeans_card.py -q -m card
--noconftest`` from the root of a checkout): the kernel against the twin on
the same card at a ragged N, with pad cells of garbage, an empty cluster,
two equal centroids, K = 100 and d = 50 at 500k cells and in the 2-byte
dtypes; two calls bit-equal; a ``kmeans_centers`` job counting two
launches a round. The twin's products run in full float32 (TF32 off).
Cells lie near well-separated centres, so the nearest centroid of a cell is
the same whatever the summation order, and only the sums' order differs.
This file imports no JAX.
"""

import pytest
import torch

from harmony_tpu_torch.ops import kmeans as tkmeans

# a sum of the same cells in another order: max |kernel - twin| over
# max(1, max |twin|), float32
SUM_RTOL = 1e-5


@pytest.fixture
def card():
    """The card with TF32 off, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _clustered(N, d, K, seed, dev, dtype=torch.float32, noise=0.05):
    """X (d, N): cells near K random centres; Y (d, K): the centres moved a
    little. Returns (X, Y) in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C = torch.randn(d, K, generator=g, device=dev)
    lab = torch.randint(0, K, (N,), generator=g, device=dev)
    X = C[:, lab] + noise * torch.randn(d, N, generator=g, device=dev)
    Y = C + 0.5 * noise * torch.randn(d, K, generator=g, device=dev)
    return X.to(dtype), Y.to(dtype)


def _gap(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _kernel_and_twin(X, Y, n_valid):
    n0 = tkmeans._lloyd_round.launches
    out = tkmeans._lloyd_round(X, Y, n_valid)
    torch.cuda.synchronize()
    assert tkmeans._lloyd_round.launches - n0 == tkmeans._LAUNCHES
    return out, tkmeans.lloyd_round_twin(X, Y, n_valid)


# ---- on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("K,d,itemsize", [(100, 50, 4), (100, 50, 2), (7, 13, 4),
                                          (150, 50, 4), (300, 50, 4), (300, 100, 4),
                                          (500, 60, 4), (100, 204, 4), (1000, 20, 2)])
def test_lloyd_plan_fits(K, d, itemsize):
    plan = tkmeans.lloyd_plan(K, d, itemsize)
    assert plan is not None and plan.smem <= tkmeans._SMEM_MAX
    assert 8 <= plan.warps <= 14 and plan.warps == plan.halves * plan.pairs
    # the passes' pairs of 8-cluster groups cover K, a pass fewer would not
    assert 16 * plan.pairs * plan.passes >= K
    assert 16 * (14 // plan.halves) * (plan.passes - 1) < K
    # the sums' owners: at most 16 dims a thread, every cluster reached
    assert -(-d // plan.jt) <= 16 and plan.jt <= 32 * plan.warps
    assert plan.tile in (128, 256) and plan.stages in (1, 2)


def test_lloyd_plan_main_shape_and_limits():
    assert tkmeans.lloyd_plan(100, 50, 4) == tkmeans.LloydPlan(
        halves=2, warps=14, pairs=7, passes=1, jt=4, stages=2, acc_smem=True, smem=180_576)
    assert tkmeans.lloyd_plan(100, 205, 4) is None
    assert tkmeans.lloyd_plan(100, 271, 2) is not None
    assert tkmeans.lloyd_plan(100, 272, 2) is None


@pytest.mark.parametrize("n_valid", [0, 1, 255, 256, 257, 500_000, 10_000_000, 270_336_257])
def test_lloyd_grid_covers_the_cells_once(n_valid):
    n_tiles, per, n_blocks = tkmeans.lloyd_grid(n_valid, 256)
    assert n_tiles == -(-n_valid // 256)
    assert 1 <= n_blocks <= tkmeans._MAX_BLOCKS
    # the CTAs' ranges [b * per, (b + 1) * per) cover every tile, none empty
    assert n_blocks * per >= n_tiles and (n_blocks - 1) * per < max(n_tiles, 1)
    assert tkmeans.lloyd_grid(n_valid, 256) == (n_tiles, per, n_blocks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lloyd_round_on_cpu_is_the_twin(dtype):
    X, Y = _clustered(3000, 6, 8, 1, torch.device("cpu"), dtype)
    Y[:, 2] = 50.0  # an empty cluster
    n0 = tkmeans._lloyd_round.launches
    out = tkmeans._lloyd_round(X, Y, 2500)
    assert tkmeans._lloyd_round.launches == n0
    assert out.dtype == dtype
    assert torch.equal(out, tkmeans.lloyd_round_twin(X, Y, 2500))
    assert torch.equal(out[:, 2], Y[:, 2])


def test_lloyd_round_refuses_other_devices():
    X = torch.empty((6, 100), device="meta")
    Y = torch.empty((6, 4), device="meta")
    with pytest.raises(ValueError, match="both on the CPU"):
        tkmeans._lloyd_round(X, Y, 100)


# ---- on the card ------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("N,d,K", [(1037, 50, 100), (300, 13, 7), (20_011, 50, 300),
                                   (5003, 20, 150), (70_000, 50, 100),
                                   # the wide layout: one stage of 128-cell tiles, the
                                   # sums in device memory
                                   (2053, 136, 7), (4099, 88, 300), (6007, 68, 300)])
def test_kernel_matches_twin_ragged(card, N, d, K):
    plan = tkmeans.lloyd_plan(K, d, 4)
    if d in (136, 88, 68):
        assert (plan.tile, plan.stages, plan.acc_smem) == (128, 1, False)
    X, Y = _clustered(N, d, K, N, card)
    out, ref = _kernel_and_twin(X, Y, N)
    assert out.shape == (d, K) and out.dtype == torch.float32
    assert _gap(out, ref) <= SUM_RTOL


@pytest.mark.card
def test_kernel_never_reads_pad_cells(card):
    n_valid, d, K = 10_001, 50, 100
    X, Y = _clustered(n_valid, d, K, 3, card)
    Xp = torch.full((d, n_valid + 4099), float("nan"), device=card)
    Xp[:, n_valid + 7:] = 1e30
    Xp[:, :n_valid] = X
    out_pad, ref = _kernel_and_twin(Xp, Y, n_valid)
    # the same cells with a row stride of n_valid: loads without cp.async
    out, _ = _kernel_and_twin(X.contiguous(), Y, n_valid)
    assert X.stride(0) % 4 != 0
    assert torch.equal(out_pad, out)
    assert torch.isfinite(out_pad).all()
    assert _gap(out_pad, ref) <= SUM_RTOL


@pytest.mark.card
def test_empty_cluster_keeps_its_centroid(card):
    X, Y = _clustered(30_000, 50, 100, 5, card)
    Y[:, 37] = 50.0
    out, ref = _kernel_and_twin(X, Y, 30_000)
    assert torch.equal(out[:, 37], Y[:, 37])
    assert _gap(out, ref) <= SUM_RTOL


@pytest.mark.card
def test_equal_centroids_go_to_the_lowest_k(card):
    X, Y = _clustered(30_000, 50, 100, 6, card)
    Y[:, 90] = Y[:, 12]  # every cell of either takes 12; 90 stays empty
    Y[:, 20] = Y[:, 64]  # across warps: groups 2 and 8 of the pairs 1 and 4
    Y[:, 10] = Y[:, 3]  # within a warp: groups 0 and 1 of pair 0
    out, ref = _kernel_and_twin(X, Y, 30_000)
    for k in (90, 64, 10):
        assert torch.equal(out[:, k], Y[:, k])
    for k in (12, 20, 3):
        assert not torch.equal(out[:, k], Y[:, k])
    assert _gap(out, ref) <= SUM_RTOL


@pytest.mark.card
def test_main_shape_500k_and_bit_equal(card):
    X, Y = _clustered(500_000, 50, 100, 7, card)
    out, ref = _kernel_and_twin(X, Y, 500_000)
    assert _gap(out, ref) <= SUM_RTOL
    assert torch.equal(tkmeans._lloyd_round(X, Y, 500_000), out)
    # unclustered cells, where near ties abound: two calls give the same bits
    g = torch.Generator(device=card).manual_seed(8)
    Xr = torch.randn(50, 500_000, generator=g, device=card)
    Yr = Xr[:, :100].clone()
    first = tkmeans._lloyd_round(Xr, Yr, 500_000)
    assert torch.equal(tkmeans._lloyd_round(Xr, Yr, 500_000), first)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_two_byte_dtypes_within_an_ulp_of_the_twin(card, dtype):
    X, Y = _clustered(100_003, 50, 100, 9, card, dtype)
    Y[:, 5] = 50.0
    out, ref = _kernel_and_twin(X, Y, 100_003)
    assert out.dtype == dtype and torch.equal(out[:, 5], Y[:, 5])
    # the float sums in another order round to the same value or the next
    ulp = torch.finfo(dtype).eps * ref.float().abs()
    assert ((out.float() - ref.float()).abs() <= ulp).all()


@pytest.mark.card
def test_kmeans_centers_launches_two_a_round(card):
    X, _ = _clustered(50_000, 50, 100, 10, card)
    X = torch.nn.functional.normalize(X, dim=0)
    g = torch.Generator(device=card).manual_seed(11)
    idx = torch.randint(0, 50_000, (100,), generator=g, device=card)
    uniforms = [torch.rand(50_000, generator=g, device=card).clamp(min=1e-30)
                for _ in range(100)]
    n0 = tkmeans._lloyd_round.launches
    Y = tkmeans.kmeans_centers(X, 100, init_idx=idx, uniforms=uniforms)
    torch.cuda.synchronize()
    assert tkmeans._lloyd_round.launches - n0 == tkmeans._LAUNCHES * 10
    assert Y.shape == (50, 100) and torch.isfinite(Y).all()
    assert torch.equal(tkmeans.kmeans_centers(X, 100, init_idx=idx, uniforms=uniforms), Y)
