"""K3 reading the phase's distances, and the launch plans of the K3 and K6
redesigns.

* K3's plain version (``permute_phase.materialize``) fed the head's G
  equals, within 1e-6, the plain version that forms the distances from Y
  and Z, with and without the fused moments, with and without pad cells.
* It matches the JAX package's ``_permute_materialize_kernel``
  (``pallas_permute_phase`` in interpret mode), R and the fused moments,
  at the bounds of ``tests/test_torch_permute_phase.py`` (R atol 2e-5,
  moments to 1e-5 of their max).
* The fused phase hands the rounds' G to K3, and ``materialize`` raises
  ``ValueError`` for a G of the wrong shape or device.
* The launch plans, over K in {7, 100, 256, 300}, d in {13, 50, 100} and
  B in {3, 10, 40, 400}: K3's cells a step, its shared memory against the
  layout in ``csrc/permute_phase.cu``, its moment tiles and cell groups;
  K6's cell splits and shared memory against ``csrc/rotate.cu``, and its
  reduce's column chunks. A plan fits the 232,448 bytes a CTA may use, or
  the wrapper refuses it with a message that names the shape.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harmony_tpu.ops import tiled as jtiled
from harmony_tpu.ops.pallas_estep import pallas_permute_phase
from harmony_tpu.ops.pallas_rotate import MomentsSpec as JMomentsSpec
from harmony_tpu_torch.ops import cuda_permute, cuda_rotate
from harmony_tpu_torch.ops import permute_phase as tpp
from harmony_tpu_torch.ops.ridge import full_tile_joint

from test_torch_permute_phase import _problem as _permute_problem

SMEM_MAX = 232_448
TOL = 1e-6
R_ATOL, STAT_REL = 2e-5, 1e-5


def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tiled_problem(N, B_vec, N_pad, seed, tile=128, K=6):
    """A fused-phase problem on a batch-tiled order, with its moments spec
    for both packages (as tests/test_torch_permute_phase.py builds it)."""
    rng = np.random.default_rng(seed)
    raw = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    perm, _ = jtiled.build_batch_tiled_order(raw, tile, seed=1)
    Np = N_pad or N
    codes = np.zeros((len(B_vec), Np), np.int32)
    codes[:, :N] = raw[:, perm]
    cj, ct, args = _permute_problem(N, K, B_vec, N_pad=N_pad, seed=seed, rounds=2, codes=codes)
    layout = jtiled.detect_tiled_layout(codes, N, tile)
    Z_orig = np.zeros((8, Np), np.float32)
    Z_orig[:, :N] = rng.normal(size=(8, N)) * 2
    nj = layout.joint_codes.shape[1]
    spec_t = tpp.MomentsSpec(Z_orig=_t(Z_orig), tile_joint=full_tile_joint(ct, layout),
                             n_joint=nj, tile=tile)
    sub = 256
    Npt = -(-Np // sub) * sub
    tj = np.full(Npt // tile, nj, np.int32)
    tj[: len(layout.tile_joint)] = layout.tile_joint
    spec_j = JMomentsSpec(Z_orig_pad=jnp.asarray(np.pad(Z_orig, ((0, 0), (0, Npt - Np)))),
                          tile_joint=jnp.asarray(tj), n_joint=nj, tile=tile)
    return cj, ct, args, spec_t, spec_j


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("N_pad", [None, 2560])
def test_k3_twin_reading_g_matches_forming_the_distances(moments, N_pad):
    _, ct, args, spec, _ = _tiled_problem(2500, (2, 3), N_pad, seed=21)
    targs = [_t(a) for a in args]
    rr = tpp.permute_rounds(ct, *targs)
    assert rr.G.shape == (ct.N, 6)
    sp = spec if moments else None
    R_g, M_g = tpp.materialize(ct, targs[0], targs[1], targs[4], targs[6], rr.tables, sp,
                               G=rr.G)
    R_yz, M_yz = tpp.materialize(ct, targs[0], targs[1], targs[4], targs[6], rr.tables, sp)
    np.testing.assert_allclose(R_g.numpy(), R_yz.numpy(), rtol=0, atol=TOL)
    assert not R_g[:, ct.N:].any()
    assert (M_g is None) == (not moments)
    if moments:
        assert _rel(M_g, M_yz) <= TOL


@pytest.mark.parametrize("moments", [False, True])
def test_k3_twin_reading_g_matches_jax_materialize(moments):
    cj, ct, args, spec_t, spec_j = _tiled_problem(2500, (3,), None, seed=22)
    targs = [_t(a) for a in args]
    ref = pallas_permute_phase(cj, *[jnp.asarray(a) for a in args], sub_tile=256,
                               interpret=True, moments=spec_j if moments else None)
    rr = tpp.permute_rounds(ct, *targs)
    R, M = tpp.materialize(ct, targs[0], targs[1], targs[4], targs[6], rr.tables,
                           spec_t if moments else None, G=rr.G)
    np.testing.assert_allclose(R.numpy(), np.asarray(ref.R), atol=R_ATOL, rtol=0)
    if moments:
        assert _rel(M, ref.M) <= STAT_REL


def test_fused_phase_hands_the_rounds_distances_to_k3(monkeypatch):
    _, ct, args = _permute_problem(900, 5, (2, 3), seed=6, rounds=2)
    targs = [_t(a) for a in args]
    seen = {}
    real = tpp.materialize

    def spy(*a, **kw):
        seen["G"] = kw["G"] if "G" in kw else a[7]
        return real(*a, **kw)

    monkeypatch.setattr(tpp, "materialize", spy)
    for phase in (tpp.permute_phase, cuda_permute.permute_phase):
        seen.clear()
        out = phase(ct, *targs)
        assert torch.equal(seen["G"], tpp.phase_head(ct, targs[0], targs[1]))
        assert torch.equal(out.R, real(ct, targs[0], targs[1], targs[4], targs[6],
                                       tpp.permute_rounds(ct, *targs).tables, G=seen["G"])[0])


def test_materialize_refuses_a_wrong_g():
    _, ct, args = _permute_problem(900, 5, (2, 3), seed=7, rounds=1)
    targs = [_t(a) for a in args]
    rr = tpp.permute_rounds(ct, *targs)
    base = (ct, targs[0], targs[1], targs[4], targs[6], rr.tables)
    for fn in (tpp.materialize, cuda_permute.materialize):
        with pytest.raises(ValueError, match=r"G must be \(900, 5\)"):
            fn(*base, G=rr.G[:-1])
        with pytest.raises(ValueError, match="G"):
            fn(*base, G=rr.G.to("meta"))


def _k3_floats(K, d, ncov, T, moments):
    """K3's shared memory from the layout in csrc/permute_phase.cu."""
    LS = -(-K * (T + 1) // 4) * 4
    f = 2 * T * K + 2 * LS  # two steps' rows of G, two of R cluster-major
    i = 2 * ncov * T + 2 * T  # two steps' codes and block ids
    if moments:
        kr = 4 * -(-K // 4)
        kr += 4 if kr % 32 == 0 else 0
        d1p = 8 * -(-(d + 1) // 8)
        f += 2 * T * kr + 3 * d1p * (T + 4)  # R cell-major, [Z_orig; 1] dim-major
    return 4 * (f + i)


@pytest.mark.parametrize("B", [3, 10, 40, 400])
@pytest.mark.parametrize("d", [13, 50, 100])
@pytest.mark.parametrize("K", [7, 100, 256, 300])
def test_k3_and_k6_launch_plans(K, d, B):
    # K3: 512 threads, 4 x 8 moment tiles, up to four cell groups
    tiles = -(-K // 4) * -(-(d + 1) // 8)
    assert cuda_permute.moment_tiles(K, d) == tiles
    assert cuda_permute.moments_fit(K, d) == (tiles <= 512)
    if K <= 128 and d <= 100:
        assert cuda_permute.moments_fit(K, d)
    for moments in (False, True):
        if moments and not cuda_permute.moments_fit(K, d):
            continue
        T = cuda_permute.materialize_tile(K, d, 2, moments)
        smem = cuda_permute.materialize_smem_bytes(K, d, 2, T, moments)
        assert T in (64, 32, 16) and smem == _k3_floats(K, d, 2, T, moments) <= SMEM_MAX
        if T < 64:
            assert cuda_permute.materialize_smem_bytes(K, d, 2, 2 * T, moments) > SMEM_MAX
    if cuda_permute.moments_fit(K, d):
        g = cuda_permute.moment_groups(K, d)
        assert 1 <= g <= 4 and g * tiles <= 512 and (g == 4 or (g + 1) * tiles > 512)
    # K6: 256 threads, (cluster, split) threads for the design sums
    K8 = 8 * -(-K // 8)
    try:
        splits, smem = cuda_rotate.reassign_plan(K, d, B, 2)
    except ValueError as e:
        assert f"K={K}, d={d}, B={B}" in str(e)
        assert cuda_rotate.reassign_smem_bytes(K, d, B, 2, 1) > SMEM_MAX
        return
    assert splits in (1, 2, 4) and (splits == 1 or splits * K <= 256)
    floats = (d * K8 + 2 * d * 64 + K8 * 68 + 2 * 2 * 64 + splits * K * B + 4 * 64
              + (K8 // 8 + 1) * 64 + K + 2)
    assert smem == 4 * floats <= SMEM_MAX
    chunks = cuda_rotate.reduce_chunks(K, B)
    assert chunks * 256 >= K * B > (chunks - 1) * 256


@pytest.mark.parametrize("ctas", [1, 3, 5, 20])
def test_k3_moments_plan_cuts_equal_ranges_at_joints(ctas):
    """The plan covers every layout tile once, joint by joint, in ranges
    whose lengths differ by at most one, a segment a (range, joint); each
    joint's partials rows (a group each) are contiguous, in order."""
    tj = np.array([2, 0, 0, 1, 2, 0, 1, 3, 3, 0, 2], np.int32)
    plan, start, span, rows = cuda_permute._k3_moments_plan(tj.tobytes(), 3, "cpu", 2, ctas)
    plan, start = plan.numpy(), start.numpy()
    tiles, segs = plan[:, 0], plan[:, 1]
    lengths = (tiles >= 0).sum(1)
    assert span == lengths.max() and lengths.max() - lengths.min() <= 1
    flat, fseg = tiles[tiles >= 0], segs[tiles >= 0]
    np.testing.assert_array_equal(flat, np.argsort(tj, kind="stable"))
    assert (np.diff(fseg) >= 0).all() and rows == 2 * (fseg.max() + 1)
    seg_joint = np.array([tj[flat[fseg == g][0]] for g in range(fseg.max() + 1)])
    np.testing.assert_array_equal(start, [2 * (seg_joint < j).sum() for j in range(5)])
    # a range never shares a segment with another, nor a segment two joints
    for b in range(ctas):
        for c in range(ctas):
            if b != c:
                assert not set(segs[b][segs[b] >= 0]) & set(segs[c][segs[c] >= 0])
    assert all(len(set(tj[flat[fseg == g]])) == 1 for g in np.unique(fseg))
