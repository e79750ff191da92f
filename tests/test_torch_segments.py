"""The segmented M-step of harmony_tpu_torch against harmony_tpu.

* ``build_segments`` gives the JAX package's tile_cells, tile_batch and pos,
  pad cells (Np > N) and empty levels included: exact.
* ``moe_correct_ridge(segments=)`` against JAX's for Z_corr, Y_new and W:
  one and two covariates (the cross blocks), a dropped batch, fixed and
  estimated lambda, the kernel and the plain M-step setting (segments
  take precedence over the K4/K5 kernels): atol 1e-4, 1e-5 on Y, the
  bounds of ``tests/test_ops.py``'s segmented-against-dense test.
* Routing (``engine.mstep_layout``): ``mstep_mode='segment'`` on both
  schedules, the default at 65,536 cells and 32 batches, and
  ``mstep_mode='tiled'`` without a batch-tiled order raising ValueError.
* Three permute rounds with ``mstep_mode='segment'`` and injected
  permutations against the JAX engine: objective rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from harmony_tpu import config as jconfig
from harmony_tpu import engine as jengine
from harmony_tpu import ops as jops
from harmony_tpu import preprocess as jpre
from harmony_tpu import state as jstate
from harmony_tpu.config import HarmonyConfig as JConfig
from harmony_tpu.ops.segments import build_segments as j_build_segments
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.config import HarmonyConfig as TConfig
from harmony_tpu_torch.ops import ridge as tridge
from harmony_tpu_torch.ops.segments import build_segments

from test_torch_ridge import _ridge_problem, _t


@pytest.mark.parametrize(
    "N,N_pad,B_vec,tile",
    [(1000, None, (4,), 64),
     (1000, 1024, (3, 5), 64),  # pad cells, two covariates
     (777, 800, (6,), 128),  # level 5 has no cell
     (300, None, (2,), 1024)],  # one tile a level
)
def test_build_segments_matches_jax(N, N_pad, B_vec, tile):
    rng = np.random.default_rng(N)
    Np = N_pad or N
    codes = np.zeros((len(B_vec), Np), np.int32)
    for c, b in enumerate(B_vec):
        codes[c, :N] = rng.integers(0, b - 1 if b == 6 else b, N)
    kw = dict(N=N, d=3, K=2, B=sum(B_vec), B_vec=B_vec, N_pad=N_pad)
    segs_j = j_build_segments(JConfig(**kw), codes, tile=tile)
    segs_t = build_segments(TConfig(**kw), codes, tile=tile)
    # the port also takes the unpadded (ncov, N) codes of the design
    segs_n = build_segments(TConfig(**kw), codes[:, :N], tile=tile)
    for sj, st, sn in zip(segs_j, segs_t, segs_n):
        for f in ("tile_cells", "tile_batch", "pos"):
            np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
            np.testing.assert_array_equal(getattr(sn, f).numpy(), np.asarray(getattr(sj, f)))
        assert st.tile == tile and st.pos.shape == (Np + 1,)
        # every real cell sits in exactly one slot; pad cells in none
        flat = st.tile_cells.numpy().reshape(-1)
        assert sorted(flat[flat < Np].tolist()) == list(range(N))
        assert (st.pos.numpy()[N:Np] == st.n_tiles * tile).all()


@pytest.mark.parametrize(
    "B_vec,lambda_estimation,impl,cutoff",
    [((4,), False, "kernel", 1e-5),
     ((4,), True, "torch", 1e-5),
     ((4,), True, "kernel", 0.05),  # a dropped batch
     ((4,), False, "torch", 0.05),  # a dropped batch
     ((3, 2), False, "torch", 1e-5),  # two covariates: cross blocks
     ((3, 2), True, "kernel", 0.05)],  # two covariates, a dropped batch
)
def test_moe_correct_ridge_segments_match_jax(B_vec, lambda_estimation, impl, cutoff):
    N, d, K = 400, 7, 5
    a = _ridge_problem(N, d, K, B_vec, seed=len(B_vec) * 10 + int(cutoff > 1e-3),
                       rare=cutoff > 1e-3)
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, alpha=0.2,
              batch_prop_cutoff=cutoff, lambda_estimation=lambda_estimation,
              mstep_mode="segment")
    cfgj, cfgt = JConfig(**kw), TConfig(**kw, mstep_impl=impl)
    if cutoff > 1e-3:
        keep, _ = tridge.compute_masks(cfgt, _t(a[2]), _t(a[5]))
        assert not bool(keep.all())  # the cutoff really drops a batch
    segs_j = j_build_segments(cfgj, a[4], tile=64)
    segs_t = build_segments(cfgt, a[4], tile=64)
    Zj, Yj, Wj = jops.moe_correct_ridge(cfgj, *map(jnp.asarray, a), segments=segs_j)
    Zt, Yt, Wt = tridge.moe_correct_ridge(cfgt, *map(_t, a), segments=segs_t)
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=1e-4)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), atol=1e-5)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-4)
    # and the port's own dense path on the same inputs
    Zd, Yd, Wd = tridge.moe_correct_ridge(dataclasses.replace(cfgt, mstep_impl="torch"),
                                          *map(_t, a))
    np.testing.assert_allclose(Zt.numpy(), Zd.numpy(), atol=1e-4)
    np.testing.assert_allclose(Wt.numpy(), Wd.numpy(), atol=1e-4)


def test_segments_take_precedence_over_the_k4_k5_kernels(monkeypatch):
    from harmony_tpu_torch.ops import cuda_ridge

    a = _ridge_problem(300, 4, 3, (3,), seed=2)
    cfg = TConfig(N=300, d=4, K=3, B=3, B_vec=(3,), mstep_impl="kernel")

    def refuse(*args, **kwargs):
        raise AssertionError("K4/K5 called on a segmented M-step")

    monkeypatch.setattr(cuda_ridge, "moments", refuse)
    monkeypatch.setattr(cuda_ridge, "correction", refuse)
    Zc, _, _ = tridge.moe_correct_ridge(cfg, *map(_t, a),
                                        segments=build_segments(cfg, a[4], tile=32))
    assert torch.isfinite(Zc).all()


@pytest.mark.parametrize("shuffle_mode", ["permute", "rotate"])
def test_segment_mode_routes_to_segments(shuffle_mode):
    cfg = tconfig.finalize_engine_config(TConfig(
        N=5000, d=4, K=3, B=2, B_vec=(2,), shuffle_mode=shuffle_mode, mstep_mode="segment"))
    codes = np.random.default_rng(0).integers(0, 2, (1, 5000))
    layout = tengine.mstep_layout(cfg, codes)
    assert layout.tiled is None and len(layout.segments) == 1
    assert layout.segments[0].pos.shape == (cfg.Np + 1,)
    # 'dense' takes neither, whatever N and B
    dense = dataclasses.replace(cfg, mstep_mode="dense")
    layout = tengine.mstep_layout(dense, codes)
    assert layout.tiled is None and layout.segments is None


def test_tiled_mode_without_a_layout_raises_on_every_schedule():
    codes = np.random.default_rng(1).integers(0, 3, (1, 5000))
    for kw in ({"shuffle_mode": "permute"}, {"shuffle_mode": "rotate"},
               {"shuffle_mode": "permute", "permute_fused": True}):
        cfg = tconfig.finalize_engine_config(TConfig(
            N=5000, d=4, K=3, B=3, B_vec=(3,), mstep_mode="tiled", **kw))
        with pytest.raises(ValueError, match="batch-tiled cell order"):
            tengine.mstep_layout(cfg, codes)


def test_run_harmony_default_takes_segments_on_permute(monkeypatch):
    from harmony_tpu_torch import run_harmony

    calls = {"seg": 0, "dense": 0}
    real_seg, real_dense = tridge._moments_segmented, tridge._moments_dense

    def seg(*a, **k):
        calls["seg"] += 1
        return real_seg(*a, **k)

    def dense(*a, **k):
        calls["dense"] += 1
        return real_dense(*a, **k)

    monkeypatch.setattr(tridge, "_moments_segmented", seg)
    monkeypatch.setattr(tridge, "_moments_dense", dense)
    rng = np.random.default_rng(3)
    n, d, B = 65_536, 4, 32
    batches = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.5)[batches] + rng.normal(size=(n, d))
    res = run_harmony(Z, {"b": batches}, ["b"], nclust=8, max_iter=2, device="cpu",
                      return_object=True)
    assert res.config.shuffle_mode == "permute" and not res.config.permute_fused
    assert res.config.use_segments and res.ingest_inv is None
    layout = tengine.mstep_layout(res.config, res.design.codes)
    assert layout.tiled is None and layout.segments is not None
    n_it = int(res.state.n_rounds)
    assert calls["dense"] == 0 and calls["seg"] == n_it > 0
    assert np.isfinite(res.embeddings).all()
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
    assert res.W.shape == (8, B + 1, d) and calls["seg"] == n_it + 1


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_segmented_permute_slice_matches_jax_engine(impl):
    N, d, B, K = 3000, 6, 5, 8
    rng = np.random.default_rng(11)
    batches = rng.integers(0, B, N)
    Z = ((rng.normal(size=(B, d)) * 0.6)[batches] + rng.normal(size=(N, d))).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=True)
    cj = jpre.resolve_config(design=jd, options=jconfig.harmony_options(), **kw)
    ct = tpre.resolve_config(design=td, options=tconfig.harmony_options(), **kw)
    cj = dataclasses.replace(cj, mstep_mode="segment", segment_tile=128)
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        ct, mstep_mode="segment", segment_tile=128, estep_impl=impl, mstep_impl=impl))
    assert ct.shuffle_mode == "permute" and not ct.permute_fused
    Zt = jpre.orient_embedding(Z, N)
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, None, 0.0)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, None, 0.0)
    Y0 = Zt[:, rng.choice(N, K, replace=False)]
    perms = np.stack([np.stack([rng.permutation(N) for _ in range(cj.max_iter_cluster)])
                      for _ in range(3)]).astype(np.int32)
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    segs_j = j_build_segments(cj, np.asarray(sj.codes), tile=cj.segment_tile)
    layout = tengine.mstep_layout(ct, st.codes.numpy())
    assert layout.tiled is None and layout.segments is not None
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    for it in range(3):
        sj = jengine.correct(cj, jengine.cluster(cj, sj, jnp.asarray(perms[it])),
                             segments=segs_j)
        st = tengine.harmony_round(ct, st, perms[it], layout=layout)
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=1e-5)
    np.testing.assert_allclose(st.Z_corr.numpy(), np.asarray(sj.Z_corr), atol=1e-4, rtol=0)
