"""The fused permute phase of harmony_tpu_torch against harmony_tpu.

* ``ops/assign.py``: ``make_blocks`` puts the sentinel ``Np`` in pad slots
  (equal to JAX's with ``N_pad``).
* The K2/K3 twin (``ops/permute_phase.permute_phase``) against JAX
  ``pallas_permute_phase`` in interpret mode and ``xla_permute_phase``
  without a mesh, on identical inputs with injected permutations, at the
  bounds of the JAX suite's own test (tests/test_pallas.py:573-587) or
  tighter: R atol 2e-5; E, O and their per-round stacks to 1e-5 of their
  max; k-means error and entropy rtol 1e-5. R column sums are 1, pad cells
  exactly 0. The fused moments equal JAX's ``moments=MomentsSpec`` table.
* The wrappers of ``ops/cuda_permute.py`` run the twins on CPU tensors
  without counting a launch and raise on another device.
* ``finalize_engine_config``'s ``permute_fused`` resolution, and the
  engine: three Harmony rounds of the fused path (batch-tiled order,
  injected centroids and permutations, lambda estimated) against the JAX
  engine's fused ``cluster(return_moments=True)`` + ``correct(tiled_moments=)``:
  objective rtol 1e-5, Z_corr atol 1e-5.
* ``run_harmony`` at the gate (200,000 cells) takes the fused phase and
  returns the caller's order; below it, and with ``max_iter_cluster=6``,
  the per-round path runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harmony_tpu import config as jconfig
from harmony_tpu import engine as jengine
from harmony_tpu import ops as jops
from harmony_tpu import preprocess as jpre
from harmony_tpu import state as jstate
from harmony_tpu.ops import assign as jassign
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu.ops.pallas_estep import pallas_permute_phase
from harmony_tpu.ops.pallas_rotate import MomentsSpec as JMomentsSpec
from harmony_tpu.ops.permute_phase import xla_permute_phase
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.ops import assign as tassign
from harmony_tpu_torch.ops import cuda_permute
from harmony_tpu_torch.ops import permute_phase as tpp
from harmony_tpu_torch.ops.ridge import full_tile_joint

R_ATOL, STAT_REL, RTOL = 2e-5, 1e-5, 1e-5


def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _problem(N, K, B_vec, N_pad=None, d=8, seed=0, rounds=3, codes=None):
    """tests/test_pallas.py:_problem's inputs (numpy), plus injected
    permutations; ``codes`` overrides the random batch codes."""
    rng = np.random.default_rng(seed)
    kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, N_pad=N_pad)
    cj, ct = jconfig.HarmonyConfig(**kw), tconfig.HarmonyConfig(**kw)
    Np = cj.Np
    Z = np.zeros((d, Np), np.float32)
    Z[:, :N] = rng.normal(size=(d, N))
    Z = np.asarray(jops.l2_normalize_columns(jnp.asarray(Z)))
    Y = np.asarray(jops.l2_normalize_columns(jnp.asarray(rng.normal(size=(d, K)), jnp.float32)))
    if codes is None:
        codes = np.zeros((len(B_vec), Np), np.int32)
        for c, b in enumerate(B_vec):
            codes[c, :N] = rng.integers(0, b, N)
    counts = np.concatenate([np.bincount(codes[c, :N], minlength=b) for c, b in enumerate(B_vec)])
    Pr_b = (counts / N).astype(np.float32)
    sigma = np.full(K, 0.1, np.float32)
    theta = np.full(cj.B, 1.0, np.float32)
    R = jops.initial_assignments(jops.compute_distances(jnp.asarray(Y), jnp.asarray(Z)),
                                 jnp.asarray(sigma))
    if Np != N:
        R = R * (jnp.arange(Np) < N)[None, :].astype(R.dtype)
    E = np.asarray(jops.compute_E(R, jnp.asarray(Pr_b)))
    O = np.asarray(jops.compute_O(R, jnp.asarray(codes), cj.covariate_offsets, cj.B))
    perms = np.stack([rng.permutation(N) for _ in range(rounds)]).astype(np.int32)
    return cj, ct, (Z, Y, E, O, codes, Pr_b, sigma, theta, perms)


def _check_phase(out, ref, N, r_atol=R_ATOL):
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=r_atol, rtol=0)
    for f in ("E", "O", "E_rounds", "O_rounds"):
        assert _rel(getattr(out, f).numpy(), getattr(ref, f)) <= STAT_REL, f
    for f in ("kmeans_error", "entropy"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=RTOL)
    np.testing.assert_allclose(out.R.numpy()[:, :N].sum(0), 1.0, atol=1e-5)


@pytest.mark.parametrize("B_vec", [(3,), (2, 3)])
def test_twin_matches_both_jax_phases(B_vec):
    cj, ct, args = _problem(1200, 6, B_vec)
    jargs = [jnp.asarray(a) for a in args]
    ref_p = pallas_permute_phase(cj, *jargs, sub_tile=256, interpret=True)
    ref_x = xla_permute_phase(cj, *jargs, mesh=None)
    out = tpp.permute_phase(ct, *[_t(a) for a in args])
    _check_phase(out, ref_p, ct.N)
    _check_phase(out, ref_x, ct.N)
    assert out.M is None


def test_twin_with_pad_cells():
    cj, ct, args = _problem(600, 5, (3,), N_pad=640, rounds=2, seed=3)
    ref = pallas_permute_phase(cj, *[jnp.asarray(a) for a in args], sub_tile=128,
                               interpret=True)
    out = tpp.permute_phase(ct, *[_t(a) for a in args])
    _check_phase(out, ref, ct.N)
    assert float(out.R[:, ct.N:].abs().max()) == 0.0


@pytest.mark.parametrize("B_vec,N_pad", [((3,), None), ((2, 3), 2560)])
def test_fused_moments_match_jax(B_vec, N_pad):
    N, tile, sub = 2500, 128, 256
    rng = np.random.default_rng(11)
    raw = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    perm, _ = jtiled.build_batch_tiled_order(raw, tile, seed=1)
    Np = N_pad or N
    codes = np.zeros((len(B_vec), Np), np.int32)
    codes[:, :N] = raw[:, perm]
    cj, ct, args = _problem(N, 6, B_vec, N_pad=N_pad, seed=4, rounds=2, codes=codes)
    layout = jtiled.detect_tiled_layout(codes, N, tile)
    assert layout is not None
    Z_orig = np.zeros((8, Np), np.float32)
    Z_orig[:, :N] = rng.normal(size=(8, N)) * 2
    nj = layout.joint_codes.shape[1]
    Npt = -(-Np // sub) * sub
    tj = np.full(Npt // tile, nj, np.int32)
    tj[: len(layout.tile_joint)] = layout.tile_joint
    spec_j = JMomentsSpec(Z_orig_pad=jnp.asarray(np.pad(Z_orig, ((0, 0), (0, Npt - Np)))),
                          tile_joint=jnp.asarray(tj), n_joint=nj, tile=tile)
    ref = pallas_permute_phase(cj, *[jnp.asarray(a) for a in args], sub_tile=sub,
                               interpret=True, moments=spec_j)
    spec_t = tpp.MomentsSpec(Z_orig=_t(Z_orig), tile_joint=full_tile_joint(ct, layout),
                             n_joint=nj, tile=tile)
    out = tpp.permute_phase(ct, *[_t(a) for a in args], moments=spec_t)
    _check_phase(out, ref, N)
    assert out.M.shape == (nj + 1, 6, 9)
    assert _rel(out.M.numpy(), ref.M) <= STAT_REL


@pytest.mark.parametrize("N,N_pad,bs", [(600, 640, 0.05), (100, None, 0.3),
                                        (1003, 1024, 0.07)])
def test_make_blocks_sentinel_matches_jax(N, N_pad, bs):
    rng = np.random.default_rng(2)
    kw = dict(N=N, d=4, K=3, B=2, B_vec=(2,), N_pad=N_pad, block_size=bs)
    cj, ct = jconfig.HarmonyConfig(**kw), tconfig.HarmonyConfig(**kw)
    perm = rng.permutation(N).astype(np.int32)
    ij, mj = jassign.make_blocks(cj, jnp.asarray(perm))
    it, mt = tassign.make_blocks(ct, _t(perm))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert (it.numpy()[~mt.numpy()] == ct.Np).all()


@pytest.mark.parametrize("K,B,ncov,layout", [
    (100, 10, 1, (8, False)), (100, 26, 1, (8, False)), (100, 27, 1, (8, True)),
    (100, 40, 1, (8, True)), (100, 478, 2, (8, True)), (100, 566, 1, (1, True)),
    (300, 7, 2, (8, True)), (7, 3, 2, (8, False))])
def test_k2_cell_layout(K, B, ncov, layout):
    """K2's cell passes keep a (B x K) table of batch sums a warp where two
    such CTAs fit on an SM and K <= 256, else one a CTA with the most warps
    that fit, up to the B at which one table and one warp fill a CTA."""
    assert cuda_permute.cell_layout(K, B, ncov) == layout
    assert cuda_permute.cells_smem_bytes(K, B, ncov, *layout) <= cuda_permute._SMEM_MAX


def test_k2_cell_layout_refuses_past_shared_memory():
    with pytest.raises(ValueError, match="B=567"):
        cuda_permute.cell_layout(100, 567, 1)


def test_wrappers_run_the_twins_on_cpu_and_check_devices():
    cj, ct, args = _problem(900, 5, (2, 3), seed=6, rounds=2)
    targs = [_t(a) for a in args]
    before = (cuda_permute.permute_rounds.launches, cuda_permute.materialize.launches)
    rr = cuda_permute.permute_rounds(ct, *targs)
    ref = tpp.permute_rounds(ct, *targs)
    for a, b in zip(rr[:6], ref[:6]):
        assert torch.equal(a, b)
    R, M = cuda_permute.materialize(ct, targs[0], targs[1], targs[4], targs[6], rr.tables,
                                    G=rr.G)
    R_ref, _ = tpp.materialize(ct, targs[0], targs[1], targs[4], targs[6], ref.tables, G=ref.G)
    assert M is None and torch.equal(R, R_ref)
    out = cuda_permute.permute_phase(ct, *targs)
    assert torch.equal(out.R, R)
    assert (cuda_permute.permute_rounds.launches, cuda_permute.materialize.launches) == before
    meta = [a.to("meta") if i == 0 else a for i, a in enumerate(targs)]
    with pytest.raises(ValueError, match="Z is on meta"):
        cuda_permute.permute_rounds(ct, *meta)
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_permute.materialize(ct, *[targs[i].to("meta") for i in (0, 1, 4, 6)],
                                 tpp.PhaseTables(*[t.to("meta") for t in rr.tables]))
    assert cuda_permute.moments_fit(100, 50) and not cuda_permute.moments_fit(256, 100)


def _cfg(**kw):
    base = dict(N=200_000, d=50, K=100, B=10, B_vec=(10,), shuffle_mode="permute")
    return tconfig.finalize_engine_config(tconfig.HarmonyConfig(**{**base, **kw}))


@pytest.mark.parametrize(
    "kw,fused",
    [({}, True), ({"N": 199_999}, False), ({"N": 190_000, "N_pad": 200_000}, True),
     ({"max_iter_cluster": 6}, False), ({"max_iter_cluster": 5}, True), ({"K": 257}, False),
     ({"estep_impl": "torch"}, False), ({"dtype": "float64", "virtual_r": False}, False),
     ({"N": 1000, "permute_fused": True}, True), ({"permute_fused": False}, False),
     ({"N": 1000, "permute_fused": True, "estep_impl": "torch"}, True),
     ({"shuffle_mode": "rotate"}, False)],
)
def test_permute_fused_resolution(kw, fused):
    assert _cfg(**kw).permute_fused is fused


@pytest.mark.parametrize("kw", [{"permute_fused": True, "max_iter_cluster": 6},
                                {"permute_fused": True, "shuffle_mode": "rotate"}])
def test_permute_fused_refusals(kw):
    with pytest.raises(tconfig.HarmonyConfigError, match="permute_fused=True"):
        _cfg(**kw)


def _engine_setup(N=4096, d=8, B=3, K=8):
    rng = np.random.default_rng(7)
    batches = rng.integers(0, B, N)
    Z = rng.normal(size=(N, d)).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=True)
    cj = jpre.resolve_config(design=jd, options=jconfig.harmony_options(), **kw)
    ct = tpre.resolve_config(design=td, options=tconfig.harmony_options(), **kw)
    cj = dataclasses.replace(cj, estep_impl="pallas", estep_sub_tile=256, mstep_mode="tiled")
    perm, _ = jtiled.build_batch_tiled_order(jd.codes, 128, seed=0)
    Zt = jpre.orient_embedding(Z, N)[:, perm]
    jd = dataclasses.replace(jd, codes=jd.codes[:, perm])
    td = dataclasses.replace(td, codes=td.codes[:, perm])
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, None, 0.0)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, None, 0.0)
    Y0 = Zt[:, rng.choice(N, cj.K, replace=False)]
    perms = np.stack([np.stack([rng.permutation(N) for _ in range(cj.max_iter_cluster)])
                      for _ in range(3)]).astype(np.int32)
    return cj, ct, jd, td, Zt, hj, ht, Y0, perms


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_fused_slice_matches_jax_engine(impl):
    import jax

    cj, ct, jd, td, Zt, hj, ht, Y0, perms = _engine_setup()
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        ct, estep_impl=impl, mstep_impl=impl, mstep_tile=128, permute_fused=True))
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    assert tiled_t is not None and tiled_t.n_pure == tiled_j.n_pure
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    for it in range(3):
        sj, M = jengine.cluster(cj, sj, jnp.asarray(perms[it]), tiled=tiled_j,
                                return_moments=True)
        assert M is not None
        sj = jengine.correct(cj, sj, tiled=tiled_j, tiled_moments=M)
        st = tengine.cluster(ct, st, perms[it], tiled=tiled_t)
        assert st.tiled_moments is not None
        assert _rel(st.tiled_moments.numpy(), M) <= STAT_REL
        st = tengine.correct(ct, st, tengine.MStepLayout(tiled_t))
        assert st.tiled_moments is None
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=RTOL)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=RTOL)
    np.testing.assert_allclose(st.Z_corr.numpy(), np.asarray(sj.Z_corr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.R.numpy(), np.asarray(sj.R), atol=1e-4, rtol=0)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


def test_run_harmony_at_the_gate_takes_the_fused_phase(monkeypatch):
    from harmony_tpu_torch import run_harmony
    from harmony_tpu_torch.ops import cuda_estep, cuda_ridge
    from harmony_tpu_torch.ops import tiled as ttiled

    rng = np.random.default_rng(8)
    n, d = 200_000, 4
    batches = rng.integers(0, 3, n)
    Z = (rng.normal(size=(3, d)) * 0.5)[batches] + rng.normal(size=(n, d))
    calls = {}
    _spy(monkeypatch, cuda_permute, "permute_phase", calls)
    _spy(monkeypatch, cuda_estep, "block_update_round", calls)
    _spy(monkeypatch, cuda_ridge, "tile_moments", calls)
    res = run_harmony(Z, {"b": batches}, ["b"], nclust=8, max_iter=2, device="cpu",
                      shuffle_mode="permute", return_object=True)
    assert res.config.permute_fused and res.config.shuffle_mode == "permute"
    assert calls.get("permute_phase", 0) == res.state.n_rounds >= 1
    assert "block_update_round" not in calls and "tile_moments" not in calls
    order, _ = ttiled.build_batch_tiled_order(res.design.codes[:, res.ingest_inv], 256, 0)
    np.testing.assert_array_equal(res.ingest_inv, np.argsort(order))
    np.testing.assert_allclose(res.Z_orig, Z.T.astype(np.float32))
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
    assert np.isfinite(res.embeddings).all() and res.embeddings.shape == (n, d)
    assert res.kmeans_rounds.tolist() == [4] * res.state.n_rounds


@pytest.mark.parametrize("n,mic", [(1500, 4), (200_000, 6)])
def test_per_round_path_still_runs_off_the_gate(monkeypatch, n, mic):
    from harmony_tpu_torch import harmony_options, run_harmony
    from harmony_tpu_torch.ops import cuda_estep

    rng = np.random.default_rng(9)
    batches = rng.integers(0, 3, n)
    Z = (rng.normal(size=(3, 4)) * 0.5)[batches] + rng.normal(size=(n, 4))
    calls = {}
    _spy(monkeypatch, cuda_permute, "permute_phase", calls)
    _spy(monkeypatch, cuda_estep, "block_update_round", calls)
    res = run_harmony(Z, {"b": batches}, ["b"], nclust=8, max_iter=1, device="cpu",
                      shuffle_mode="permute", return_object=True,
                      options=harmony_options(max_iter_cluster=mic))
    assert not res.config.permute_fused and res.ingest_inv is None
    assert "permute_phase" not in calls and calls["block_update_round"] >= 1
    np.testing.assert_allclose(res.R.sum(0), 1.0, atol=1e-4)
