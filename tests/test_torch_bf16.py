"""The bf16 engine's kernels and modules of harmony_tpu_torch against harmony_tpu.

A bf16 engine stores its state in bf16 and runs every contraction in fp32
on operands upcast at the boundary, casting back where the JAX engine casts
(harmony_tpu/ops/assign.py:32-38, harmony_tpu/engine.py:420-437). The same
bf16 arrays (made from a numpy seed, handed over bit for bit) go to both
packages; the JAX functions run as the JAX package's own tests run them,
the Pallas kernels in interpret mode.

* The resolution: ``dtype='bfloat16'`` resolves ``matmul_precision`` to
  'bfloat16' as the JAX package does, virtual R on, the kernels; float16
  raises naming its ROADMAP item.
* Per kernel, in both op orders: the plain versions of K6 (bf16 Z_raw),
  K7's last round (fused moments on a bf16 Z_orig, R, E and O in bf16),
  K10 (bf16 Z_orig in, bf16 Z_corr out) and K11 (bf16 R out) against the
  Pallas functions fed the same bf16 arrays. float32 outputs (Zn, G, tile
  O, moments, penalty tables) at the float32 tests' bounds (1e-5/1e-6);
  bf16 outputs with each element within one bf16 ulp of the JAX value
  (|d| <= 2^(floor(log2 |ref|) - 7) + 1e-7; the M-step's Z_corr, which
  cancels near 0 in places, + 1e-6) and at least 99% bit-equal. The float32
  outputs of K6 and K7 from bf16 storage equal those from its upcast copy,
  0.0, the property the kernels hold on the card.
* Per module: the M-step (dense, batch-tiled, virtual), k-means and the
  objective on bf16 state against the JAX functions: bf16 outputs at the
  bf16 bound above, float32 ones (W, the objective terms) at 1e-5; the
  engine's initial assignments and objective terms from injected
  centroids at 1e-6.
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
from harmony_tpu.ops import kmeans as jkmeans
from harmony_tpu.ops import objective as jobjective
from harmony_tpu.ops import pallas_rotate as jpr
from harmony_tpu.ops import ridge as jridge
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch.ops import cuda_rotate
from harmony_tpu_torch.ops import kmeans as tkmeans
from harmony_tpu_torch.ops import objective as tobjective
from harmony_tpu_torch.ops import ridge as tridge
from harmony_tpu_torch.ops import rotate as tr

from test_torch_rotate import CASES, _jax_schedule, _problem, _t
from test_torch_virtual import LAYOUT_TILE, N_JOINT, _setup, _states

BF16 = torch.bfloat16


def _bf(a) -> torch.Tensor:
    """A torch bf16 tensor with the bits of a JAX bf16 array."""
    bits = np.ascontiguousarray(np.asarray(a)).view(np.int16)
    return torch.from_numpy(bits.copy()).view(BF16)


def _jb(a) -> jnp.ndarray:
    """float32 values as a JAX bf16 array (round to nearest even)."""
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), dtype=np.float64)


def bf16_ulp(r: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |r|: 2^(floor(log2 |r|) - 7), between 2^-8 |r| and
    2^-7 |r| (bf16 keeps 8 significant bits); 0 at 0."""
    a = np.abs(r)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def assert_bf16_close(out, ref, min_equal=0.99, atol=1e-7):
    """Each element within one bf16 ulp of the reference plus ``atol`` and
    at least ``min_equal`` of them bit-equal. A float32 value that differs
    in its last bits near a bf16 rounding midpoint rounds one ulp apart,
    which for a significand above 1 is more than 2^-8 |ref|; ``atol``
    covers the float32 difference itself where a result cancels to near 0
    (one float32 ulp of an operand near 1 is 1.19e-7)."""
    assert out.dtype == BF16, out.dtype
    o, r = _f64(out), _f64(ref)
    assert o.shape == r.shape
    bad = np.abs(o - r) > bf16_ulp(r) + atol
    assert not bad.any(), f"{bad.sum()} elements past one bf16 ulp, max |d| {np.abs(o - r).max()}"
    assert (o == r).mean() >= min_equal, f"only {(o == r).mean():.4f} bit-equal"


def _close(a, b, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(_f64(a), _f64(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,prec", [("bfloat16", "bfloat16"), ("float32", "float32"),
                                        ("float64", "highest")])
def test_bf16_engine_resolves_as_the_jax_package(dtype, prec):
    kw = dict(N=5000, d=4, K=3, B=2, B_vec=(2,), shuffle_mode="rotate", dtype=dtype,
              matmul_precision="auto")
    cj = jconfig.finalize_engine_config(jconfig.HarmonyConfig(**kw, estep_impl="pallas"))
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(**kw))
    assert ct.matmul_precision == cj.matmul_precision == prec
    assert ct.virtual_r == cj.virtual_r == (dtype == "bfloat16")
    assert (ct.estep_sub_tile, ct.Np) == (cj.estep_sub_tile, cj.Np)
    impl = "torch" if dtype == "float64" else "kernel"
    assert (ct.estep_impl, ct.mstep_impl) == (impl, impl)
    for p in ("auto", "bfloat16", "float32", "highest"):
        assert tconfig.resolve_matmul_precision(dtype, p) == jconfig.resolve_matmul_precision(
            dtype, p)
    with pytest.raises(tconfig.HarmonyConfigError, match="matmul_precision"):
        tconfig.finalize_engine_config(tconfig.HarmonyConfig(**{**kw, "matmul_precision": "x"}))
    # the float16 engine resolves as the bf16 one does (it raised until ported)
    f16 = {**kw, "dtype": "float16"}
    cj = jconfig.finalize_engine_config(jconfig.HarmonyConfig(**f16, estep_impl="pallas"))
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(**f16))
    assert ct.matmul_precision == cj.matmul_precision == "bfloat16"
    assert ct.virtual_r and cj.virtual_r and ct.bf16_products
    assert (ct.estep_impl, ct.mstep_impl) == ("kernel", "kernel")


def _storage(Z):
    """The bf16 storage of a float32 array, in both packages."""
    Zj = _jb(Z)
    return Zj, _bf(Zj)


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k6_twin_on_bf16_matches_pallas_reassign(N, Np, d, K, B_vec, T):
    cj, ct, Z, Y, codes, Pr, sigma, _ = _problem(N, Np, d, K, B_vec, T, seed=N + K + 1)
    Zj, Zt = _storage(Z)
    cp_j = jpr.make_codes_pad(cj, jnp.asarray(codes))
    ref = jpr.pallas_reassign(cj, jnp.asarray(Y), jnp.asarray(sigma), jnp.asarray(Pr),
                              jpr.pad_cells_to_tile(cj, Zj), cp_j, interpret=True)
    args = (ct, _t(Y), _t(sigma), _t(Pr))
    cp_t = tr.make_codes_pad(ct, _t(codes))
    out = cuda_rotate.reassign(*args, tr.pad_cells_to_tile(ct, Zt), cp_t)
    assert all(o.dtype == torch.float32 for o in out)
    _close(out[0], ref[0], rtol=0, atol=1e-6)
    for o, r in zip(out[1:4], ref[1:]):
        _close(o, r, atol=1e-6)
    _close(out[4], np.asarray(ref[0]).T @ Y, rtol=0, atol=1e-6)
    # the float32 outputs are those of the upcast copy, bit for bit
    up = cuda_rotate.reassign(*args, tr.pad_cells_to_tile(ct, Zt.float()), cp_t)
    for o, u in zip(out, up):
        assert torch.equal(o, u)


def _last_round_bf16(N, Np, d, K, B_vec, T, write_r, variant):
    """A phase's last K7 round on bf16 state (R, E, O in bf16; the moments
    read a bf16 Z_orig) in both packages, from JAX's re-entry on a bf16
    Z_raw, and the inputs the virtual functions take."""
    cj, ct, Z, Y, codes, Pr, sigma, theta = _problem(N, Np, d, K, B_vec, T, seed=N + 3 * d,
                                                     variant=variant)
    cj = dataclasses.replace(cj, dtype="bfloat16")
    ct = dataclasses.replace(ct, dtype="bfloat16")
    rng = np.random.default_rng(N + K + 7)
    cp_j = jpr.make_codes_pad(cj, jnp.asarray(codes))
    Zn, tO, O, E = jpr.pallas_reassign(cj, jnp.asarray(Y), jnp.asarray(sigma), jnp.asarray(Pr),
                                       jpr.pad_cells_to_tile(cj, _jb(Z)), cp_j, interpret=True)
    O, E = O.astype(jnp.bfloat16), E.astype(jnp.bfloat16)
    tj = rng.integers(0, N_JOINT + 1, Np // LAYOUT_TILE).astype(np.int32)
    Zo = np.zeros((d, Np), np.float32)
    Zo[:, :N] = 1.5 * rng.normal(size=(d, N))
    Zo_j, Zo_t = _storage(Zo)
    # the JAX engine hands its kernel the float32 copy of the bf16 Z_orig
    spec_j = jpr.MomentsSpec(Z_orig_pad=Zo_j.astype(jnp.float32), tile_joint=jnp.asarray(tj),
                             n_joint=N_JOINT, tile=LAYOUT_TILE)
    spec_t = tr.MomentsSpec(Z_orig=Zo_t, tile_joint=tj, n_joint=N_JOINT, tile=LAYOUT_TILE)
    R0 = jnp.full((K, Np), 0.5, jnp.bfloat16)
    rs_j = jpr.RoundState(R=R0, E=E, O=O, tile_O=tO, kmeans_error=jnp.float32(0),
                          entropy=jnp.float32(0))
    rs_t = tr.RoundState(R=_bf(R0), E=_bf(E), O=_bf(O), tile_O=_t(tO), kmeans_error=None,
                         entropy=None)
    key = jax.random.PRNGKey(N + 5)
    rt, order = _jax_schedule(ct, key)
    ref = jpr.pallas_rotate_update_round_v2(
        cj, None, jnp.asarray(Y), rs_j, jnp.asarray(Pr), jnp.asarray(sigma), jnp.asarray(theta),
        key, layout=jpr.CodesLayout(Z_pad=Zn, codes_pad=cp_j), interpret=True, write_r=write_r,
        moments=spec_j, emit_pen=True)
    G = _t(np.asarray(Zn).T @ Y)
    lay = tr.CodesLayout(Z_pad=_t(Zn), codes_pad=_t(cp_j), G=G)
    args = (ct, _t(Y), rs_t, _t(Pr), _t(sigma), _t(theta), tr.schedule_table([(rt, order)])[0],
            lay, write_r)
    out = cuda_rotate.rotate_update_round_v2(*args, moments=spec_t, emit_pen=True)
    up = cuda_rotate.rotate_update_round_v2(*args, moments=spec_t._replace(Z_orig=Zo_t.float()),
                                            emit_pen=True)
    x = dict(Y=Y, sigma=sigma, Zn=np.asarray(Zn), cp=np.asarray(cp_j), Zo_j=Zo_j, Zo_t=Zo_t,
             tj=tj, G=G)
    return cj, ct, ref, out, up, x


@pytest.mark.parametrize("variant", ["fused_vpu", "legacy"])
@pytest.mark.parametrize("write_r", [True, False])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES[:3])
def test_k7_last_round_on_bf16_matches_pallas(N, Np, d, K, B_vec, T, write_r, variant):
    _, _, (res_j, M_j, (pen_j, map_j)), out, up, _ = _last_round_bf16(
        N, Np, d, K, B_vec, T, write_r, variant)
    M_j = np.asarray(M_j)
    _close(out.M, M_j, rtol=0, atol=1e-5 * np.abs(M_j).max())
    _close(out.pen, pen_j, rtol=1e-6)
    np.testing.assert_array_equal(out.blkmap.numpy(), np.asarray(map_j))
    _close(out.tile_O, res_j.tile_O, atol=1e-5)
    _close(float(out.kmeans_error), float(res_j.kmeans_error))
    _close(float(out.entropy), float(res_j.entropy))
    for name in ("E", "O"):
        assert_bf16_close(getattr(out, name), getattr(res_j, name))
    if write_r:
        assert_bf16_close(out.R, res_j.R)
    else:
        assert out.R.dtype == BF16 and (out.R.float() == 0.5).all()
    # the moments from bf16 Z_orig are those of its upcast copy, bit for bit
    assert torch.equal(out.M, up.M) and torch.equal(out.pen, up.pen)


@pytest.mark.parametrize("variant", ["fused_vpu", "legacy"])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k10_twin_on_bf16_matches_pallas(N, Np, d, K, B_vec, T, variant):
    cj, ct, (_, _, (pen_j, map_j)), _, _, x = _last_round_bf16(N, Np, d, K, B_vec, T, False,
                                                               variant)
    rng = np.random.default_rng(d + 5)
    W = (0.2 * rng.normal(size=(N_JOINT + 1, d, K))).astype(np.float32)
    W[N_JOINT] = 0.0
    ref = jpr.pallas_virtual_correction(
        cj, jnp.asarray(W), jnp.asarray(x["tj"]), LAYOUT_TILE, jnp.asarray(x["Y"]),
        jnp.asarray(x["sigma"]), pen_j, map_j, jnp.asarray(x["Zn"]), jnp.asarray(x["cp"]),
        x["Zo_j"], interpret=True).astype(jnp.bfloat16)
    args = (ct, _t(W), x["tj"], LAYOUT_TILE, _t(x["Y"]), _t(x["sigma"]), _t(pen_j),
            _t(map_j), _t(x["Zn"]), _t(x["cp"]))
    out = cuda_rotate.virtual_correction(*args, x["Zo_t"], x["G"])
    assert_bf16_close(out, ref)
    # one rounding of the float32 form on the upcast Z_orig; trash tiles
    # pass Z_orig through
    f32 = cuda_rotate.virtual_correction(*args, x["Zo_t"].float(), x["G"])
    assert f32.dtype == torch.float32 and torch.equal(out, f32.to(BF16))
    trash = np.repeat(x["tj"] == N_JOINT, LAYOUT_TILE)
    assert torch.equal(out[:, trash], x["Zo_t"][:, trash])


@pytest.mark.parametrize("variant", ["fused_vpu", "legacy"])
@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k11_twin_bf16_out_matches_pallas_and_k7(N, Np, d, K, B_vec, T, variant):
    cj, ct, (res_j, _, (pen_j, map_j)), out, _, x = _last_round_bf16(N, Np, d, K, B_vec, T,
                                                                     True, variant)
    ref = jpr.pallas_materialize_r(cj, jnp.asarray(x["Y"]), jnp.asarray(x["sigma"]), pen_j,
                                   map_j, jnp.asarray(x["Zn"]), jnp.asarray(x["cp"]),
                                   interpret=True, out_dtype=jnp.bfloat16)
    vargs = (ct, _t(x["Y"]), _t(x["sigma"]), out.pen, out.blkmap, _t(x["Zn"]), _t(x["cp"]))
    R = cuda_rotate.materialize_r(*vargs, out_dtype=BF16)
    assert R.shape == (K, Np)
    assert_bf16_close(R, ref)
    # the bf16 R the round itself wrote (the plain versions form g in two
    # ways, so their float32 R differ in the last bits, and the bf16 R by
    # an ulp where that crosses a rounding midpoint; the kernels share g's
    # bits), and the float32 form's R cast once
    assert_bf16_close(R, out.R)
    assert torch.equal(R, cuda_rotate.materialize_r(*vargs).to(BF16))
    np.testing.assert_allclose(_f64(R)[:, :N].sum(0), 1.0, atol=5e-3)


# ---- modules ---------------------------------------------------------------


def _bf16_setup(B_vec, N, Np, virtual=True, seed=7):
    setup = list(_setup(B_vec, N, Np, seed=seed))
    for i in (0, 1):
        setup[i] = dataclasses.replace(setup[i], dtype="bfloat16", virtual_r=virtual)
    return setup


@pytest.mark.parametrize("path", ["dense", "tiled", "virtual"])
def test_moe_correct_ridge_on_bf16_matches_jax(path):
    setup = _bf16_setup((3,), 4000, 4096, virtual=path == "virtual")
    cj, ct = setup[:2]
    # the port's fp32 products, which the JAX package computes on the CPU
    # under any precision (the bf16 product form, K10's W R under the
    # resolved 'bfloat16', is held to its twin in test_torch_bf16_products)
    ct = dataclasses.replace(ct, matmul_precision="float32")
    sj, _, tiled_j, tiled_t = _states(cj, ct, *setup[2:])
    if path == "dense":
        # K4/K5's plain versions on the float32 copies the M-step makes
        ct = dataclasses.replace(ct, mstep_mode="dense", mstep_impl="kernel")
        tiled_j = tiled_t = None
    sj, M, virt = jengine.cluster(cj, sj, tiled=tiled_j, return_moments=True, virtual=True)
    assert (virt is not None) == (path == "virtual")
    assert sj.Z_orig.dtype == sj.R.dtype == jnp.bfloat16
    kw_j = dict(tiled=tiled_j, tiled_moments=M if tiled_j is not None else None, virtual=virt)
    ref = jridge.moe_correct_ridge(cj, sj.Z_orig, sj.R, sj.O, sj.E, sj.codes, sj.batch_sizes,
                                   sj.lamb, sj.Y, **kw_j)
    virt_t = None
    if virt is not None:
        virt_t = tr.VirtualR(*[_bf(a) if a.dtype == jnp.bfloat16 else _t(a) for a in virt])
        # the engine's context holds Z_orig in the storage dtype
        virt_t = virt_t._replace(Z_orig_pad=_bf(sj.Z_orig))
    b = lambda a: _bf(a) if a.dtype == jnp.bfloat16 else _t(a)
    out = tridge.moe_correct_ridge(
        ct, b(sj.Z_orig), b(sj.R), b(sj.O), b(sj.E), _t(sj.codes), b(sj.batch_sizes),
        b(sj.lamb), b(sj.Y), tiled=tiled_t,
        tiled_moments=_t(M) if tiled_t is not None else None, virtual=virt_t)
    # Z_corr = Z_orig - corr cancels near 0 in places: the float32 forms
    # differ there by an ulp of the operands (the float32 tests hold Z_corr
    # to 1e-5)
    assert_bf16_close(out[0], ref[0], atol=1e-6)
    assert_bf16_close(out[1], ref[1])
    _close(out[2], ref[2], rtol=0, atol=1e-5 * float(np.abs(np.asarray(ref[2])).max()))


def _jax_seed_draws(key, K, n_valid):
    """The draws JAX's _seed_centroids makes (kmeans.py:33-55): float32
    uniforms for any X dtype."""
    k0, k1 = jax.random.split(key)
    init_idx = jax.random.randint(k0, (K,), 0, n_valid)
    tiny = jnp.finfo(jnp.bfloat16).tiny
    u = [jax.random.uniform(kk, (n_valid,), minval=tiny, maxval=1.0)
         for kk in jax.random.split(k1, K)]
    return np.asarray(init_idx), [np.asarray(x) for x in u]


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_on_bf16_matches_jax(seed):
    rng = np.random.default_rng(seed)
    Xj = jops.l2_normalize_columns(_jb(rng.normal(size=(6, 400))))
    assert Xj.dtype == jnp.bfloat16
    key, K = jax.random.PRNGKey(seed), 7
    idx, u = _jax_seed_draws(key, K, 400)
    assert u[0].dtype == np.float32
    Yj = jkmeans._seed_centroids(key, Xj, K, 400)
    Yt = tkmeans._seed_centroids(_bf(Xj), K, 400, init_idx=_t(idx), uniforms=[_t(a) for a in u])
    assert torch.equal(Yt, _bf(Yj))
    Cj = jkmeans.kmeans_centers(key, Xj, K)
    Ct = tkmeans.kmeans_centers(_bf(Xj), K, init_idx=_t(idx), uniforms=[_t(a) for a in u])
    assert_bf16_close(Ct, Cj)


def test_objective_on_bf16_matches_jax():
    rng = np.random.default_rng(5)
    N, d, K, B_vec = 600, 6, 5, (2, 3)
    cfg = jconfig.HarmonyConfig(N=N, d=d, K=K, B=5, B_vec=B_vec, dtype="bfloat16")
    ct = tconfig.HarmonyConfig(N=N, d=d, K=K, B=5, B_vec=B_vec, dtype="bfloat16")
    Z = jops.l2_normalize_columns(_jb(rng.normal(size=(d, N))))
    Y = jops.l2_normalize_columns(_jb(rng.normal(size=(d, K))))
    sigma = _jb(rng.uniform(0.05, 0.2, K))
    theta = _jb(rng.uniform(0.5, 2.0, 5))
    codes = jnp.asarray(np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32))
    dist = jops.compute_distances(Y, Z)
    R = jops.initial_assignments(dist, sigma)
    O = jops.compute_O(R, codes, cfg.covariate_offsets, cfg.B)
    E = jops.compute_E(R, _jb(np.full(5, 0.2)))
    assert dist.dtype == R.dtype == O.dtype == jnp.bfloat16
    ref = jobjective.compute_objective(cfg, R, dist, O, E, codes, sigma, theta)
    out = tobjective.compute_objective(ct, _bf(R), _bf(dist), _bf(O), _bf(E), _t(codes),
                                       _bf(sigma), _bf(theta))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        _close(float(o), float(r))
    # the port's assignment ops give the JAX ops' bf16 values
    from harmony_tpu_torch import ops as tops

    assert_bf16_close(tops.compute_distances(_bf(Y), _bf(Z)), dist)
    assert_bf16_close(tops.initial_assignments(_bf(dist), _bf(sigma)), R)
    assert_bf16_close(tops.compute_O(_bf(R), _t(codes), ct.covariate_offsets, ct.B), O)


def test_init_cluster_on_bf16_matches_jax():
    """The engine's first assignments and objective from injected
    centroids on a bf16 state (harmony_tpu/engine.py init_cluster_from)."""
    setup = _bf16_setup((2, 3), 4000, 4096)
    cj, ct = setup[:2]
    sj, st, _, _ = _states(cj, ct, *setup[2:])
    assert st.Z_corr.dtype == st.R.dtype == st.Y.dtype == BF16
    assert_bf16_close(st.Z_orig, sj.Z_orig, min_equal=1.0)
    assert_bf16_close(st.Z_corr, sj.Z_corr)
    assert_bf16_close(st.Y, sj.Y)
    assert_bf16_close(st.R, sj.R)
    # the initial objective, whose distance term carries bf16's
    # renormalisation, in both packages alike (its terms float32 sums)
    for name in ("objective_kmeans", "objective_kmeans_dist", "objective_kmeans_entropy",
                 "objective_kmeans_cross"):
        _close(getattr(st, name)[:1].numpy(), np.asarray(getattr(sj, name))[:1], rtol=1e-6)
    assert tengine.mstep_layout(ct, st.codes.numpy()).tiled is not None
