"""The phase's Gram table of harmony_tpu_torch: computed once a clustering
phase, read by every round.

Y and Z are fixed within a clustering phase, so each cell's distances are
the same in every round. K2 computes them once a phase in its head
(``permute_phase.phase_head``, the (N, K) table of 2(1 - Y^T z)), and K6
returns the rotate phase's Gram table (``rotate.reassign``'s fifth output,
(Y^T Zn)^T), which K7's rounds read from ``CodesLayout.G``.

* The plain head against the JAX package's ``compute_distances`` and a
  float64 product, row-wise: atol 1e-6. The CPU wrapper runs it without
  counting a launch.
* K6's twin: G equals ``(Y.t() @ Zn).t()`` and the same product on JAX
  ``pallas_reassign``'s Zn (interpret mode): atol 1e-6.
* The twins that read the table against runs that form the distances in
  every round, over three rounds or more, at 1e-6: the fused permute
  phase (with and without the fused moments) against the per-round
  recompute the port ran before it had a head; one clustering phase of the
  engine on the stats-carrying rotate route (materialised, virtual R, and
  the budget that writes R every round) against the same phase with K6's
  table withheld, so the plain K7 round forms g itself.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from harmony_tpu import ops as jops
from harmony_tpu.ops import pallas_rotate as jpr
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch.ops import cuda_permute, cuda_rotate
from harmony_tpu_torch.ops import permute_phase as tpp
from harmony_tpu_torch.ops import rotate as tr
from harmony_tpu_torch.ops.assign import block_bounds
from harmony_tpu_torch.ops.normalize import l1_normalize_columns
from harmony_tpu_torch.ops.objective import xlogx
from harmony_tpu_torch.ops.ridge import full_tile_joint

from test_torch_permute_phase import _problem as _permute_problem
from test_torch_rotate import CASES, _close, _problem, _t
from test_torch_virtual import _setup, _states

TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("N,K,B_vec,N_pad", [(1200, 6, (3,), None), (600, 5, (2, 3), 640)])
def test_permute_head_is_the_distances(N, K, B_vec, N_pad):
    _, ct, (Z, Y, *_) = _permute_problem(N, K, B_vec, N_pad=N_pad)
    before = cuda_permute.permute_rounds.launches
    G = cuda_permute.phase_head(ct, _t(Z), _t(Y))
    assert cuda_permute.permute_rounds.launches == before
    assert G.shape == (N, K) and G.is_contiguous()
    assert torch.equal(G, tpp.phase_head(ct, _t(Z), _t(Y)))
    ref = np.asarray(jops.compute_distances(jnp.asarray(Y), jnp.asarray(Z[:, :N])))
    np.testing.assert_allclose(G.numpy(), ref.T, rtol=0, atol=TOL)
    f64 = 2.0 * (1.0 - Z[:, :N].astype(np.float64).T @ Y.astype(np.float64))
    np.testing.assert_allclose(G.numpy(), f64, rtol=0, atol=TOL)


@pytest.mark.parametrize("N,Np,d,K,B_vec,T", CASES)
def test_k6_twin_returns_the_gram_table(N, Np, d, K, B_vec, T):
    cj, ct, Z, Y, codes, Pr, sigma, _ = _problem(N, Np, d, K, B_vec, T, seed=N + 2 * K)
    cp = tr.make_codes_pad(ct, _t(codes))
    Zr = tr.pad_cells_to_tile(ct, _t(Z))
    out = cuda_rotate.reassign(ct, _t(Y), _t(sigma), _t(Pr), Zr, cp)
    Zn, G = out[0], out[4]
    assert G.shape == (Zr.shape[1], K) and G.is_contiguous()
    _close(G, (_t(Y).t() @ Zn).t(), rtol=0, atol=TOL)
    Zn_j = jpr.pallas_reassign(cj, jnp.asarray(Y), jnp.asarray(sigma), jnp.asarray(Pr),
                               jpr.pad_cells_to_tile(cj, jnp.asarray(Z)),
                               jpr.make_codes_pad(cj, jnp.asarray(codes)), interpret=True)[0]
    _close(G, np.asarray(Zn_j).T.astype(np.float64) @ Y.astype(np.float64), rtol=0, atol=TOL)


def _rounds_recomputed(cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms):
    """The fused phase's rounds as the port ran them before the head: the
    distances of each round's cells formed again from Y and Z."""
    K, B, nb = sigma.shape[0], cfg.B, cfg.n_blocks
    Yt, sig = Y.t(), sigma
    Pr, th = Pr_b[None, :], theta[None, :]
    E_c, O_c = E.clone(), O.clone()
    pen_prev = torch.ones((K, (nb + 1) * B))
    blk_nat = torch.full((cfg.Np,), nb, dtype=torch.int64)
    slot_blk = tpp.slot_blocks(cfg, "cpu")
    b_ids = torch.arange(B)
    E_st, O_st, kerr_st, ent_st = [], [], [], []
    for perm in perms.long():
        c_lay = codes.index_select(1, perm).long()
        dist, R1 = tpp._softmax_head(Yt, Z.index_select(1, perm), sig)
        oh = torch.zeros((perm.shape[0], B))
        for c, off in enumerate(cfg.covariate_offsets):
            oh += (c_lay[c][:, None] + off == b_ids).float()
        R_prev = tpp._penalised(cfg, R1, pen_prev, blk_nat.index_select(0, perm), c_lay)
        pens, acc_d, acc_e = [], 0.0, 0.0
        for s, n in block_bounds(cfg):
            E_c = E_c - R_prev[:, s: s + n].sum(dim=1)[:, None] * Pr
            O_c = O_c - R_prev[:, s: s + n] @ oh[s: s + n]
            pen = ((2.0 * E_c + 1.0) / (O_c + E_c + 1.0)) ** th
            pens.append(pen)
            R_n = l1_normalize_columns(R1[:, s: s + n] * (pen @ oh[s: s + n].t()))
            E_c = E_c + R_n.sum(dim=1)[:, None] * Pr
            O_c = O_c + R_n @ oh[s: s + n]
            acc_d = acc_d + (R_n * dist[:, s: s + n]).sum()
            acc_e = acc_e + (sig[:, None] * xlogx(R_n)).sum()
        pen_prev = torch.cat(pens + [torch.ones((K, B))], dim=1)
        blk_nat = blk_nat.clone()
        blk_nat[perm] = slot_blk
        E_st.append(E_c)
        O_st.append(O_c)
        kerr_st.append(acc_d)
        ent_st.append(acc_e)
    return tpp.RoundsResult(E=E_c, O=O_c, E_rounds=torch.stack(E_st),
                            O_rounds=torch.stack(O_st), kmeans_error=torch.stack(kerr_st),
                            entropy=torch.stack(ent_st),
                            tables=tpp.PhaseTables(pen=pen_prev, blk=blk_nat))


@pytest.mark.parametrize("moments", [False, True])
def test_permute_phase_reading_the_head_matches_the_per_round_recompute(moments):
    N, tile, B_vec = 2500, 128, (2, 3)
    rng = np.random.default_rng(12)
    raw = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    perm, _ = jtiled.build_batch_tiled_order(raw, tile, seed=1)
    _, ct, args = _permute_problem(N, 6, B_vec, seed=5, rounds=3, codes=raw[:, perm])
    targs = [_t(a) for a in args]
    spec = None
    if moments:
        layout = jtiled.detect_tiled_layout(np.asarray(args[4]), N, tile)
        spec = tpp.MomentsSpec(Z_orig=_t(rng.normal(size=(8, N)).astype(np.float32) * 2),
                               tile_joint=full_tile_joint(ct, layout),
                               n_joint=int(layout.joint_codes.shape[1]), tile=tile)
    out = tpp.permute_phase(ct, *targs, moments=spec)
    rr = _rounds_recomputed(ct, *targs)
    R, M = tpp.materialize(ct, targs[0], targs[1], targs[4], targs[6], rr.tables, spec)
    for f in ("E", "O", "E_rounds", "O_rounds", "kmeans_error", "entropy"):
        assert _rel(getattr(out, f), getattr(rr, f)) <= TOL, f
    _close(out.R, R, rtol=0, atol=TOL)
    assert (out.M is None) == (not moments)
    if moments:
        assert _rel(out.M, M) <= TOL


@pytest.mark.parametrize("route", ["carry", "virtual", "rotate_rounds"])
def test_rotate_phase_reading_k6_table_matches_the_per_round_gram(monkeypatch, route):
    setup = list(_setup((2, 3), 4000, 4096))
    over = {"carry": dict(virtual_r=False), "virtual": {},
            "rotate_rounds": dict(virtual_r=False, max_iter_cluster=6)}[route]
    setup[1] = dataclasses.replace(setup[1], **over)
    ct = setup[1]
    real = cuda_rotate.reassign
    runs = {}
    for with_table in (True, False):
        if not with_table:  # K6's table withheld: the plain K7 round forms g itself
            monkeypatch.setattr(cuda_rotate, "reassign", lambda *a: (*real(*a)[:4], None))
        _, st, _, tiled = _states(*setup)  # the same generator seed: the same schedules
        runs[with_table] = tengine.cluster(ct, st, tiled=tiled)
    a, b = runs[True], runs[False]
    ta, tb = a.trace_lists(ct), b.trace_lists(ct)
    assert len(ta["objective_kmeans"]) >= 4  # init and three rounds or more
    np.testing.assert_array_equal(ta["kmeans_rounds"], tb["kmeans_rounds"])
    np.testing.assert_allclose(ta["objective_kmeans"], tb["objective_kmeans"], rtol=TOL)
    assert _rel(a.E, b.E) <= TOL and _rel(a.O, b.O) <= TOL
    assert (a.virt_pen is not None) == (route == "virtual")
    if route == "virtual":
        _close(a.virt_pen, b.virt_pen, rtol=TOL)
        _close(tengine.materialize_r(ct, a).R, tengine.materialize_r(ct, b).R, rtol=0,
               atol=TOL)
    else:
        _close(a.R, b.R, rtol=0, atol=TOL)
    if route != "rotate_rounds":
        assert _rel(a.tiled_moments, b.tiled_moments) <= TOL
