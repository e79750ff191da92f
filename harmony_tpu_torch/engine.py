"""Engine phases: init_cluster, cluster (E-step rounds), correct (M-step).

Counterpart of the permute branch of ``harmony_tpu/engine.py``
(``init_cluster_cpp`` src/harmony.cpp:131-156, ``cluster_cpp``
src/harmony.cpp:208-262, ``moe_correct_ridge_cpp`` src/harmony.cpp:345-638).
PyTorch runs eagerly, so there is no jit: plain Python loops take the place
of ``lax.while_loop``, and the convergence tests read one scalar from the
device. Each phase returns a new state object; the trace buffers are
written in place (they are append-only with cursors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import ops
from .config import HarmonyConfig
from .ops import cuda_estep
from .ops.estep import block_update_round
from .ops.normalize import l2_normalize_columns
from .ops.objective import xlogx
from .state import HarmonyState


def _push_objective_terms(cfg: HarmonyConfig, state: HarmonyState, terms) -> HarmonyState:
    """Append (total, dist, entropy, cross) to the kmeans traces."""
    i = state.n_kmeans
    for buf, v in zip(
        (state.objective_kmeans, state.objective_kmeans_dist,
         state.objective_kmeans_entropy, state.objective_kmeans_cross),
        terms,
    ):
        buf[i] = v
    return dataclasses.replace(state, n_kmeans=i + 1)


def _push_harmony(state: HarmonyState) -> HarmonyState:
    """objective_harmony gets the last kmeans objective (src/harmony.cpp:153,260)."""
    state.objective_harmony[state.n_harmony] = state.objective_kmeans[state.n_kmeans - 1]
    return dataclasses.replace(state, n_harmony=state.n_harmony + 1)


def _assign_from_centroids(cfg: HarmonyConfig, state: HarmonyState):
    """Recompute R, E, O from (Y, Z_corr) (src/harmony.cpp:141-150, 220-227).

    Returns (state, kmeans_error, entropy) so init can push an objective
    without a stored dist."""
    Z = l2_normalize_columns(state.Z_corr)
    dist = ops.compute_distances(state.Y, Z)
    R = ops.initial_assignments(dist, state.sigma)
    E = ops.compute_E(R, state.Pr_b)
    O = ops.compute_O(R, state.codes, cfg.covariate_offsets, cfg.B)
    Rf = R.float()
    kerr = (Rf * dist.float()).sum()
    ent = (state.sigma.float()[:, None] * xlogx(Rf)).sum()
    return dataclasses.replace(state, Z_corr=Z, R=R, E=E, O=O), kerr, ent


def _init_common(cfg: HarmonyConfig, state: HarmonyState) -> HarmonyState:
    state, kerr, ent = _assign_from_centroids(cfg, state)
    terms = ops.objective_from_stats(
        cfg, kerr, ent, state.O, state.E, state.sigma, state.theta
    )
    return _push_harmony(_push_objective_terms(cfg, state, terms))


def init_cluster(cfg: HarmonyConfig, state: HarmonyState, init_idx=None,
                 uniforms=None) -> HarmonyState:
    """K-means centroid init + first assignments (src/harmony.cpp:131-156).
    ``init_idx``/``uniforms`` inject the seeding draws (ops/kmeans.py)."""
    Y = ops.kmeans_centers(
        state.Z_corr, cfg.K, generator=state.generator, n_valid=cfg.N,
        init_idx=init_idx, uniforms=uniforms,
    )
    state = dataclasses.replace(state, Y=l2_normalize_columns(Y))
    return _init_common(cfg, state)


def init_cluster_from(cfg: HarmonyConfig, state: HarmonyState, Y0) -> HarmonyState:
    """Init with injected centroids (the parity hook)."""
    Y0 = torch.as_tensor(Y0, device=state.device).to(state.Z_corr.dtype)
    state = dataclasses.replace(state, Y=l2_normalize_columns(Y0))
    return _init_common(cfg, state)


def _kmeans_window_converged(cfg: HarmonyConfig, state: HarmonyState) -> bool:
    """Sliding-window clustering convergence (src/harmony.cpp:176-189): the
    sum of the last ``window_size`` objectives against the window one step
    earlier."""
    w, i = cfg.window_size, state.n_kmeans
    tr = state.objective_kmeans
    obj_new = tr[i - w : i].sum()
    obj_old = tr[i - 1 - w : i - 1].sum()
    return bool((torch.abs(obj_old - obj_new) / torch.abs(obj_old)) < cfg.epsilon_cluster)


def cluster(
    cfg: HarmonyConfig,
    state: HarmonyState,
    perms: Optional[Sequence] = None,
) -> HarmonyState:
    """One clustering phase: up to ``max_iter_cluster`` block-update rounds.

    On re-entry after a correction (harmony-trace cursor != 1,
    src/harmony.cpp:214-228) Z_corr is re-normalised and R/E/O recomputed
    from the centroids; then update_R rounds with the windowed early stop,
    first checked when the round index exceeds ``window_size``.
    ``perms`` injects the (max_iter_cluster, N) permutations; otherwise they
    are drawn from the state's generator, all up front.
    """
    if state.n_harmony != 1:
        state = _assign_from_centroids(cfg, state)[0]
    dev = state.device
    if perms is None:
        perms = [
            torch.randperm(cfg.N, generator=state.generator, device=dev)
            for _ in range(cfg.max_iter_cluster)
        ]
    update_round = (
        cuda_estep.block_update_round if cfg.estep_impl == "kernel"
        else block_update_round
    )
    iters = 0
    while iters < cfg.max_iter_cluster:
        perm = torch.as_tensor(perms[iters], device=dev).long()
        res = update_round(
            cfg, state.Z_corr, state.Y, state.R, state.E, state.O, state.codes,
            state.Pr_b, state.sigma, state.theta, perm,
        )
        state = dataclasses.replace(state, R=res.R, E=res.E, O=res.O)
        terms = ops.objective_from_stats(
            cfg, res.kmeans_error, res.entropy, res.O, res.E, state.sigma,
            state.theta,
        )
        state = _push_objective_terms(cfg, state, terms)
        iters += 1
        if iters - 1 > cfg.window_size and _kmeans_window_converged(cfg, state):
            break
    state.kmeans_rounds[state.n_rounds] = iters
    return _push_harmony(state)


def correct(cfg: HarmonyConfig, state: HarmonyState) -> HarmonyState:
    """M-step: MoE ridge correction + centroid refresh (src/harmony.cpp:345-638)."""
    Z_corr, Y_new, _ = ops.moe_correct_ridge(
        cfg, state.Z_orig, state.R, state.O, state.E, state.codes,
        state.batch_sizes, state.lamb, state.Y,
    )
    return dataclasses.replace(
        state, Z_corr=Z_corr, Y=Y_new, n_rounds=state.n_rounds + 1
    )


def harmony_round(cfg: HarmonyConfig, state: HarmonyState, perms=None) -> HarmonyState:
    """One Harmony round: cluster then correct (R/utils.R:26,35)."""
    return correct(cfg, cluster(cfg, state, perms))


def harmony_converged(cfg: HarmonyConfig, state: HarmonyState) -> bool:
    """Harmony-level convergence (src/harmony.cpp:190-200)."""
    i = state.n_harmony
    obj_old = state.objective_harmony[i - 2]
    obj_new = state.objective_harmony[i - 1]
    return bool(((obj_old - obj_new) / torch.abs(obj_old)) < cfg.epsilon_harmony)
