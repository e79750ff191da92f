"""Engine phases: init_cluster, cluster (E-step rounds), correct (M-step).

Counterpart of the permute branches (per-round and fused) and the
single-device rotate branches (the stats carry with virtual R, and the
rounds that read and write R: K12 and the cell-granular round) of
``harmony_tpu/engine.py``
(``init_cluster_cpp`` src/harmony.cpp:131-156, ``cluster_cpp``
src/harmony.cpp:208-262, ``moe_correct_ridge_cpp``
src/harmony.cpp:345-638). PyTorch runs eagerly, so there is no jit:
plain Python loops take the place of
``lax.while_loop``, and the convergence tests read one scalar from the
device. Each phase returns a new state object; the trace buffers are
written in place (they are append-only with cursors).

On a mesh (``mesh``, a ``sharding.CellMesh``; harmony_tpu/engine.py's
``mesh=`` branches) the state holds the rank's columns and the replicated
cluster state; the phases run the kernels per shard and all-reduce the
statistics where the JAX package psums them. Every route runs on a mesh,
in float32, bf16 and float16: the stats-carrying rotate route (R written or
virtual; K6, K7, K10, K11 per shard), the fused permute phase, the
per-round permute schedule and the cell-granular rotate round (global
blocks, plain PyTorch per rank, as the JAX package runs XLA there; the
cell-granular round also takes ``rotate_stats_carry=False`` on a mesh,
K12 having no sharded form), each with the batch-tiled, segmented or
dense M-step (K4/K5 per shard). The state's generator stays replicated: every
rank makes every draw, so the ranks stay in lockstep and no collective
waits on a rank that took another branch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ops, sharding
from .config import HarmonyConfig
from .ops import cuda_estep, cuda_permute, cuda_ridge, cuda_rotate, permute_phase, rotate
from .ops.estep import (block_update_round, draw_rotate_schedules, make_rotate_layout,
                        rotate_update_round, sharded_block_update_round,
                        sharded_rotate_update_round)
from .ops.normalize import l2_normalize_columns
from .ops.objective import xlogx
from .ops.ridge import full_tile_joint
from .ops.segments import CovariateSegments, build_segments
from .ops.tiled import TiledCells, detect_tiled_layout
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


def _assign_from_centroids(cfg: HarmonyConfig, state: HarmonyState, mesh=None):
    """Recompute R, E, O from (Y, Z_corr) (src/harmony.cpp:141-150, 220-227);
    on a mesh R of the rank's cells, E and O summed over the ranks in one
    all-reduce.

    Returns (state, R, dist), from which init takes its objective terms."""
    Z = l2_normalize_columns(state.Z_corr)
    dist = ops.compute_distances(state.Y, Z)
    R = ops.initial_assignments(dist, state.sigma)
    nv = cfg.N if mesh is None else sharding.valid_cells(cfg, mesh)
    if R.shape[1] != nv:
        # pad cells carry zero weight in every statistic
        R[:, nv:] = 0.0
    if mesh is None:
        O = ops.compute_O(R, state.codes, cfg.covariate_offsets, cfg.B)
        E = ops.compute_E(R, state.Pr_b)
    else:
        # the rank's sums in float32, rounded to the engine dtype once summed
        Rf = R.float()
        rsum, O = sharding.all_reduce_many(
            [Rf.sum(dim=1), ops.compute_O(Rf, state.codes, cfg.covariate_offsets, cfg.B)], mesh)
        E = rsum.to(R.dtype)[:, None] * state.Pr_b[None, :]
        O = O.to(R.dtype)
    return dataclasses.replace(state, Z_corr=Z, R=R, E=E, O=O), R, dist


def _init_common(cfg: HarmonyConfig, state: HarmonyState, mesh=None) -> HarmonyState:
    state, R, dist = _assign_from_centroids(cfg, state, mesh)
    Rf = R.float()
    kerr = (Rf * dist.float()).sum()
    ent = (state.sigma.float()[:, None] * xlogx(Rf)).sum()
    if mesh is not None:
        kerr, ent = sharding.all_reduce_many([kerr, ent], mesh)
    terms = ops.objective_from_stats(
        cfg, kerr, ent, state.O, state.E, state.sigma, state.theta
    )
    return _push_harmony(_push_objective_terms(cfg, state, terms))


def init_cluster(cfg: HarmonyConfig, state: HarmonyState, init_idx=None,
                 uniforms=None, mesh=None) -> HarmonyState:
    """K-means centroid init + first assignments (src/harmony.cpp:131-156).
    ``init_idx``/``uniforms`` inject the seeding draws (ops/kmeans.py). On a
    mesh every rank runs the k-means on the gathered cells with the same
    generator draws, and rank 0's centroids are broadcast, so every rank
    starts from the same Y bit for bit."""
    Z = state.Z_corr if mesh is None else sharding.gather_cells(state.Z_corr, mesh)
    Y = ops.kmeans_centers(
        Z, cfg.K, generator=state.generator, n_valid=cfg.N,
        init_idx=init_idx, uniforms=uniforms,
    )
    del Z
    Y = l2_normalize_columns(Y)
    if mesh is not None:
        Y = sharding.broadcast(Y.contiguous(), mesh)
    state = dataclasses.replace(state, Y=Y)
    return _init_common(cfg, state, mesh)


def init_cluster_from(cfg: HarmonyConfig, state: HarmonyState, Y0, mesh=None) -> HarmonyState:
    """Init with injected centroids (the parity hook)."""
    Y0 = torch.as_tensor(Y0, device=state.device).to(state.Z_corr.dtype)
    state = dataclasses.replace(state, Y=l2_normalize_columns(Y0))
    return _init_common(cfg, state, mesh)


def _kmeans_window_converged(cfg: HarmonyConfig, state: HarmonyState) -> bool:
    """Sliding-window clustering convergence (src/harmony.cpp:176-189): the
    sum of the last ``window_size`` objectives against the window one step
    earlier."""
    w, i = cfg.window_size, state.n_kmeans
    tr = state.objective_kmeans
    obj_new = tr[i - w : i].sum()
    obj_old = tr[i - 1 - w : i - 1].sum()
    return bool((torch.abs(obj_old - obj_new) / torch.abs(obj_old)) < cfg.epsilon_cluster)


def _push_round(cfg: HarmonyConfig, state: HarmonyState, res) -> HarmonyState:
    state = dataclasses.replace(state, R=res.R, E=res.E, O=res.O)
    terms = ops.objective_from_stats(
        cfg, res.kmeans_error, res.entropy, res.O, res.E, state.sigma, state.theta,
    )
    return _push_objective_terms(cfg, state, terms)


def _virtual_gate(cfg: HarmonyConfig, tiled: Optional[TiledCells]) -> bool:
    """May this run take virtual R, no (K, N) write during the rounds
    (harmony_tpu/engine.py:127-143; the JAX 'pallas' is the port's
    'kernel', whose wrappers run their plain versions on CPU tensors)?"""
    return bool(
        cfg.virtual_r
        and tiled is not None
        and cfg.shuffle_mode == "rotate"
        and cfg.estep_impl == "kernel"
        and cfg.rotate_route == "carry"
        and cfg.max_iter_cluster <= cfg.window_size + 2
        and cfg.estep_sub_tile % tiled.tile == 0
    )


def draw_shard_schedules(cfg: HarmonyConfig, generator: torch.Generator, rounds: int,
                         mesh, NT: int) -> list:
    """This rank's (rotation, block order) pair of each of ``rounds`` rounds
    over its ``NT`` tiles: every rank draws the pairs of every shard, round
    by round (round r, shard s at r * size + s), and takes its own, so the
    generator stays in lockstep (the counterpart of the JAX package's
    ``fold_in(round_key, axis_index)``)."""
    every = rotate.draw_schedules(cfg, generator, rounds * mesh.size, NT)
    return every[mesh.rank::mesh.size]


def _cluster_rotate(cfg: HarmonyConfig, state: HarmonyState,
                    schedules: Optional[Sequence] = None,
                    tiled: Optional[TiledCells] = None, mesh=None) -> HarmonyState:
    """The stats-carrying rotate phase (harmony_tpu/engine.py:403-608).

    K6 runs on every entry: it normalises the padded Z_corr and recomputes
    O, E and the per-tile table from the centroids (no first-entry branch:
    right after init the recompute is a numerical no-op), and returns the
    phase's Gram table G = (Y^T Zn)^T, which the rounds read on the layout
    (Y and Zn are fixed within the phase; 4 K Npt bytes, dropped with the
    layout at the phase's end, or under virtual R kept on the state for
    the correction's K10). Then the rounds.
    With the default budget (max_iter_cluster <= window_size + 2) the
    windowed early stop cannot fire and every round runs; only the last
    writes R, and with a batch-tiled layout it also fuses the M-step's
    joint-batch moments, which ride on the state (``tiled_moments``) to the
    correction, so K8 does not run (on layout tiles that are not whole
    64-cell pieces too: K7 splits a piece's moments at a tile boundary).
    Under virtual R (:func:`_virtual_gate`) the last round writes no R
    either: it stores its penalty tables and the state carries the
    virtual-R context, from which the correction and
    :func:`materialize_r` recompute R. A larger
    budget writes R every round and stops early as the permute path does.
    ``schedules`` injects the (rotation, block order) pair of each round;
    otherwise they are drawn from the state's generator, all up front.

    On a mesh K6 and K7 run on the rank's tiles through the sharded wrappers
    (one all-reduce of O after K6, one of the deltas, the objective terms
    and the moments after each round), each round with the rank's own
    schedule (:func:`draw_shard_schedules`; ``schedules`` then injects the
    rank's own); the penalty tables of virtual R are the rank's, its map in
    global block ids."""
    mod = cuda_rotate if cfg.estep_impl == "kernel" else rotate
    if schedules is None and mesh is None:
        schedules = rotate.draw_schedules(cfg, state.generator, cfg.max_iter_cluster)
    elif schedules is None:
        schedules = draw_shard_schedules(cfg, state.generator, cfg.max_iter_cluster, mesh,
                                         state.Z_corr.shape[1] // cfg.estep_sub_tile)
    codes_pad = rotate.make_codes_pad(cfg, state.codes, mesh)
    # K6 and K7's moments read the storage dtype (bf16 too) where it lies;
    # the centroids and the per-cluster and per-batch vectors go to the
    # kernels as float32 (Y is fixed within the phase)
    Y32, sig32, Pr32, th32 = (t.to(torch.float32)
                              for t in (state.Y, state.sigma, state.Pr_b, state.theta))
    # a shard is whole tiles already (the mesh pads the axis to them)
    Z_raw = (state.Z_corr if mesh is not None
             else rotate.pad_cells_to_tile(cfg, state.Z_corr)).contiguous()
    if mesh is None:
        Zn, tile_O, O, E, G = mod.reassign(cfg, Y32, sig32, Pr32, Z_raw, codes_pad)
    else:
        Zn, tile_O, O, E, G = rotate.sharded_reassign(cfg, mesh, Y32, sig32, Pr32, Z_raw,
                                                      codes_pad, fn=mod.reassign)
    dt = state.Z_corr.dtype
    state = dataclasses.replace(state, Z_corr=Zn[:, : state.Z_corr.shape[1]].to(dt),
                                O=O.to(dt), E=E.to(dt))
    layout = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G)
    static = cfg.max_iter_cluster <= cfg.window_size + 2
    moments = None
    virtual = _virtual_gate(cfg, tiled)
    if static and tiled is not None and cfg.estep_sub_tile % tiled.tile == 0:
        tj = full_tile_joint(cfg, tiled)
        moments = rotate.MomentsSpec(
            Z_orig=(rotate.pad_cells_to_tile(cfg, state.Z_orig) if mesh is None
                    else state.Z_orig).contiguous(),
            tile_joint=(tj if mesh is None
                        else sharding.shard_tile_table(cfg, mesh, tj, tiled.tile)),
            n_joint=int(tiled.joint_codes.shape[1]), tile=int(tiled.tile),
        )
    iters = 0
    while iters < cfg.max_iter_cluster:
        rt, order = schedules[iters]
        last = iters == cfg.max_iter_cluster - 1
        rs = rotate.RoundState(R=state.R, E=state.E, O=state.O, tile_O=tile_O,
                               kmeans_error=None, entropy=None)
        args = (Y32, rs, Pr32, sig32, th32, rt, order, layout,
                not static or (last and not virtual), moments if last else None,
                last and virtual)
        if mesh is None:
            res = mod.rotate_update_round_v2(cfg, *args)
        else:
            res = rotate.sharded_rotate_round_v2(cfg, mesh, *args,
                                                 fn=mod.rotate_update_round_v2)
        tile_O = res.tile_O
        state = _push_round(cfg, state, res)
        iters += 1
        if (not static and iters - 1 > cfg.window_size
                and _kmeans_window_converged(cfg, state)):
            break
    state.kmeans_rounds[state.n_rounds] = iters
    if moments is not None:
        state = dataclasses.replace(state, tiled_moments=res.M)
    if virtual:
        state = dataclasses.replace(state, virt_pen=res.pen, virt_blkmap=res.blkmap,
                                    virt_Zn=Zn, virt_Y=state.Y, virt_G=G)
    return _push_harmony(state)


def _round_loop(cfg: HarmonyConfig, state: HarmonyState, round_fn, draws) -> HarmonyState:
    """Rounds that each read and write R, ``round_fn(state, draws[i])``,
    with the windowed early stop, first checked when the round index
    exceeds ``window_size``; then the phase's traces."""
    iters = 0
    while iters < cfg.max_iter_cluster:
        state = _push_round(cfg, state, round_fn(state, draws[iters]))
        iters += 1
        if iters - 1 > cfg.window_size and _kmeans_window_converged(cfg, state):
            break
    state.kmeans_rounds[state.n_rounds] = iters
    return _push_harmony(state)


def _cluster_rotate_written(cfg: HarmonyConfig, state: HarmonyState,
                            schedules: Optional[Sequence] = None, mesh=None) -> HarmonyState:
    """The rotate rounds without the stats carry, after the re-entry
    (harmony_tpu/engine.py:440-451, 548-595): every round reads the
    previous round's R for each block's old statistics and writes R again,
    under any budget. The phase layout is built once from the normalised
    Z_corr; the rounds are K12 (:func:`cuda_estep.rotate_update_round_v1`,
    its plain version under 'torch') on the tile route, or the
    cell-granular round (:func:`ops.estep.rotate_update_round`, plain
    PyTorch everywhere) below ``n_blocks * 128`` cells. ``schedules``
    injects each round's (rotation, block order) pair, in the units of the
    route (tiles, or cells); otherwise they are drawn from the state's
    generator, all up front. On a mesh the route is the cell-granular one
    (:func:`ops.estep.sharded_rotate_update_round`): the schedule is
    global, every rank drawing the same pairs."""
    if cfg.rotate_route == "cell":
        # a bf16 engine's rounds run on float32 copies, R, E and O cast
        # back at each round's end, as the kernels' wrappers do
        f32 = cuda_estep.f32
        draw = draw_rotate_schedules
        rnd = (functools.partial(rotate_update_round, cfg, layout=make_rotate_layout(
            cfg, *f32(state.Z_corr), state.codes)) if mesh is None
            else functools.partial(sharded_rotate_update_round, cfg, mesh))

        def round_fn(s: HarmonyState, sched):
            res = rnd(*f32(s.Z_corr, s.Y, s.R, s.E, s.O), s.codes,
                      *f32(s.Pr_b, s.sigma, s.theta), *sched)
            return cuda_estep.cast_back(res, s.R, s.E, s.O)
    else:
        layout = rotate.CodesLayout(
            Z_pad=rotate.pad_cells_to_tile(cfg, state.Z_corr.to(torch.float32)).contiguous(),
            codes_pad=rotate.make_codes_pad(cfg, state.codes))
        draw = rotate.draw_schedules
        v1 = (cuda_estep.rotate_update_round_v1 if cfg.estep_impl == "kernel"
              else rotate.rotate_update_round_v1)

        def round_fn(s: HarmonyState, sched):
            return v1(cfg, s.Y, s.R, s.E, s.O, s.Pr_b, s.sigma, s.theta, *sched, layout)
    if schedules is None:
        schedules = draw(cfg, state.generator, cfg.max_iter_cluster)
    return _round_loop(cfg, state, round_fn, schedules)


def _cluster_permute_fused(cfg: HarmonyConfig, state: HarmonyState, perms,
                           tiled: Optional[TiledCells], mesh=None) -> HarmonyState:
    """The fused R-gather-free phase (harmony_tpu/engine.py:284-354): all
    rounds through K2, then R once through K3, one objective pushed per
    round from the phase's per-round statistics. With a batch-tiled layout
    K3 also accumulates the M-step's joint-batch moments, which ride on the
    state (``tiled_moments``) to the correction; where the (K, d+1) table
    does not fit K3's register tiles the correction runs K8 instead. On a
    mesh the phase is :func:`permute_phase.sharded_permute_phase`, plain
    PyTorch on each rank with global blocks (the JAX package runs it in XLA,
    harmony_tpu/engine.py:246-267), and the correction sums the moments
    with K8 on the rank's tiles (harmony_tpu/engine.py:280-282)."""
    moments = None
    if tiled is not None and mesh is None and cuda_permute.moments_fit(cfg.K, cfg.d):
        moments = permute_phase.MomentsSpec(
            Z_orig=state.Z_orig.to(torch.float32).contiguous(),
            tile_joint=full_tile_joint(cfg, tiled),
            n_joint=int(tiled.joint_codes.shape[1]), tile=int(tiled.tile),
        )
    if mesh is not None:
        phase = functools.partial(permute_phase.sharded_permute_phase, cfg, mesh)
    else:
        phase = functools.partial(cuda_permute.permute_phase if cfg.estep_impl == "kernel"
                                  else permute_phase.permute_phase, cfg, moments=moments)
    out = phase(state.Z_corr, state.Y, state.E, state.O, state.codes, state.Pr_b,
                state.sigma, state.theta, perms)
    dt = state.R.dtype
    state = dataclasses.replace(state, R=out.R.to(dt), E=out.E.to(dt), O=out.O.to(dt),
                                tiled_moments=out.M)
    n_r = int(perms.shape[0])
    for it in range(n_r):
        terms = ops.objective_from_stats(
            cfg, out.kmeans_error[it], out.entropy[it], out.O_rounds[it],
            out.E_rounds[it], state.sigma, state.theta,
        )
        state = _push_objective_terms(cfg, state, terms)
    state.kmeans_rounds[state.n_rounds] = n_r
    return _push_harmony(state)


def cluster(
    cfg: HarmonyConfig,
    state: HarmonyState,
    perms: Optional[Sequence] = None,
    schedules: Optional[Sequence] = None,
    tiled: Optional[TiledCells] = None,
    mesh=None,
) -> HarmonyState:
    """One clustering phase: up to ``max_iter_cluster`` block-update rounds.

    The rotate schedule's stats-carrying route runs :func:`_cluster_rotate`,
    which takes ``tiled`` for its moment fusion and virtual R. Every other
    phase starts, on re-entry after a correction (harmony-trace cursor !=
    1, src/harmony.cpp:214-228), by re-normalising Z_corr and recomputing
    R, E and O from the centroids. Then the rotate schedule's other two
    routes (``cfg.rotate_route``) run :func:`_cluster_rotate_written`; the
    permute schedule, with ``cfg.permute_fused``, the fused phase
    (:func:`_cluster_permute_fused`, which takes ``tiled`` for its moment
    fusion), else update_R rounds with the windowed early stop, R carried
    in each round's block order and put back in the cells' order once at
    the phase's end.
    ``perms`` injects the (max_iter_cluster, N) permutations; otherwise
    they are drawn from the state's generator, all up front. On a mesh
    (the rank's columns) the
    permutations and the cell-granular schedules are global and every rank
    draws them; the per-round permute rounds are
    :func:`ops.estep.sharded_block_update_round`, R carried in the order
    of the rank's cells in each round's permutation, and the windowed
    early stop reads the all-reduced objective, so every rank stops at the
    same round.
    """
    if cfg.shuffle_mode == "rotate":
        if perms is not None:
            raise ValueError("perms drive the permute schedule; the rotate "
                             "schedule takes schedules=")
        if cfg.rotate_route == "carry":
            return _cluster_rotate(cfg, state, schedules, tiled, mesh)
    if state.n_harmony != 1:
        state = _assign_from_centroids(cfg, state, mesh)[0]
    if cfg.shuffle_mode == "rotate":
        return _cluster_rotate_written(cfg, state, schedules, mesh)
    dev = state.device
    if perms is None:
        perms = [
            torch.randperm(cfg.N, generator=state.generator, device=dev)
            for _ in range(cfg.max_iter_cluster)
        ]
    if cfg.permute_fused:
        perms = torch.stack([torch.as_tensor(p, device=dev).long() for p in perms])
        return _cluster_permute_fused(cfg, state, perms, tiled, mesh)
    update_round = (
        cuda_estep.block_update_round if cfg.estep_impl == "kernel"
        else functools.partial(block_update_round, carry=True)
    )
    # R is carried in each round's block order and put back in the cells'
    # order once, after the phase
    order = [None]

    def round_fn(s: HarmonyState, perm):
        perm = torch.as_tensor(perm, device=dev).long()
        if mesh is None:
            res = update_round(cfg, s.Z_corr, s.Y, s.R, s.E, s.O, s.codes, s.Pr_b, s.sigma,
                               s.theta, perm, order=order[0])
            order[0] = perm
            return res
        # plain PyTorch on float32 copies, cast back as the K1 wrapper does
        f32 = cuda_estep.f32
        res, order[0] = sharded_block_update_round(
            cfg, mesh, *f32(s.Z_corr, s.Y, s.R, s.E, s.O), s.codes,
            *f32(s.Pr_b, s.sigma, s.theta), perm, order=order[0])
        return cuda_estep.cast_back(res, s.R, s.E, s.O)
    state = _round_loop(cfg, state, round_fn, perms)
    if order[0] is not None:
        # on a mesh the pad cells are in no round: their R stays 0
        R = state.R.new_zeros((state.R.shape[0], state.Z_corr.shape[1]))
        state = dataclasses.replace(state, R=R.index_copy_(1, order[0], state.R))
    return state


def _virtual_context(cfg: HarmonyConfig, state: HarmonyState,
                     mesh=None) -> Optional[rotate.VirtualR]:
    """The state's virtual-R context as the correction takes it, or None."""
    if state.virt_pen is None:
        return None
    return rotate.VirtualR(
        pen=state.virt_pen, blkmap=state.virt_blkmap, Zn_pad=state.virt_Zn,
        codes_pad=rotate.make_codes_pad(cfg, state.codes, mesh), Y=state.virt_Y,
        Z_orig_pad=(rotate.pad_cells_to_tile(cfg, state.Z_orig) if mesh is None
                    else state.Z_orig).contiguous(),
        sigma=state.sigma, G=state.virt_G,
    )


def correct(cfg: HarmonyConfig, state: HarmonyState,
            layout: Optional[MStepLayout] = None, mesh=None) -> HarmonyState:
    """M-step: MoE ridge correction + centroid refresh (src/harmony.cpp:345-638);
    the run's ``layout`` (:func:`mstep_layout`; None: dense) selects the
    batch-tiled moments and correction, or the segmented ones. The moment
    table the phase's last round fused (``state.tiled_moments``: K3 on the
    permute path, K7 on the rotate path) is consumed here, so K8 does not
    run after it. On a virtual-R state the correction recomputes R from the
    state's context (K10, reading the phase's Gram table, which is consumed
    here too; without the table, on a state built from the JAX package's
    arrays, K11 writes R and K9 applies it) and never reads the stale R;
    the rest of the context stays on the state for :func:`materialize_r`
    (harmony_tpu/engine.py:643-657). On a mesh the batch-tiled M-step of
    ``ops.ridge`` on the rank's cells, the solve replicated."""
    layout = layout or MStepLayout()
    Z_corr, Y_new, _ = ops.moe_correct_ridge(
        cfg, state.Z_orig, state.R, state.O, state.E, state.codes,
        state.batch_sizes, state.lamb, state.Y, tiled=layout.tiled, segments=layout.segments,
        tiled_moments=state.tiled_moments, virtual=_virtual_context(cfg, state, mesh),
        cells=layout.cells, mesh=mesh,
    )
    return dataclasses.replace(
        state, Z_corr=Z_corr, Y=Y_new, n_rounds=state.n_rounds + 1,
        tiled_moments=None, virt_G=None,
    )


def harmony_round(cfg: HarmonyConfig, state: HarmonyState, perms=None,
                  schedules=None, layout: Optional[MStepLayout] = None,
                  mesh=None) -> HarmonyState:
    """One Harmony round: cluster then correct (R/utils.R:26,35), on the
    run's M-step ``layout`` (None: dense)."""
    layout = layout or MStepLayout()
    return correct(cfg, cluster(cfg, state, perms, schedules, layout.tiled, mesh), layout,
                   mesh)


def materialize_r(cfg: HarmonyConfig, state: HarmonyState, mesh=None) -> HarmonyState:
    """The user-facing (K, N) R of a virtual-R state, as the last clustering
    round would have written it (getR parity, src/harmony.cpp:646-649;
    harmony_tpu/engine.py:667-698), through K11 in the state's dtype. The
    identity on a state that did not take virtual R."""
    if state.virt_pen is None:
        return state
    args = (state.virt_Y.to(torch.float32), state.sigma.to(torch.float32), state.virt_pen,
            state.virt_blkmap, state.virt_Zn, rotate.make_codes_pad(cfg, state.codes, mesh))
    if mesh is None:
        R = cuda_rotate.materialize_r(cfg, *args, out_dtype=state.R.dtype)
    else:
        R = rotate.sharded_materialize_r(cfg, mesh, *args, out_dtype=state.R.dtype,
                                         fn=cuda_rotate.materialize_r)
    return dataclasses.replace(state, R=R)


class MStepLayout(NamedTuple):
    """The M-step layout of a run: at most one of ``tiled`` and ``segments``
    is set; neither means the dense M-step, whose K4/K5 kernels read
    ``cells``, the per-tile batch index of the codes."""

    tiled: Optional[TiledCells] = None
    segments: Optional[Tuple[CovariateSegments, ...]] = None
    cells: Optional[cuda_ridge.CellIndex] = None


def mstep_layout(cfg: HarmonyConfig, codes, device=None, mesh=None) -> MStepLayout:
    """The run's M-step layout, as ``harmony_tpu/engine.py:808-837`` picks
    it (the port's tile routes of the rotate schedule and fused permute
    phase, ``HarmonyConfig.tiled_route``, stand where the JAX package has
    ``estep_impl == 'pallas'``): the batch-tiled layout, detected from the
    cell order, under ``mstep_mode='auto'`` on those routes and under
    ``'tiled'`` on any, where finding none raises ``ValueError``; otherwise
    the segmented layout where ``cfg.use_segments`` holds, built on the
    host and moved to ``device`` once; otherwise the dense M-step, with the
    per-tile batch index of the codes (``cuda_ridge.cell_index``, built on
    ``device`` once a run) where its K4/K5 branch runs (one covariate,
    ``mstep_impl='kernel'``) and a tile fits the shapes. ``codes`` is the
    (ncov, N or Np) host array of the whole run in engine order; on a
    ``mesh`` the segments and the index are those of the rank's columns
    (the batch-tiled layout is global)."""
    codes = np.asarray(codes)
    if cfg.mstep_mode == "tiled" or (cfg.mstep_mode == "auto" and cfg.tiled_route):
        for t in dict.fromkeys((cfg.mstep_tile, 128)):
            tiled = detect_tiled_layout(codes, cfg.N, t)
            if tiled is not None:
                return MStepLayout(tiled=tiled)
        if cfg.mstep_mode == "tiled":
            raise ValueError(
                "mstep_mode='tiled' requires a batch-tiled cell order "
                "(ops.tiled.build_batch_tiled_order at ingest)"
            )
    if cfg.use_segments:
        return MStepLayout(segments=build_segments(cfg, codes, cfg.segment_tile, device, mesh))
    tile = cuda_ridge.index_tile(cfg.K, cfg.d, cfg.B)
    if cfg.mstep_impl != "kernel" or cfg.n_covariates != 1 or tile is None:
        return MStepLayout()
    # the state's codes: the first N cells, pad cells at code 0
    codes0 = np.zeros(cfg.Np, np.int32)
    codes0[: cfg.N] = codes[0][: cfg.N]
    if mesh is not None:
        codes0 = np.ascontiguousarray(sharding.shard_cells(codes0, cfg, mesh))
    return MStepLayout(cells=cuda_ridge.cell_index(
        torch.as_tensor(codes0, device=device), cfg.B, tile))


def harmony_converged(cfg: HarmonyConfig, state: HarmonyState) -> bool:
    """Harmony-level convergence (src/harmony.cpp:190-200)."""
    i = state.n_harmony
    obj_old = state.objective_harmony[i - 2]
    obj_new = state.objective_harmony[i - 1]
    return bool(((obj_old - obj_new) / torch.abs(obj_old)) < cfg.epsilon_harmony)
