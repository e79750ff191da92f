"""Engine phases: init_cluster, cluster (E-step rounds), correct (M-step).

Counterpart of the permute branches (per-round and fused) and the
single-device rotate branches (the stats carry with virtual R, and the
rounds that read and write R: K12 and the cell-granular round) of
``harmony_tpu/engine.py``
(``init_cluster_cpp`` src/harmony.cpp:131-156, ``cluster_cpp``
src/harmony.cpp:208-262, ``moe_correct_ridge_cpp``
src/harmony.cpp:345-638). PyTorch runs eagerly, so there is no jit: on
the host loop plain Python loops take the place of ``lax.while_loop``,
and the convergence tests read one scalar from the device; under
:func:`run_rounds` (a state with a device cursor) the tests stay on the
device, and the re-entry and the rounds a test may skip are guarded
regions (:func:`graphs.guarded`), which a CUDA graph replays as IF nodes.
Each phase returns a new state object; the trace buffers are written in
place (they are append-only with cursors).

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
import time
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import graphs, ops, sharding
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
from .runtime import PhaseTimers, active_timers, span
from .state import HarmonyState


def _push_objective_terms(cfg: HarmonyConfig, state: HarmonyState, terms) -> HarmonyState:
    """Append (total, dist, entropy, cross) to the kmeans traces, at the
    host cursor or, on a state with a device cursor (:func:`run_rounds`),
    at that cursor, which advances on the device."""
    i = state.n_kmeans
    bufs = (state.objective_kmeans, state.objective_kmeans_dist,
            state.objective_kmeans_entropy, state.objective_kmeans_cross)
    if state.cursor is None:
        for buf, v in zip(bufs, terms):
            buf[i] = v
    else:
        at = state.cursor[0:1]
        for buf, v in zip(bufs, terms):
            buf.index_copy_(0, at, v.reshape(1).to(buf.dtype))
        at.add_(1)
    return dataclasses.replace(state, n_kmeans=i + 1)


def _push_harmony(state: HarmonyState) -> HarmonyState:
    """objective_harmony gets the last kmeans objective (src/harmony.cpp:153,260)."""
    if state.cursor is None:
        state.objective_harmony[state.n_harmony] = state.objective_kmeans[state.n_kmeans - 1]
    else:
        c = state.cursor
        state.objective_harmony.index_copy_(
            0, c[1:2], state.objective_kmeans.index_select(0, c[0:1] - 1))
        c[1:2].add_(1)
    return dataclasses.replace(state, n_harmony=state.n_harmony + 1)


def _push_rounds(state: HarmonyState, iters) -> None:
    """kmeans_rounds gets the phase's round count, at the host cursor or
    the device one; correct advances both. ``iters`` is an int, or on a
    state with a device cursor the (1,) count the device ran."""
    if state.cursor is None:
        state.kmeans_rounds[state.n_rounds] = iters
    elif isinstance(iters, torch.Tensor):
        state.kmeans_rounds.index_copy_(0, state.cursor[2:3],
                                        iters.to(state.kmeans_rounds.dtype))
    else:
        state.kmeans_rounds.index_fill_(0, state.cursor[2:3], iters)


def _hold(state: HarmonyState, new: HarmonyState, fields: Sequence[str]) -> HarmonyState:
    """``new`` with its ``fields`` written into ``state``'s tensors of the
    same name: a guarded region (:func:`graphs.guarded`) leaves what it
    computes in buffers that exist before it, where the launches after it
    read them whether it ran or not."""
    kw = {}
    for f in fields:
        src, dst = getattr(new, f), getattr(state, f)
        if src is not dst:
            if src.dtype != dst.dtype or src.shape != dst.shape:
                raise RuntimeError(f"a guarded region's {f} is {src.dtype} "
                                   f"{tuple(src.shape)}, its buffer {dst.dtype} "
                                   f"{tuple(dst.shape)}")
            dst.copy_(src)
        kw[f] = dst
    return dataclasses.replace(new, **kw)


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
    with span("init_assign"):
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


def _kmeans_window_converged_t(cfg: HarmonyConfig, state: HarmonyState) -> torch.Tensor:
    """Sliding-window clustering convergence (src/harmony.cpp:176-189): the
    sum of the last ``window_size`` objectives against the window one step
    earlier, as a (1,) bool tensor where the trace lies, read at the host
    cursor or at the state's device cursor (as :func:`harmony_converged_t`
    reads its trace): no host read. Both read the ``window_size + 1``
    objectives with one ``index_select``, so the two give the same bits."""
    w = cfg.window_size
    tr = state.objective_kmeans
    at = torch.arange(-w - 1, 0, device=tr.device)
    v = tr.index_select(0, at + (state.n_kmeans if state.cursor is None
                                 else state.cursor[0:1]))
    obj_old, obj_new = v[:w].sum(), v[1:].sum()
    return ((torch.abs(obj_old - obj_new) / torch.abs(obj_old)) < cfg.epsilon_cluster).reshape(1)


def _kmeans_window_converged(cfg: HarmonyConfig, state: HarmonyState) -> bool:
    """The window test on the host: one read of
    :func:`_kmeans_window_converged_t`."""
    return bool(_kmeans_window_converged_t(cfg, state))


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
                         mesh, NT: int) -> torch.Tensor:
    """This rank's schedule table (``rotate.draw_schedules``' layout, one
    row a round) of ``rounds`` rounds over its ``NT`` tiles: every rank
    draws the rows of every shard, round by round (round r, shard s at r *
    size + s), and takes its own, so the generator stays in lockstep (the
    counterpart of the JAX package's ``fold_in(round_key, axis_index)``)."""
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
    ``schedules`` injects the schedule table (``rotate.draw_schedules``'
    layout: a row a round, the rotation, then the block order; injected
    pairs are made one with ``rotate.schedule_table`` where they are made);
    otherwise the table is drawn from the state's generator, all up front,
    and stays on the device, where K7's launches read their round's row.

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
    else:
        schedules = schedules.to(state.device)  # injected: where K7's launches read it
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
    def round_v2(s: HarmonyState, sched, last: bool):
        rs = rotate.RoundState(R=s.R, E=s.E, O=s.O, tile_O=tile_O,
                               kmeans_error=None, entropy=None)
        args = (Y32, rs, Pr32, sig32, th32, sched, layout,
                not static or (last and not virtual), moments if last else None,
                last and virtual)
        if mesh is None:
            return mod.rotate_update_round_v2(cfg, *args)
        return rotate.sharded_rotate_round_v2(cfg, mesh, *args, fn=mod.rotate_update_round_v2)

    if not static:
        # R written every round, the windowed early stop; the per-tile
        # table is carried in K6's buffer, so a round that a test skips
        # leaves it as the round before left it
        def round_fn(s: HarmonyState, sched):
            res = round_v2(s, sched, False)
            tile_O.copy_(res.tile_O)
            return res

        return _round_loop(cfg, state, round_fn, schedules)[0]
    for it in range(cfg.max_iter_cluster):
        res = round_v2(state, schedules[it], it == cfg.max_iter_cluster - 1)
        tile_O = res.tile_O
        state = _push_round(cfg, state, res)
    _push_rounds(state, cfg.max_iter_cluster)
    if moments is not None:
        state = dataclasses.replace(state, tiled_moments=res.M)
    if virtual:
        state = dataclasses.replace(state, virt_pen=res.pen, virt_blkmap=res.blkmap,
                                    virt_Zn=Zn, virt_Y=state.Y, virt_G=G)
    return _push_harmony(state)


def _round_loop(cfg: HarmonyConfig, state: HarmonyState, round_fn, draws,
                keep_last: bool = False):
    """Rounds that each read and write R, ``round_fn(state, draws[i])``,
    with the windowed early stop, first checked when the round index
    exceeds ``window_size``; then the phase's traces. Returns the state
    and the draw of the last round run.

    On a state with a device cursor (:func:`run_rounds`) the stop is made
    on the device, as the JAX package's ``while_loop`` makes it
    (harmony_tpu/engine.py:548-595): the first ``window_size + 2`` rounds,
    which no test can stop, run as they are; each later round is a guarded
    region (:func:`graphs.guarded`) on the phase's flag, which the device
    window test after a round clears. A guarded round writes R, E and O
    into the buffers of the round before it and, with ``keep_last``, its
    draw (a tensor) into a buffer that is returned; the phase's round count
    is the advance of the device cursor."""
    n, w = cfg.max_iter_cluster, cfg.window_size
    if state.cursor is None:
        iters = 0
        while iters < n:
            state = _push_round(cfg, state, round_fn(state, draws[iters]))
            iters += 1
            if iters - 1 > w and _kmeans_window_converged(cfg, state):
                break
        _push_rounds(state, iters)
        return _push_harmony(state), draws[iters - 1]
    start = state.cursor[0:1].clone()
    fixed = min(n, w + 2)
    go = torch.ones(1, dtype=torch.int32, device=state.device) if n > fixed else None
    last = draws[fixed - 1].clone() if keep_last and n > fixed else draws[fixed - 1]
    box = [state]

    def one(r: int) -> HarmonyState:
        s = _push_round(cfg, box[0], round_fn(box[0], draws[r]))
        if w < r < n - 1:
            go.masked_fill_(_kmeans_window_converged_t(cfg, s), 0)
        return s

    for r in range(fixed):
        box[0] = one(r)
    for r in range(fixed, n):
        def guarded_round(r=r):
            box[0] = _hold(box[0], one(r), ("R", "E", "O"))
            if keep_last:
                last.copy_(draws[r])

        graphs.guarded(go, guarded_round)
    state = box[0]
    _push_rounds(state, state.cursor[0:1] - start)
    return _push_harmony(state), last


def _cluster_rotate_written(cfg: HarmonyConfig, state: HarmonyState,
                            schedules: Optional[torch.Tensor] = None,
                            mesh=None) -> HarmonyState:
    """The rotate rounds without the stats carry, after the re-entry
    (harmony_tpu/engine.py:440-451, 548-595): every round reads the
    previous round's R for each block's old statistics and writes R again,
    under any budget. The phase layout is built once from the normalised
    Z_corr; the rounds are K12 (:func:`cuda_estep.rotate_update_round_v1`,
    its plain version under 'torch') on the tile route, or the
    cell-granular round (:func:`ops.estep.rotate_update_round`, plain
    PyTorch everywhere) below ``n_blocks * 128`` cells. Each round reads
    its row of the phase's schedule table (the rotation, then the block
    order; in tiles on the tile route, ``rotate.draw_schedules``, in cells
    on the cell route, :func:`ops.estep.draw_rotate_schedules`), drawn from
    the state's generator, all up front, and left on the device, or
    injected as ``schedules`` (``rotate.schedule_table`` of the pairs).
    On a mesh the route is the cell-granular one
    (:func:`ops.estep.sharded_rotate_update_round`): the table is global,
    every rank drawing the same rows, and read to the host once a phase."""
    if cfg.rotate_route == "cell":
        # a 2-byte engine's rounds run on float32 copies, R, E and O cast
        # back at each round's end, as the kernels' wrappers do
        f32 = cuda_estep.f32
        draw = draw_rotate_schedules
        rnd = (functools.partial(rotate_update_round, cfg, layout=make_rotate_layout(
            cfg, *f32(state.Z_corr), state.codes)) if mesh is None
            else functools.partial(sharded_rotate_update_round, cfg, mesh))

        def round_fn(s: HarmonyState, sched):
            res = rnd(*f32(s.Z_corr, s.Y, s.R, s.E, s.O), s.codes,
                      *f32(s.Pr_b, s.sigma, s.theta), sched)
            return cuda_estep.cast_back(res, s.R, s.E, s.O)
    else:
        layout = rotate.CodesLayout(
            Z_pad=rotate.pad_cells_to_tile(cfg, state.Z_corr.to(torch.float32)).contiguous(),
            codes_pad=rotate.make_codes_pad(cfg, state.codes))
        draw = rotate.draw_schedules
        v1 = (cuda_estep.rotate_update_round_v1 if cfg.estep_impl == "kernel"
              else rotate.rotate_update_round_v1)

        def round_fn(s: HarmonyState, sched):
            return v1(cfg, s.Y, s.R, s.E, s.O, s.Pr_b, s.sigma, s.theta, sched, None, layout)
    if schedules is None:
        schedules = draw(cfg, state.generator, cfg.max_iter_cluster)
    else:
        schedules = torch.as_tensor(schedules).to(state.device)  # where the rounds read it
    if mesh is not None:
        # the phase's one read: gloo's collectives keep a mesh on the host loop
        schedules = schedules.tolist()
    return _round_loop(cfg, state, round_fn, schedules)[0]


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
    _push_rounds(state, n_r)
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
    ``perms`` injects the (max_iter_cluster, N) permutations, and
    ``schedules`` the rotate schedule's draws, on every rotate route a
    schedule table (``rotate.schedule_table`` of the (rotation, block
    order) pairs: in tiles on the tile routes, in cells on the cell
    route); otherwise they are drawn from the state's generator, all up
    front. On a mesh (the rank's columns) the permutations and the
    cell-granular schedule table are global and every rank draws them;
    the per-round permute rounds are
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
    if state.cursor is None:
        if state.n_harmony != 1:
            state = _assign_from_centroids(cfg, state, mesh)[0]
    else:
        # on the device cursor the re-entry is a guarded region on
        # cursor[1] != 1, the JAX package's lax.cond
        # (harmony_tpu/engine.py:210-218)
        box = [state]

        def reenter():
            box[0] = _hold(box[0], _assign_from_centroids(cfg, box[0])[0],
                           ("Z_corr", "R", "E", "O"))

        graphs.guarded((state.cursor[1:2] != 1).to(torch.int32), reenter)
        state = box[0]
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
    state, last = _round_loop(cfg, state, round_fn, perms, keep_last=state.cursor is not None)
    if state.cursor is not None:
        # the permutation of the last round the device ran
        order[0] = torch.as_tensor(last, device=dev).long()
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
    if state.cursor is not None:
        state.cursor[2:3].add_(1)
    return dataclasses.replace(
        state, Z_corr=Z_corr, Y=Y_new, n_rounds=state.n_rounds + 1,
        tiled_moments=None, virt_G=None,
    )


def harmony_round(cfg: HarmonyConfig, state: HarmonyState, perms=None,
                  schedules=None, layout: Optional[MStepLayout] = None,
                  mesh=None, stamp=None) -> HarmonyState:
    """One Harmony round: cluster then correct (R/utils.R:26,35), on the
    run's M-step ``layout`` (None: dense). ``stamp``, where given, is
    called with 0 before ``cluster``, 1 between it and ``correct`` and 2
    after ``correct`` (:func:`_stamp`)."""
    layout = layout or MStepLayout()
    stamp = stamp or (lambda k: None)
    stamp(0)
    state = cluster(cfg, state, perms, schedules, layout.tiled, mesh)
    stamp(1)
    state = correct(cfg, state, layout, mesh)
    stamp(2)
    return state


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


def harmony_converged_t(cfg: HarmonyConfig, state: HarmonyState) -> torch.Tensor:
    """Harmony-level convergence (src/harmony.cpp:190-200) as a 0-d bool
    tensor where the trace lies, read at the host cursor or at the state's
    device cursor: no host read."""
    oh = state.objective_harmony
    if state.cursor is None:
        i = state.n_harmony
        obj_old, obj_new = oh[i - 2], oh[i - 1]
    else:
        j = state.cursor[1:2]
        obj_old, obj_new = oh.index_select(0, j - 2)[0], oh.index_select(0, j - 1)[0]
    return ((obj_old - obj_new) / torch.abs(obj_old)) < cfg.epsilon_harmony


def harmony_converged(cfg: HarmonyConfig, state: HarmonyState) -> bool:
    """Harmony-level convergence on the host: one read of
    :func:`harmony_converged_t`."""
    return bool(harmony_converged_t(cfg, state))


# ---- run_rounds: the iterations as one device program ---------------------

# the fields an iteration writes, virtual R's context first: its virt_Y is
# the state's Y, which the correction then replaces
_CARRY = ("virt_pen", "virt_blkmap", "virt_Zn", "virt_Y", "Z_corr", "Y", "R", "O", "E")
_TRACES = ("objective_kmeans", "objective_kmeans_dist", "objective_kmeans_entropy",
           "objective_kmeans_cross", "objective_harmony", "kmeans_rounds")
# the fields an iteration only reads
_INPUTS = ("Z_orig", "codes", "Pr_b", "batch_sizes", "sigma", "theta", "lamb")
# cached captures: each holds its static state and its graph's memory pool
GRAPH_CACHE_SIZE = 2
_graphs: "OrderedDict[tuple, _GraphEntry]" = OrderedDict()


def _stamp(stamps: torch.Tensor, ctl: torch.Tensor, k: int) -> None:
    """Stamp ``k`` (0: before ``cluster``, 1: between it and ``correct``, 2:
    after ``correct``) of the iteration ``ctl[0]`` into
    ``stamps[3 * ctl[0] + k]``: the card's global timer, the slot picked
    on the device (``graphs.stamp``); on the CPU the host's clock."""
    if stamps.device.type == "cuda":
        graphs.stamp(stamps, k, ctl[0:1], 3)
    else:
        stamps[3 * int(ctl[0]) + k] = time.perf_counter_ns()


def _stamp_buffer(cfg: HarmonyConfig, device) -> torch.Tensor:
    """The iteration stamps of one run_rounds call: three an iteration."""
    return torch.zeros(3 * cfg.harmony_trace_capacity, dtype=torch.int64, device=device)


def _record_iterations(timers: PhaseTimers, stamps, n_run: int, device: bool) -> None:
    """``cluster`` and ``correct`` of the ``n_run`` iterations run, from
    their stamps (nanoseconds, three an iteration), into ``timers``: device
    seconds on the card, host seconds on the CPU."""
    e = sum(stamps[3 * i + 1] - stamps[3 * i] for i in range(n_run)) * 1e-9
    m = sum(stamps[3 * i + 2] - stamps[3 * i + 1] for i in range(n_run)) * 1e-9
    for name, sec in (("cluster", e), ("correct", m)):
        timers.add(name, calls=n_run, **{"device_s" if device else "host_s": sec})


def _iteration(cfg: HarmonyConfig, state: HarmonyState, layout: MStepLayout,
               ctl: torch.Tensor, draws: Optional[torch.Tensor] = None,
               stamps: Optional[torch.Tensor] = None) -> HarmonyState:
    """One iteration of :func:`run_rounds`' loop, the body of the JAX
    package's ``while_loop``: a Harmony round with the traces at the
    state's device cursor, then the loop's control words advance on the
    device: ctl[0] (iterations run) by one, ctl[2] to the convergence test.
    ``draws`` (one row an iteration) injects the iteration's schedule table
    or permutations, the row picked by ctl[0] on the device. ``stamps``
    takes the iteration's three stamps (:func:`_stamp`), outside every
    guarded region, so a replay that runs the iteration runs all three."""
    d = None if draws is None else draws.index_select(0, ctl[0:1]).squeeze(0)
    kw = {"schedules": d} if cfg.shuffle_mode == "rotate" else {"perms": d}
    stamp = None if stamps is None else functools.partial(_stamp, stamps, ctl)
    state = harmony_round(cfg, state, layout=layout, stamp=stamp, **kw)
    ctl[0:1].add_(1)
    ctl[2:3].copy_(harmony_converged_t(cfg, state).reshape(1))
    return state


def _cursor_of(state: HarmonyState) -> torch.Tensor:
    return torch.tensor([state.n_kmeans, state.n_harmony, state.n_rounds], dtype=torch.int64,
                        device=state.device)


def _check_budget(cfg: HarmonyConfig, state: HarmonyState, n_max: int) -> None:
    """The traces hold cfg.max_iter_harmony iterations: refuse a budget
    past them (the device writes would run off their end, where the JAX
    package's writes clamp)."""
    if (state.n_harmony + n_max > cfg.harmony_trace_capacity
            or state.n_kmeans + n_max * cfg.max_iter_cluster > cfg.kmeans_trace_capacity):
        raise ValueError(f"run_rounds: {n_max} more iterations after {state.n_harmony - 1} "
                         f"exceed the trace capacity (max_iter_harmony="
                         f"{cfg.max_iter_harmony})")


def _eager_rounds(cfg: HarmonyConfig, state: HarmonyState, n_max: int, layout: MStepLayout,
                  draws: Optional[torch.Tensor]) -> HarmonyState:
    """run_rounds' loop with a Python ``if`` on the device flag (one host
    read an iteration): the plain version, and the loop on routes the
    graph does not take."""
    ctl = torch.tensor([0, n_max, 0], dtype=torch.int64, device=state.device)
    # guarded regions write into the carried tensors: copies, so the
    # caller's state keeps its own
    state = dataclasses.replace(state, cursor=_cursor_of(state), **{
        f: getattr(state, f).clone() for f in _CARRY if getattr(state, f) is not None})
    timers = active_timers()
    stamps = None if timers is None else _stamp_buffer(cfg, state.device)
    for _ in range(n_max):
        if not bool((ctl[2] == 0) & (ctl[0] < ctl[1])):
            break
        state = _iteration(cfg, state, layout, ctl, draws, stamps)
    n_run, nk, nh, nr, *ts = torch.cat(
        [ctl[:1], state.cursor] + ([] if stamps is None else [stamps])).tolist()
    if timers is not None:
        _record_iterations(timers, ts, n_run, state.device.type == "cuda")
    return dataclasses.replace(state, cursor=None, n_kmeans=nk, n_harmony=nh, n_rounds=nr)


@dataclasses.dataclass
class _GraphEntry:
    """A captured iteration and its static buffers: ``state`` holds every
    tensor the iteration reads or writes (its generator the one registered
    with the graph), ``ctl`` the loop's control words, ``draws`` the
    injected draws, ``stamps`` the iterations' stamps (:func:`_stamp`);
    ``layout`` is kept for the device tensors it holds."""

    state: HarmonyState
    ctl: torch.Tensor
    draws: Optional[torch.Tensor]
    layout: MStepLayout
    stamps: torch.Tensor
    graph: Optional[graphs.IterationGraph] = None


def _layout_key(layout: MStepLayout) -> tuple:
    """A capture reads the layout's tables: the batch-tiled one by value,
    the others (device tensors) by identity."""
    t = layout.tiled
    tkey = None if t is None else (
        t.tile, t.n_pure, hash(np.asarray(t.tile_joint).tobytes()),
        hash(np.asarray(t.joint_codes).tobytes()))
    return (tkey, None if layout.segments is None else id(layout.segments),
            None if layout.cells is None else id(layout.cells))


def _static_state(cfg: HarmonyConfig, state: HarmonyState) -> HarmonyState:
    """The capture's static buffers: copies of the state's tensors, and on
    the virtual-R route its context prefilled (the JAX package's run_rounds
    prefill, harmony_tpu/engine.py:729-752), so every iteration writes into
    the same buffers."""
    kw = {f: getattr(state, f).clone() for f in _INPUTS + _CARRY + _TRACES
          if getattr(state, f) is not None}
    dev = state.device
    if cfg.virtual_r and cfg.rotate_route == "carry" and "virt_pen" not in kw:
        NT = rotate.n_tiles(cfg)
        nb = len(rotate.block_sizes(cfg, NT)[0])
        kw.update(virt_pen=torch.zeros((nb, cfg.K, cfg.B), device=dev),
                  virt_blkmap=torch.zeros(NT, dtype=torch.int32, device=dev),
                  virt_Zn=torch.zeros((cfg.d, NT * cfg.estep_sub_tile), device=dev),
                  virt_Y=torch.zeros_like(state.Y))
    gen = torch.Generator(device=dev)
    return dataclasses.replace(state, **kw, generator=gen, cursor=_cursor_of(state),
                               tiled_moments=None, virt_G=None)


def _carry(S: HarmonyState, out: HarmonyState) -> None:
    """Copy what an iteration wrote into the static buffers, where the next
    replay reads it."""
    for f in _CARRY:
        src, dst = getattr(out, f), getattr(S, f)
        if src is not None and dst is not None and src is not dst:
            dst.copy_(src)


def _graph_rounds(cfg: HarmonyConfig, state: HarmonyState, n_max: int, layout: MStepLayout,
                  draws: Optional[torch.Tensor]) -> HarmonyState:
    """run_rounds on the card: the cached capture (made here on a miss,
    after one eager iteration, its warm-up), ``n_max`` replays less the
    eager one, one read (run_rounds' docstring). Its stretches are the
    spans ``graph_refresh``, ``graph_capture`` (a miss only),
    ``graph_replays`` and ``graph_read``; under active timers the read
    also takes the iterations' stamps."""
    dev = state.device
    timers = active_timers()
    key = (cfg, str(dev), _layout_key(layout), None if draws is None else tuple(draws.shape))
    entry = _graphs.get(key)
    if entry is None:
        while len(_graphs) >= GRAPH_CACHE_SIZE:
            _graphs.popitem(last=False)
        entry = _GraphEntry(state=_static_state(cfg, state),
                            ctl=torch.zeros(3, dtype=torch.int64, device=dev),
                            draws=None if draws is None else draws.clone(), layout=layout,
                            stamps=_stamp_buffer(cfg, dev))
        _graphs[key] = entry
    _graphs.move_to_end(key)
    S, ctl = entry.state, entry.ctl
    with span("graph_refresh"):
        # copy in once a run; the read-only inputs too (the graph reads
        # them where it was captured)
        for f in _INPUTS + _CARRY + _TRACES:
            src, dst = getattr(state, f), getattr(S, f)
            if src is not None and dst is not None and src is not dst:
                dst.copy_(src)
        if draws is not None:
            entry.draws.copy_(draws)
        for i, v in enumerate((0, n_max, 0)):
            ctl[i].fill_(v)
        for i, v in enumerate((state.n_kmeans, state.n_harmony, state.n_rounds)):
            S.cursor[i].fill_(v)
        S.n_kmeans, S.n_harmony, S.n_rounds = state.n_kmeans, state.n_harmony, state.n_rounds
        gen = S.generator
        gen.set_state(state.generator.get_state())
    eager = 0
    if entry.graph is None:
        with span("graph_capture"):
            # the capture's warm-up: the call's first iteration, run eagerly
            out = _iteration(cfg, S, layout, ctl, entry.draws,
                             None if timers is None else entry.stamps)
            _carry(S, out)
            S.n_kmeans, S.n_harmony, S.n_rounds = out.n_kmeans, out.n_harmony, out.n_rounds
            eager = 1
            # its regions: at most the re-entry and each round a window
            # test may skip; its stamps always, so one capture serves runs
            # with timers and without
            entry.graph = graphs.IterationGraph(
                lambda: _carry(S, _iteration(cfg, S, layout, ctl, entry.draws, entry.stamps)),
                ctl, gen, max_regions=1 + cfg.max_iter_cluster)
            run_rounds.captures += 1
            run_rounds.capture_s = entry.graph.capture_s
    run_rounds.eager = eager
    with span("graph_replays"):
        off0 = graphs.rng_offset(gen)
        entry.graph.counts.zero_()
        entry.graph.replay(n_max - eager)
    with span("graph_read"):
        # the run's one read: the iterations, the cursors, the launches
        # and, under timers, the stamps
        counts = entry.graph.counts
        n_run, nk, nh, nr, *rest = torch.cat(
            [ctl[:1], S.cursor, counts] + ([] if timers is None else [entry.stamps])).tolist()
        entry.graph.add_counts(rest[:counts.numel()])
        if timers is not None:
            _record_iterations(timers, rest[counts.numel():], n_run, True)
        if n_max > eager:
            # every replay advanced the generator by an iteration's draws,
            # whether its body ran or not: keep the draws made
            per = (graphs.rng_offset(gen) - off0) // (n_max - eager)
            graphs.set_rng_offset(gen, off0 + per * (n_run - eager))
        state.generator.set_state(gen.get_state())
        return dataclasses.replace(
            state, **{f: getattr(S, f).clone() for f in _CARRY + _TRACES
                      if getattr(S, f) is not None},
            n_kmeans=nk, n_harmony=nh, n_rounds=nr, cursor=None)


def run_rounds(cfg: HarmonyConfig, state: HarmonyState, n_max: int,
               layout: Optional[MStepLayout] = None, schedules=None,
               perms=None) -> HarmonyState:
    """Up to ``n_max`` whole Harmony iterations with the convergence test
    on the device (harmony_tpu/engine.py:709-767, run_rounds): each
    iteration is :func:`harmony_round` then :func:`harmony_converged_t`,
    and the loop goes on while ``~converged & (i < n_max)``, ``converged``
    False at the call's start, as the JAX package's ``while_loop`` does.
    The traces are written at a device cursor (``HarmonyState.cursor``),
    and the host cursors are set from it with one read at the end.

    On the card, on the routes of :attr:`HarmonyConfig.graph_route` (every
    one-device route with the kernels, the cell-granular rotate round
    included), one
    iteration is captured once per (config, device, M-step layout) into a
    CUDA graph whose launches sit inside IF conditional nodes on that
    predicate, each of the iteration's guarded regions (the re-entry, the
    rounds a window test may skip; :func:`graphs.guarded`) in one of its
    own on its device flag too (:class:`graphs.IterationGraph`), kept in
    a module-level cache of :data:`GRAPH_CACHE_SIZE` entries, as
    ``jax.jit`` keeps a program, and
    replayed ``n_max`` times back to back with no host read in between; a
    replay after convergence launches nothing of the body. The graph's
    static buffers are copies of the state's tensors, made when the entry
    is made and refreshed at every call (the read-only inputs too); the
    iteration's outputs are copied into them at the body's end, and the
    returned state holds fresh copies of what the iterations wrote (its
    read-only fields are the caller's). The first iteration of a call that
    captures is run eagerly first (the capture's warm-up) and counts as the
    call's first iteration, with the same bits (``run_rounds.eager`` is the
    last call's count of eager iterations: 1 on a capture, else 0). The
    state's generator is registered with the graph through a generator of
    the entry's, set from it before and put back after, so each replay
    draws anew and the draws continue as the host loop's (every draw of an
    iteration is made outside its guarded regions, as the host loop makes
    it). A capture that fails raises; ``run_rounds.captures`` counts
    the captures made and ``run_rounds.capture_s`` is the last capture's
    seconds.

    Elsewhere (CPU tensors: the plain version for the tests; the card off
    the graph route, i.e. without the kernels) the same iteration runs
    eagerly under a Python ``if`` on the device flag. ``schedules``
    (rotate) or ``perms`` (permute) inject each iteration's draws, one row
    an iteration (an iteration's schedule table, (max_iter_cluster, 1 +
    nb), in tiles on the tile routes and in cells on the cell route, or
    its permutations), for the tests; ``driver.harmonize`` never passes
    them on this path, as in the JAX package."""
    layout = layout or MStepLayout()
    given = schedules if cfg.shuffle_mode == "rotate" else perms
    if (perms if cfg.shuffle_mode == "rotate" else schedules) is not None:
        raise ValueError("run_rounds: schedules inject the rotate schedule's draws, perms the "
                         "permute schedule's")
    if n_max < 1:
        return state
    _check_budget(cfg, state, n_max)
    draws = None
    if given is not None:
        draws = torch.as_tensor(given).to(state.device)
        if draws.shape[0] < n_max:
            raise ValueError(f"run_rounds: {draws.shape[0]} iterations of draws for {n_max}")
        draws = draws[:n_max].contiguous()
    if state.device.type == "cuda" and cfg.graph_route:
        return _graph_rounds(cfg, state, n_max, layout, draws)
    return _eager_rounds(cfg, state, n_max, layout, draws)


run_rounds.captures = 0
run_rounds.capture_s = 0.0  # the last capture's seconds
run_rounds.eager = 0  # the last call's iterations run eagerly on the card


def clear_graphs() -> None:
    """Drop the cached captures of :func:`run_rounds` and their memory."""
    _graphs.clear()
