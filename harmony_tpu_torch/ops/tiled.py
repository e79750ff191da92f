"""Batch-tiled cell layout: batch-pure cell tiles for an O(K·N·d) M-step.

The port's own copy of ``harmony_tpu/ops/tiled.py`` (numpy only, so the
port imports nothing of the JAX package). The ingest order it builds must
come out identical to the JAX package's for the same seed: the same numpy
draws in the same order.

The reference's M-step builds per-cluster normal equations through a sparse
design matrix (``Phi_Rk = Phi_moe * diag(R_k)``, src/harmony.cpp:561-616).
The dense formulation pays an extra factor B: the one-hot contraction
``kn,nb,dn->kbd`` costs O(K·N·B·d) FLOPs and re-reads the (K, N) assignment
matrix per batch. But each cell belongs to exactly one batch (per
covariate), so grouping cells by batch removes the B factor — the moments
become one (K, T)x(T, d) matmul per batch-pure cell tile plus a tiny
segment-sum over tiles.

This module builds (and detects) an *ingest* cell order with that
structure, replacing the plain random ingest shuffle of the rotate
schedule (``HarmonyConfig.shuffle_mode``):

* cells are grouped by their **joint** batch code (the combination of all
  covariate levels, so tiles are pure for every covariate at once),
  shuffled within each group;
* each group contributes ``floor(count / T)`` full tiles; the full tiles
  of all groups are **interleaved proportionally** (each group's tiles are
  spread evenly over the tile sequence), so any contiguous run of tiles —
  a rotate-schedule block — carries an approximately proportional batch
  mixture, as the reference's random blocks do (src/harmony.cpp:272-285);
* the remainders (< T cells per group) are concatenated, shuffled, into a
  trailing **mixed region** that the M-step handles with the dense path
  (< n_joint·T cells, a few percent at production sizes).

The E-step is completely agnostic to this order: the rotate schedule's
randomness (per-round rotation + block order) and the per-block semantics
are unchanged; only *which* cells sit in which tile is different — and the
reference itself draws a fresh random permutation each round, so any fixed
ingest order realises one sample of the same process.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class TiledCells(NamedTuple):
    """Static description of a batch-tiled cell layout.

    All fields are host numpy; the layout is fixed for a whole run.
    """

    tile_joint: np.ndarray  # (NT_pure,) int32 joint-batch id of each pure tile
    joint_codes: np.ndarray  # (ncov, n_joint) int32 per-covariate level of each joint id
    n_pure: int  # cells covered by pure tiles (= NT_pure * T)
    tile: int  # T, the cell-tile width


def count_joint_levels(codes: np.ndarray) -> int:
    """Number of distinct joint batch combinations present."""
    return _joint_factorize(np.asarray(codes))[1].shape[1]


def tiled_mixture_ok(
    n_cells_padded: int,
    tile: int,
    n_blocks: int,
    n_joint: int,
    factor: float = 2.0,
) -> bool:
    """Is a batch-tiled layout safe for the rotate schedule's blocks?

    A rotate block is a contiguous run of cells; with batch-pure tiles its
    batch mixture comes from the interleaving, accurate to ±1 tile per
    joint group. Requiring ≥ ``factor``·n_joint tiles per block bounds the
    per-block batch-share deviation by ~1/factor (the reference's random
    blocks are near-exact, src/harmony.cpp:272-285); below that the blocks
    degenerate toward batch-purity, which skews the diversity penalty —
    callers must fall back to the plain random ingest order. Convergence
    is schedule-robust down to factor ~2 (validated: same converged
    objective and χ² mixing as the cell-granular random schedule at
    1M cells × 100 batches, factor 3.9 — tools/exp_largeb_converge.py);
    the gate floor is 2.
    """
    tiles_per_block = (n_cells_padded // tile) / max(n_blocks, 1)
    return tiles_per_block >= factor * max(n_joint, 1)


def choose_tiled_tile(cfg, n_joint: int, n_shards: int = 1) -> Optional[int]:
    """Largest feasible layout-tile width for this run, or None.

    Prefers a width that keeps ≥4 interleaved tiles per joint group per
    rotate block (tries the configured ``mstep_tile`` first, then 128 —
    finer tiles keep the per-block mixture proportional at larger
    joint-level counts, at the cost of more per-step matmuls in the
    M-step kernels); accepts ≥2 as a floor — the batch-tiled M-step is
    ~10-50× cheaper than the gather-based fallback, which outweighs the
    coarser per-block mixture (±1 tile per group out of ≥2).

    On a mesh the rotate blocks are shard-local (each shard runs
    ``n_blocks`` blocks over its own tiles), so the mixture requirement
    applies to the per-shard slice of the global interleaved layout.
    """
    widths = [t for t in dict.fromkeys((cfg.mstep_tile, 128)) if t >= 128]
    per_shard = cfg.Np // max(n_shards, 1)
    for factor in (4.0, 2.0):
        for t in widths:
            if tiled_mixture_ok(per_shard, t, cfg.n_blocks, n_joint, factor):
                return t
    return None


def _joint_factorize(codes: np.ndarray):
    """(ncov, N) codes -> (joint id per cell (N,), joint_codes (ncov, n_joint))."""
    codes = np.asarray(codes)
    if codes.shape[0] == 1:
        levels, joint = np.unique(codes[0], return_inverse=True)
        return joint.astype(np.int64), levels[None, :].astype(np.int32)
    # lexicographic key over covariates
    key = codes[0].astype(np.int64)
    for c in range(1, codes.shape[0]):
        key = key * (codes[c].max() + 1) + codes[c]
    levels, joint = np.unique(key, return_inverse=True)
    # recover each joint level's per-covariate codes from a representative
    first = np.zeros(len(levels), dtype=np.int64)
    first[joint[::-1]] = np.arange(len(joint))[::-1]
    joint_codes = codes[:, first].astype(np.int32)
    return joint.astype(np.int64), joint_codes


def build_batch_tiled_order(
    codes: np.ndarray,  # (ncov, N) batch level codes per cell
    tile: int,
    seed: int = 0,
) -> tuple[np.ndarray, TiledCells]:
    """Return (perm (N,), TiledCells) — the batch-tiled ingest order.

    ``perm`` maps new position -> original cell index (apply as
    ``Z[:, perm]``). Within-group order is randomised (the analog of the
    plain random ingest shuffle), group tiles are interleaved evenly, and
    remainders land shuffled in the trailing mixed region.
    """
    codes = np.asarray(codes)
    N = codes.shape[1]
    rng = np.random.default_rng(seed)
    joint, joint_codes = _joint_factorize(codes)
    n_joint = joint_codes.shape[1]

    pure_parts = []  # (sort_key, tile_cells, joint_id)
    rest_parts = []
    for j in range(n_joint):
        idx = np.flatnonzero(joint == j)
        rng.shuffle(idx)
        n_full = len(idx) // tile
        for t in range(n_full):
            # spread group j's tiles evenly over [0, 1): any contiguous
            # window of tiles then holds ~proportional counts per group
            sort_key = (t + rng.uniform(0.25, 0.75)) / n_full
            pure_parts.append((sort_key, idx[t * tile : (t + 1) * tile], j))
        rest_parts.append(idx[n_full * tile :])

    pure_parts.sort(key=lambda p: p[0])
    tile_joint = np.asarray([p[2] for p in pure_parts], dtype=np.int32)
    rest = (
        np.concatenate(rest_parts)
        if rest_parts
        else np.zeros((0,), dtype=np.int64)
    )
    rng.shuffle(rest)
    if pure_parts:
        perm = np.concatenate([p[1] for p in pure_parts] + [rest])
    else:
        perm = rest
    n_pure = len(tile_joint) * tile
    layout = TiledCells(
        tile_joint=tile_joint,
        joint_codes=joint_codes,
        n_pure=int(n_pure),
        tile=int(tile),
    )
    return perm.astype(np.int64), layout


def detect_tiled_layout(
    codes: np.ndarray,  # (ncov, Np) codes in engine order (pads included)
    n_cells: int,
    tile: int,
) -> Optional[TiledCells]:
    """Detect a batch-tiled prefix in an existing cell order.

    Returns the TiledCells description of the longest prefix of full tiles
    that are joint-batch-pure, or None when fewer than half the cells sit
    in pure tiles (then the dense M-step is the better choice). Detection
    rather than configuration keeps the M-step dispatch decoupled from how
    the ingest order was produced.
    """
    codes = np.asarray(codes)[:, :n_cells]
    joint, joint_codes = _joint_factorize(codes)
    n_full = n_cells // tile
    if n_full == 0:
        return None
    tiles = joint[: n_full * tile].reshape(n_full, tile)
    pure = (tiles == tiles[:, :1]).all(axis=1)
    # the layout builder puts all pure tiles first; stop at the first
    # impure tile so the mixed region stays a contiguous trailing slice
    n_pure_tiles = int(np.argmin(pure)) if not pure.all() else n_full
    if n_pure_tiles * tile * 2 < n_cells:
        return None
    return TiledCells(
        tile_joint=tiles[:n_pure_tiles, 0].astype(np.int32),
        joint_codes=joint_codes,
        n_pure=int(n_pure_tiles * tile),
        tile=int(tile),
    )
