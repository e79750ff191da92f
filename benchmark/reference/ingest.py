"""Frozen copies of the port's cell geometry and ingest order.

Before its first round the port reorders the cells once (``api.ingest_perm``
with ``ops/tiled.py``'s batch-tiled order) and, on the rotate schedule,
pads the cell axis to whole tiles (``config._rotate_geometry``). Both are
functions of the codes, the sizes and the ingest seed. The reference
derives them again here, so it places every cell where the program does
and walks the same tiles and blocks, without reading the program's order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

# the program's defaults (config.HarmonyConfig): schedule tile, layout tile
ESTEP_SUB_TILE = 4096
MSTEP_TILE = 256
# permute runs the fused phase from this many cells (config.finalize_engine_config)
PERMUTE_FUSED_MIN_CELLS = 200_000


class Geometry(NamedTuple):
    """Where the cells sit: ``perm`` (engine position -> input cell, or
    None for the input order), the padded length of the cell axis and, on
    the rotate schedule, the tile width and the number of blocks."""

    perm: Optional[np.ndarray]
    n_pad: int
    tile: int  # rotate: cells a schedule tile (0 on permute)
    n_tiles: int
    n_blocks: int  # the reference's block count, ceil(1 / block_size)


def default_nclust(n_cells: int) -> int:
    """min(round(N / 30), 100), round half to even as R's."""
    return min(round(n_cells / 30), 100)


def n_blocks(block_size: float, n_cells: int) -> int:
    bs = 0.2 if n_cells < 40 else block_size
    return int(math.ceil(1.0 / bs - 1e-12))


def rotate_tile(N: int, d: int, K: int, B: int, nb: int) -> tuple:
    """(tile width T, padded length) of the rotate schedule on one device."""
    T = ESTEP_SUB_TILE
    pc_extra = 4 * K if B > 32 else 0
    budget = (12 if B <= 32 else 10) * 2**20
    while T > 512 and T * (8 * (K + d + B) + pc_extra) > budget:
        T //= 2
    per_block = max(N // max(nb, 1), 1)
    fit = 128
    while fit * 2 <= per_block:
        fit *= 2
    T = max(128, min(T, fit))
    return T, -(-N // T) * T


def layout_tile(n_pad: int, nb: int, n_joint: int) -> Optional[int]:
    """The batch-tiled layout's tile width, or None where the mixture
    gate refuses every width."""
    widths = [t for t in dict.fromkeys((MSTEP_TILE, 128)) if t >= 128]
    for factor in (4.0, 2.0):
        for t in widths:
            if (n_pad // t) / max(nb, 1) >= factor * max(n_joint, 1):
                return t
    return None


def batch_tiled_order(codes: np.ndarray, tile: int, seed: int) -> np.ndarray:
    """The batch-tiled ingest order of one covariate's codes (N,): each
    batch's cells shuffled, cut into tiles, the tiles interleaved by an
    evenly spread key, the remainders shuffled at the end."""
    rng = np.random.default_rng(seed)
    levels, joint = np.unique(codes, return_inverse=True)
    pure, rest = [], []
    for j in range(len(levels)):
        idx = np.flatnonzero(joint == j)
        rng.shuffle(idx)
        n_full = len(idx) // tile
        for t in range(n_full):
            pure.append(((t + rng.uniform(0.25, 0.75)) / n_full, idx[t * tile:(t + 1) * tile]))
        rest.append(idx[n_full * tile:])
    pure.sort(key=lambda p: p[0])
    tail = np.concatenate(rest) if rest else np.zeros(0, np.int64)
    rng.shuffle(tail)
    perm = np.concatenate([p[1] for p in pure] + [tail]) if pure else tail
    return perm.astype(np.int64)


def geometry(codes: np.ndarray, N: int, d: int, K: int, B: int, shuffle: str,
             block_size: float, seed: int, permute_fused: Optional[bool] = None) -> Geometry:
    """The program's cell placement for one covariate's ``codes``: the
    ingest order (batch-tiled where the route and the mixture gate take it,
    else on rotate a plain permutation from ``seed``, on the per-round
    permute route none) and the rotate tiles."""
    nb = n_blocks(block_size, N)
    if shuffle == "rotate":
        if N < nb * 128:
            raise ValueError("the cell-granular rotate round has no reference here")
        T, n_pad = rotate_tile(N, d, K, B, nb)
        tiled = True
    else:
        T, n_pad = 0, N
        tiled = (N >= PERMUTE_FUSED_MIN_CELLS and K <= 256) if permute_fused is None \
            else bool(permute_fused)
    perm = None
    if tiled:
        t = layout_tile(n_pad, nb, len(np.unique(codes)))
        if t:
            perm = batch_tiled_order(codes, t, seed)
        elif shuffle == "rotate":
            perm = np.random.default_rng(seed).permutation(N)
    nt = n_pad // T if T else 0
    return Geometry(perm=perm, n_pad=n_pad, tile=T, n_tiles=nt,
                    n_blocks=min(nb, nt) if T else nb)
