"""Batch-segmented tile layout for the M-step moments.

The port's counterpart of ``harmony_tpu/ops/segments.py``. The
correction's heavy moments are segment sums over cells grouped by batch:
``S_c[k, b, :] = sum_{n: code_c(n)=b} R[k, n] Z[:, n]`` and the R-weighted
batch co-occurrences. The dense one-hot contractions cost O(K·N·B·d);
grouping each covariate's cells by level into tiles of T cells, every
tile wholly inside one level, reduces them to batched (T, K) x (T, d)
products costing O(K·N·d).

The layout is static per run (batch membership never changes): per
covariate, the cells sorted stably by level, each level's run padded to
whole tiles with the sentinel index Np (a zero column appended past the
padded cell axis); pad cells (index >= N) sit in no tile. It is built on
the host in numpy, exactly as the JAX package builds it, and moved to the
device once per run. It replaces the reference's per-batch cell index
(``index``, src/harmony.cpp:48-65) behind its per-batch column sums
(src/harmony.cpp:595-609).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import HarmonyConfig


@dataclasses.dataclass
class CovariateSegments:
    """Tiled, batch-pure cell layout of one covariate."""

    tile_cells: torch.Tensor  # (nt, T) int64 cell ids; sentinel Np = padding
    tile_batch: torch.Tensor  # (nt,) int64 local level of each tile
    pos: torch.Tensor  # (Np+1,) int64 flat tile slot of each cell; nt*T = none

    @property
    def n_tiles(self) -> int:
        return self.tile_cells.shape[0]

    @property
    def tile(self) -> int:
        return self.tile_cells.shape[1]


def build_segments(cfg: HarmonyConfig, codes, tile: int = 1024,
                   device=None, mesh=None) -> Tuple[CovariateSegments, ...]:
    """The layout of every covariate from the (ncov, N or Np) host codes
    (harmony_tpu/ops/segments.py:49-103); only the first N cells are read,
    and the cell axis is ``cfg.Np`` long. On a ``mesh`` the layout of the
    rank's columns (``sharding.cell_range``): its real cells, as its column
    ids, on its axis of ``Np / size`` cells."""
    codes = np.asarray(codes)
    first, end, Np = 0, cfg.N, cfg.Np
    if mesh is not None:
        from ..sharding import cell_range

        first, Np = cell_range(cfg, mesh)
        end, Np = min(Np, cfg.N), Np - first
    out = []
    for c in range(cfg.n_covariates):
        col = codes[c][first:end]
        order = np.argsort(col, kind="stable").astype(np.int64)
        counts = np.bincount(col[order], minlength=cfg.B_vec[c])
        tiles, tile_batch = [], []
        start = 0
        for b, cnt in enumerate(counts):
            for t in range(-(-int(cnt) // tile)):
                lo = start + t * tile
                hi = min(lo + tile, start + cnt)
                row = np.full(tile, Np, dtype=np.int64)
                row[: hi - lo] = order[lo:hi]
                tiles.append(row)
                tile_batch.append(b)
            start += cnt
        if not tiles:  # degenerate: no cells at all
            tiles, tile_batch = [np.full(tile, Np, dtype=np.int64)], [0]
        tile_cells = np.stack(tiles)
        nt = tile_cells.shape[0]
        pos = np.full(Np + 1, nt * tile, dtype=np.int64)
        pos[tile_cells.reshape(-1)] = np.arange(nt * tile, dtype=np.int64)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        out.append(CovariateSegments(tile_cells=as_t(tile_cells),
                                     tile_batch=as_t(np.asarray(tile_batch)),
                                     pos=as_t(pos)))
    return tuple(out)
