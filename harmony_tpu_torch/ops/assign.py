"""Assignment primitives and the reference's block geometry.

Counterpart of ``harmony_tpu/ops/assign.py``: distances, initial soft
assignments, and the split of a permutation into the reference's blocks
with its unequal final block (src/harmony.cpp:293-300).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import HarmonyConfig


def compute_distances(Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``dist = 2*(1 - Y^T Z)`` for L2-normalised columns (src/harmony.cpp:141)."""
    g = Y.t().float() @ Z.float()
    return (2.0 * (1.0 - g)).to(Z.dtype)


def initial_assignments(dist: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """R = column softmax of (-dist / sigma) (src/harmony.cpp:143-146). In
    a 2-byte dtype (bf16, float16) it takes ``jax.nn.softmax``'s steps,
    each rounded to that dtype: the exponentials of the shifted logits,
    their column sums in float32 rounded once, the quotient."""
    x = -dist / sigma[:, None]
    if x.dtype.itemsize != 2:
        return torch.softmax(x, dim=0)
    e = torch.exp(x - x.max(dim=0, keepdim=True).values)
    return e / e.float().sum(dim=0, keepdim=True).to(e.dtype)


def block_bounds(cfg: HarmonyConfig) -> Tuple[Tuple[int, int], ...]:
    """(start, size) of each block in permutation order."""
    nb, cpb = cfg.n_blocks, cfg.cells_per_block
    return tuple(
        (i * cpb, cpb if i < nb - 1 else cfg.last_block_size) for i in range(nb)
    )


def make_blocks(
    cfg: HarmonyConfig, perm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a permutation of [0, N) into the reference's blocks.

    Returns ``(cell_idx, valid)`` of shape (n_blocks, max_block_size): block
    ``i`` holds ``perm[i*cpb : i*cpb + size_i]``; slots past a block's size
    carry the sentinel index ``cfg.Np`` (an appended zero column past the
    padded cell axis). Indices are int64.
    """
    nb, cpb, smax = cfg.n_blocks, cfg.cells_per_block, cfg.max_block_size
    sizes = torch.full((nb,), cpb, dtype=torch.int64, device=perm.device)
    sizes[nb - 1] = cfg.last_block_size
    pos = torch.arange(smax, dtype=torch.int64, device=perm.device)
    valid = pos[None, :] < sizes[:, None]
    p_pad = torch.cat(
        [perm.to(torch.int64), torch.zeros(smax, dtype=torch.int64, device=perm.device)]
    )
    rows = torch.stack([p_pad[i * cpb : i * cpb + smax] for i in range(nb)])
    cell_idx = torch.where(valid, rows, torch.full_like(rows, cfg.Np))
    return cell_idx, valid

