"""Frozen copies of the draws a Harmony job makes from its seed.

The port seeds one ``torch.Generator`` on the job's device with the job's
seed (``state.init_state``) and draws from it, in this order:

* the k-means seeding (``ops/kmeans.py``): the K starting cells by one
  ``randint``, then one float32 ``rand`` over the valid cells for each of
  the K picks, clamped to float32's ``tiny``;
* every Harmony iteration, at the start of its clustering phase, on the
  rotate schedule (``ops/rotate.py``, ``draw_schedules``): the rounds'
  rotations by one ``randint`` over the tiles, then one ``randperm`` of
  the blocks a round; on the permute schedule (``engine.cluster``): one
  ``randperm`` of the cells a round.

The reference makes the same calls on a generator seeded alike, so it
walks the same schedule without reading anything the program drew. The
calls are copied here, not imported: a change to the program's draws
is a change to what it computes, which the comparison should see.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def kmeans_starts(g: torch.Generator, n_valid: int, K: int) -> torch.Tensor:
    """The K starting cells of the seeding race, (K,) int64."""
    return torch.randint(0, n_valid, (K,), generator=g, device=g.device)


def kmeans_uniform(g: torch.Generator, n_valid: int) -> torch.Tensor:
    """One pick's uniforms over the valid cells, float32 on [tiny, 1)."""
    u = torch.rand(n_valid, generator=g, device=g.device, dtype=torch.float32)
    return torch.clamp(u, min=torch.finfo(torch.float32).tiny)


def rotate_schedule(g: torch.Generator, rounds: int, n_tiles: int,
                    n_blocks: int) -> List[Tuple[int, List[int]]]:
    """One clustering phase's (rotation, block order) a round."""
    rts = torch.randint(0, n_tiles, (rounds,), generator=g, device=g.device)
    orders = [torch.randperm(n_blocks, generator=g, device=g.device) for _ in range(rounds)]
    return [(int(rt), [int(b) for b in o.tolist()]) for rt, o in zip(rts.tolist(), orders)]


def permutations(g: torch.Generator, rounds: int, n: int) -> List[torch.Tensor]:
    """One clustering phase's cell permutation a round."""
    return [torch.randperm(n, generator=g, device=g.device) for _ in range(rounds)]
