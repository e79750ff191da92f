"""Centroid initialisation: randomized seeding + Lloyd rounds.

Counterpart of ``harmony_tpu/ops/kmeans.py`` (``kmeans_centers``,
src/utils.cpp:53-64). Draws come from an explicit ``torch.Generator``;
each function also takes the draws themselves (``init_idx`` and the
per-slot uniforms), so a test can feed it what ``jax.random`` drew.

Cluster sums are one-hot products over fixed cell chunks added in order,
not ``index_add_``: CUDA's ``index_add_`` sums with float atomics, whose
order, and so whose result, changes from run to run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..runtime import span

# cells per chunk of the one-hot cluster-sum product: bounds the (chunk, K)
# one-hot to a few tens of MB at K = 100
_CHUNK = 1 << 16


def _uniform(n: int, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """Uniform draws on [tiny, 1), as ``jax.random.uniform(minval=tiny)``."""
    u = torch.rand(n, generator=generator, device=device, dtype=dtype)
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def _seed_centroids(
    X: torch.Tensor,
    K: int,
    n_valid: int,
    generator: Optional[torch.Generator] = None,
    init_idx: Optional[torch.Tensor] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Distance-weighted random seeding (src/utils.cpp:10-49). X is (d, N).

    Slot k races every cell against its initial random column by the
    exponential-race trick (``argmin(-log(u) / dist)`` samples in proportion
    to distance); chosen cells are excluded (the reference's dedupe,
    src/utils.cpp:39-43). ``init_idx`` (K,) and ``uniforms`` (K vectors of
    n_valid) replace the generator's draws when given. The distances are in
    X's dtype; the draws and the race are float32 at least, as
    ``jax.random.uniform``'s default dtype makes them for a bf16 X.
    """
    dev, dt = X.device, X.dtype
    udt = torch.promote_types(dt, torch.float32)
    tiny = torch.finfo(dt).tiny
    if init_idx is None:
        init_idx = torch.randint(0, n_valid, (K,), generator=generator, device=dev)
    init_idx = torch.as_tensor(init_idx, device=dev).long()
    Y0 = X[:, init_idx]
    Xv = X[:, :n_valid]
    D = torch.abs(2.0 * (1.0 - Y0.t().float() @ Xv.float())).to(dt)  # (K, n_valid)
    chosen = torch.zeros(n_valid, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=udt, device=dev)
    picks = []
    for k in range(K):
        if uniforms is None:
            u = _uniform(n_valid, generator, dev, udt)
        else:
            u = torch.as_tensor(uniforms[k], device=dev).to(udt)
        prob = -torch.log(u) / torch.clamp(D[k], min=tiny)
        prob = torch.where(chosen, inf, prob)
        idx = torch.argmin(prob)
        chosen[idx] = True
        picks.append(idx)
    return X[:, torch.stack(picks)]


def _lloyd_round(X: torch.Tensor, Y: torch.Tensor, n_valid: int) -> torch.Tensor:
    """One Euclidean Lloyd iteration; empty clusters keep old centroids."""
    K = Y.shape[1]
    Yf = Y.float()
    sq = (Yf ** 2).sum(dim=0)
    sums = torch.zeros((X.shape[0], K), dtype=torch.float32, device=X.device)
    counts = torch.zeros(K, dtype=torch.float32, device=X.device)
    for a in range(0, n_valid, _CHUNK):
        Xc = X[:, a : min(a + _CHUNK, n_valid)].float()
        assign = torch.argmin(sq[:, None] - 2.0 * (Yf.t() @ Xc), dim=0)
        oh = torch.nn.functional.one_hot(assign, K).float()  # (chunk, K)
        sums = sums + Xc @ oh
        counts = counts + oh.sum(dim=0)
    Y_new = sums / torch.clamp(counts, min=1.0)[None, :]
    return torch.where(counts[None, :] > 0, Y_new, Yf).to(X.dtype)


def kmeans_centers(
    X: torch.Tensor,
    K: int,
    generator: Optional[torch.Generator] = None,
    iterations: int = 10,
    n_valid: Optional[int] = None,
    init_idx: Optional[torch.Tensor] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Seed + ``iterations`` Lloyd rounds (src/utils.cpp:53-64), the spans
    ``kmeans_seed`` and ``kmeans_lloyd``. X is (d, N)."""
    if n_valid is None:
        n_valid = X.shape[1]
    with span("kmeans_seed"):
        Y = _seed_centroids(X, K, n_valid, generator, init_idx, uniforms)
    with span("kmeans_lloyd"):
        for _ in range(iterations):
            Y = _lloyd_round(X, Y, n_valid)
    return Y
