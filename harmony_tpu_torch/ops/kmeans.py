"""Centroid initialisation: randomized seeding + Lloyd rounds.

Counterpart of ``harmony_tpu/ops/kmeans.py`` (``kmeans_centers``,
src/utils.cpp:53-64). Draws come from an explicit ``torch.Generator``;
each function also takes the draws themselves (``init_idx`` and the
per-slot uniforms), so a test can feed it what ``jax.random`` drew.

A Lloyd round (:func:`_lloyd_round`) runs the kernel pair of
``csrc/kmeans.cu`` for CUDA tensors (two launches a round, counted in
``_lloyd_round.launches``) and its plain version
(:func:`lloyd_round_twin`) for CPU tensors; anything else raises. Neither
sums with float atomics, whose order, and so whose result, changes from run
to run (CUDA's ``index_add_``): the plain version adds one-hot products
over fixed cell chunks in order, the kernel gives every partial sum one
owner and a fixed order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import _build, graphs
from ..runtime import span

# cells per chunk of the one-hot cluster-sum product: bounds the (chunk, K)
# one-hot to a few tens of MB at K = 100
_CHUNK = 1 << 16
_SMEM_MAX = 232_448  # bytes of shared memory a CTA may use on Hopper
_MAX_BLOCKS = 264  # CTAs of the assign kernel at most: two waves of one a SM on 132 SMs
_LAUNCHES = 2  # kernel launches a round: assign + partial sums, then the update
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {
    "lloyd_round": [_build.PTR, _build.I64] + [_build.PTR] * 4 + [_build.INT] * 16
                   + [_build.PTR],
}


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


class LloydPlan(NamedTuple):
    """The assign kernel's layout: tiles of 128 ``halves`` cells, ``warps``
    a CTA (a warp: 128 cells against a pair of 8-cluster groups),
    ``pairs`` of groups a pass for the warps of one half, ``passes`` over
    the clusters, ``jt`` threads a cluster in the sums (16 dims each at
    most), ``stages`` of the tile (2: double-buffered), the sums in shared
    memory (``acc_smem``) or in the CTA's slab of the partials, and the
    bytes of shared memory."""

    halves: int
    warps: int
    pairs: int
    passes: int
    jt: int
    stages: int
    acc_smem: bool
    smem: int

    @property
    def tile(self) -> int:
        return 128 * self.halves


def lloyd_plan(K: int, d: int, itemsize: int) -> Optional[LloydPlan]:
    """The assign kernel's layout (csrc/kmeans.cu) for K clusters, d dims
    and X's ``itemsize``: the sums in shared memory and two stages of
    256-cell tiles where that fits a CTA's shared memory (at K = 100: d <=
    67 in float32), else the widest, the sums in the CTA's slab of the
    partials and one stage of 128-cell tiles. At least 8 warps (the spare
    ones skip their clusters past K). None if neither fits (at K = 100: d >
    204 in float32, d > 271 in a 2-byte dtype; at K = 300: d > 112 in
    float32)."""
    pairs_all = -(-K // 16)
    for acc_smem, stages, halves in ((True, 2, 2), (False, 1, 1)):
        passes = -(-pairs_all // (14 // halves))
        pairs = max(-(-pairs_all // passes), 8 // halves)
        warps = halves * pairs
        KP = 16 * pairs * passes
        T = 128 * halves
        jt = max(-(-d // 16), min(32 * warps // K, d))
        floats = (d * KP + KP + 4 * pairs * T + T + KP * (T // 32) + KP
                  + (-(-K * d // 4) * 4 if acc_smem else 0))
        smem = 4 * floats + stages * d * (T + 16 // itemsize) * itemsize
        if smem <= _SMEM_MAX:
            return LloydPlan(halves, warps, pairs, passes, jt, stages, acc_smem, smem)
    return None


def lloyd_grid(n_valid: int, tile: int):
    """(tiles, tiles a CTA, CTAs) of the assign kernel: contiguous, equal
    ranges of tiles set by n_valid and the tile alone, at most
    ``_MAX_BLOCKS`` CTAs and at least one."""
    n_tiles = -(-n_valid // tile)
    per = max(1, -(-n_tiles // _MAX_BLOCKS))
    return n_tiles, per, max(1, -(-n_tiles // per))


def _lloyd_round(X: torch.Tensor, Y: torch.Tensor, n_valid: int) -> torch.Tensor:
    """One Euclidean Lloyd iteration over the first ``n_valid`` cells of X
    (d, N); empty clusters keep their old centroids. Returns the new Y (d,
    K) in X's dtype. CPU tensors: :func:`lloyd_round_twin`; CUDA tensors:
    the kernel pair of ``csrc/kmeans.cu``, fp32 products by FMA."""
    if X.device.type == "cpu" and Y.device.type == "cpu":
        return lloyd_round_twin(X, Y, n_valid)
    d, N = X.shape
    K = Y.shape[1]
    if X.device.type != "cuda" or Y.device != X.device:
        raise ValueError(f"_lloyd_round: X on {X.device}, Y on {Y.device}: both on the CPU "
                         "or both on one CUDA device")
    if X.dtype not in _DTYPES or Y.dtype != X.dtype:
        raise ValueError(f"_lloyd_round: X {X.dtype}, Y {Y.dtype}: one of float32, "
                         "bfloat16, float16 for both")
    if Y.shape != (d, K) or not 0 <= n_valid <= N or X.stride(1) != 1:
        raise ValueError(f"_lloyd_round: X {tuple(X.shape)} (strides {X.stride()}), "
                         f"Y {tuple(Y.shape)}, n_valid {n_valid}: X's cells contiguous, "
                         "Y (d, K), n_valid <= N")
    plan = lloyd_plan(K, d, X.element_size())
    if plan is None:
        raise ValueError(f"_lloyd_round: K={K}, d={d} fit no layout of the Lloyd kernel")
    Y = Y.contiguous()
    n_tiles, per, n_blocks = lloyd_grid(n_valid, plan.tile)
    ldx = X.stride(0)
    vec = int(X.data_ptr() % 16 == 0 and ldx * X.element_size() % 16 == 0)
    part = torch.empty((n_blocks, K, d), dtype=torch.float32, device=X.device)
    part_count = torch.empty((n_blocks, K), dtype=torch.int32, device=X.device)
    Y_new = torch.empty_like(Y)
    lib = _build.load("kmeans", _SIGNATURES)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    _build.check(lib.lloyd_round(
        X.data_ptr(), ldx, Y.data_ptr(), Y_new.data_ptr(), part.data_ptr(),
        part_count.data_ptr(), n_valid, K, d, _DTYPES[X.dtype], plan.halves, plan.warps,
        plan.pairs, plan.passes, plan.jt, per, n_tiles, n_blocks, vec, plan.stages,
        int(plan.acc_smem), plan.smem, stream,
    ), "lloyd_round")
    graphs.count(_lloyd_round, _LAUNCHES)
    return Y_new


_lloyd_round.launches = 0


def lloyd_round_twin(X: torch.Tensor, Y: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain version of the Lloyd kernel pair: one-hot products over
    65,536-cell chunks added in order."""
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
