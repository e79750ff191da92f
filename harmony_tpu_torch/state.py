"""HarmonyState: the engine state as a dataclass of tensors.

The port's counterpart of ``harmony_tpu/state.py`` (the C++ engine's member
state, ``src/harmony.h:20-70``). Layout follows the JAX package, cells
last: Z_orig/Z_corr (d, N), Y (d, K), R (K, N), O/E (K, B), codes
(ncov, N). Trace buffers have fixed capacity with integer cursors.

The JAX state carries a PRNG key; here the randomness comes from a
``torch.Generator`` seeded from the same integer (``key`` holds
``[0, seed]``, the layout of ``jax.random.PRNGKey(seed)``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import HarmonyConfig
from .preprocess import DesignMatrix

_F32 = torch.float32

# Every array field of harmony_tpu.state.HarmonyState (state.py:43-76), in
# order; the cursors are Python ints here and 0-d int32 arrays there.
ARRAY_FIELDS = (
    "Z_orig", "Z_corr", "Y", "R", "O", "E", "codes", "Pr_b", "batch_sizes",
    "sigma", "theta", "lamb", "objective_kmeans", "objective_kmeans_dist",
    "objective_kmeans_entropy", "objective_kmeans_cross", "n_kmeans",
    "objective_harmony", "n_harmony", "kmeans_rounds", "n_rounds", "key",
)
_CURSORS = ("n_kmeans", "n_harmony", "n_rounds")


@dataclasses.dataclass
class HarmonyState:
    Z_orig: torch.Tensor
    Z_corr: torch.Tensor
    Y: torch.Tensor
    R: torch.Tensor
    O: torch.Tensor
    E: torch.Tensor

    codes: torch.Tensor  # (ncov, N) int32 local level ids
    Pr_b: torch.Tensor  # (B,)
    batch_sizes: torch.Tensor  # (B,)

    sigma: torch.Tensor  # (K,)
    theta: torch.Tensor  # (B,)
    lamb: torch.Tensor  # (B+1,)

    # Objective traces (fixed capacity + cursor), src/harmony.cpp:165-168.
    # Written in place by the engine.
    objective_kmeans: torch.Tensor
    objective_kmeans_dist: torch.Tensor
    objective_kmeans_entropy: torch.Tensor
    objective_kmeans_cross: torch.Tensor
    n_kmeans: int
    objective_harmony: torch.Tensor
    n_harmony: int
    kmeans_rounds: torch.Tensor  # (max_iter_harmony,) int32
    n_rounds: int

    seed: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.Z_orig.device

    def trace_lists(self, cfg: HarmonyConfig) -> Dict[str, np.ndarray]:
        """Host copies of the valid prefixes of all trace buffers."""
        nk, nh, nr = self.n_kmeans, self.n_harmony, self.n_rounds
        host = lambda t, n: t[:n].cpu().numpy()
        return {
            "objective_kmeans": host(self.objective_kmeans, nk),
            "objective_kmeans_dist": host(self.objective_kmeans_dist, nk),
            "objective_kmeans_entropy": host(self.objective_kmeans_entropy, nk),
            "objective_kmeans_cross": host(self.objective_kmeans_cross, nk),
            "objective_harmony": host(self.objective_harmony, nh),
            "kmeans_rounds": host(self.kmeans_rounds, nr),
        }


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def init_state(
    cfg: HarmonyConfig,
    Z: np.ndarray,
    design: DesignMatrix,
    sigma: np.ndarray,
    theta: np.ndarray,
    lamb: np.ndarray,
    seed: int,
    device,
) -> HarmonyState:
    """Build the initial state (``harmony::setup``, src/harmony.cpp:29-111):
    casts to the engine dtype, L2-normalises ``Z_corr`` columns
    (src/harmony.cpp:42) and computes the batch statistics. Clustering state
    stays zero until ``engine.init_cluster``."""
    dev = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    Z_orig = torch.as_tensor(np.asarray(Z), device=dev).to(dtype)
    norms = torch.linalg.vector_norm(Z_orig, dim=0, keepdim=True)
    Z_corr = Z_orig / torch.where(norms == 0, torch.ones_like(norms), norms)
    batch_sizes = design.batch_sizes().astype(np.float64)
    Pr_b = batch_sizes / cfg.N
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
    zf = lambda n: torch.zeros(n, dtype=_F32, device=dev)
    kcap, hcap = cfg.kmeans_trace_capacity, cfg.harmony_trace_capacity
    return HarmonyState(
        Z_orig=Z_orig,
        Z_corr=Z_corr,
        Y=torch.zeros((cfg.d, cfg.K), dtype=dtype, device=dev),
        R=torch.zeros((cfg.K, cfg.N), dtype=dtype, device=dev),
        O=torch.zeros((cfg.K, cfg.B), dtype=dtype, device=dev),
        E=torch.zeros((cfg.K, cfg.B), dtype=dtype, device=dev),
        codes=torch.as_tensor(design.codes.astype(np.int32), device=dev),
        Pr_b=t(Pr_b),
        batch_sizes=t(batch_sizes),
        sigma=t(sigma),
        theta=t(theta),
        lamb=t(lamb),
        objective_kmeans=zf(kcap),
        objective_kmeans_dist=zf(kcap),
        objective_kmeans_entropy=zf(kcap),
        objective_kmeans_cross=zf(kcap),
        n_kmeans=0,
        objective_harmony=zf(hcap),
        n_harmony=0,
        kmeans_rounds=torch.zeros(cfg.max_iter_harmony, dtype=torch.int32, device=dev),
        n_rounds=0,
        seed=int(seed),
        generator=_generator(seed, dev),
    )


def state_from_arrays(
    cfg: HarmonyConfig, arrays: Dict[str, np.ndarray], device
) -> HarmonyState:
    """Build a state from numpy arrays named as the JAX state's fields, so a
    test can hand a ``harmony_tpu`` state straight to the port. ``key`` (the
    JAX ``[0, seed]`` key data) seeds the generator; it may be omitted."""
    dev = torch.device(device)
    missing = [f for f in ARRAY_FIELDS if f not in arrays and f != "key"]
    if missing:
        raise KeyError(f"state arrays missing fields: {missing}")
    kw = {}
    for f in ARRAY_FIELDS:
        if f == "key":
            continue
        a = np.asarray(arrays[f])
        if f in _CURSORS:
            kw[f] = int(a)
        else:
            kw[f] = torch.as_tensor(np.array(a), device=dev)
    key = np.asarray(arrays.get("key", np.zeros(2, np.uint32))).astype(np.uint64)
    seed = int(key.reshape(-1)[-1]) | (int(key.reshape(-1)[0]) << 32)
    return HarmonyState(**kw, seed=seed, generator=_generator(seed, dev))


def state_to_arrays(state: HarmonyState) -> Dict[str, np.ndarray]:
    """Every JAX state field as numpy (cursors as 0-d int32 arrays)."""
    out = {}
    for f in ARRAY_FIELDS:
        if f == "key":
            out[f] = np.array(
                [(state.seed >> 32) & 0xFFFFFFFF, state.seed & 0xFFFFFFFF],
                dtype=np.uint32,
            )
        elif f in _CURSORS:
            out[f] = np.asarray(getattr(state, f), dtype=np.int32)
        else:
            out[f] = getattr(state, f).cpu().numpy()
    return out
