"""Configuration for the PyTorch/CUDA Harmony engine.

The port's own copy of ``harmony_tpu/config.py``: the same two-tier surface
(first-class ``run_harmony`` arguments plus :func:`harmony_options`,
reference ``R/harmony_option.R:33-55``) and a resolved, frozen
:class:`HarmonyConfig` that every engine phase receives.

Only the knobs that mean something on a GPU are kept. The TPU-only
resolutions of the JAX package (the VMEM sub-tile budget, the bf16-pass
matmul precisions, sorted permute blocks) have no counterpart here; fp32
products run as IEEE fp32 on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


class HarmonyConfigError(ValueError):
    """Raised on invalid user configuration (reference: R ``stop()`` paths)."""


# Legacy RunHarmony arguments that hard-error with migration advice
# (reference: ``check_legacy_args`` / ``legacy_error``, R/harmony_option.R:67-132).
_LEGACY_ARGS = {
    "do_pca": (
        "The parameters do_pca and npcs have been dropped from the run_harmony "
        "API. Pass cell embeddings directly."
    ),
    "npcs": (
        "The parameters do_pca and npcs have been dropped from the run_harmony "
        "API. Pass cell embeddings directly."
    ),
    "tau": (
        "The parameter tau has been dropped from the run_harmony API. "
        "Set it via harmony_options(tau=...)."
    ),
    "block.size": (
        "The parameter block.size has been dropped from the run_harmony API. "
        "Set it via harmony_options(block_size=...)."
    ),
    "block_size": (
        "The parameter block_size has been dropped from the run_harmony API. "
        "Set it via harmony_options(block_size=...)."
    ),
    "max.iter.harmony": (
        "The parameter max.iter.harmony is replaced with parameter max_iter."
    ),
    "max_iter_harmony": (
        "The parameter max_iter_harmony is replaced with parameter max_iter."
    ),
    "max.iter.cluster": (
        "The parameter max.iter.cluster has been dropped from the run_harmony "
        "API. Set it via harmony_options(max_iter_cluster=...)."
    ),
    "epsilon.cluster": (
        "The parameter epsilon.cluster has been dropped from the run_harmony "
        "API. Set it via harmony_options(epsilon_cluster=...)."
    ),
    "epsilon.harmony": (
        "The parameter epsilon.harmony has been dropped from the run_harmony "
        "API. Use early_stop, or harmony_options(epsilon_harmony=...)."
    ),
}


def check_legacy_args(**kwargs) -> None:
    """Reject dropped legacy arguments with actionable messages
    (R/harmony_option.R:67-81)."""
    for name in kwargs:
        if name in _LEGACY_ARGS:
            raise HarmonyConfigError(_LEGACY_ARGS[name])
    if kwargs:
        bad = ", ".join(sorted(kwargs))
        raise HarmonyConfigError(
            f"Argument(s) {bad} are unhandled. Please refer to the "
            "documentation for the valid harmony options."
        )


@dataclasses.dataclass(frozen=True)
class HarmonyOptions:
    """Advanced options (reference ``harmony_options()``, R/harmony_option.R:33-55)."""

    alpha: float = 0.2
    tau: float = 0.0
    block_size: float = 0.05
    max_iter_cluster: int = 4
    epsilon_cluster: float = 1e-3
    epsilon_harmony: float = 1e-2
    batch_prop_cutoff: float = 1e-5

    def __post_init__(self):
        # validate_block.size (R/harmony_option.R:58-63)
        if not (0.0 < self.block_size <= 1.0):
            raise HarmonyConfigError(
                "block_size should be set between 0 and 1 (0 < block_size <= 1)"
            )


def harmony_options(**kwargs) -> HarmonyOptions:
    """Construct advanced options; the analog of R ``harmony_options()``."""
    return HarmonyOptions(**kwargs)


@dataclasses.dataclass(frozen=True)
class HarmonyConfig:
    """Fully-resolved static engine configuration (src/harmony.cpp:29-111)."""

    # Problem shape
    N: int
    d: int
    K: int
    B: int  # total one-hot design rows = sum(B_vec)
    B_vec: Tuple[int, ...]

    # Driver / convergence
    max_iter_harmony: int = 10
    max_iter_cluster: int = 4
    epsilon_cluster: float = 1e-3
    epsilon_harmony: float = 1e-2
    window_size: int = 3  # sliding window (src/harmony.cpp:19)

    # Correction
    alpha: float = 0.2
    batch_prop_cutoff: float = 1e-5
    lambda_estimation: bool = False  # lambda sentinel -1 mode (src/harmony.cpp:75-79)

    block_size: float = 0.05

    dtype: str = "float32"
    ridge_solver: str = "auto"  # 'auto' | 'cholesky' | 'solve' | 'arrowhead'
    # E-step round and M-step contractions: 'kernel' (the hand-written
    # CUDA kernels, ops/cuda_estep.py and ops/cuda_ridge.py; their plain
    # twins on CPU tensors), 'torch' (the plain PyTorch path), or 'auto'
    # (resolved by finalize_engine_config).
    estep_impl: str = "auto"
    mstep_impl: str = "auto"
    # Only the reference-exact 'permute' schedule is ported.
    shuffle_mode: str = "permute"
    # Virtual R exists only on the rotate schedule; None resolves by dtype
    # as in the JAX package and must come out False here.
    virtual_r: "bool | None" = None

    verbose: bool = False

    def __post_init__(self):
        if self.N < 6:
            # src/harmony.cpp:83-85
            raise HarmonyConfigError("Refusing to run with less than 6 cells")
        if sum(self.B_vec) != self.B:
            raise HarmonyConfigError("B must equal sum(B_vec)")

    # ---- Derived block geometry (src/harmony.cpp:279-299) -----------------

    @property
    def effective_block_size(self) -> float:
        """N < 40 forces block_size to 0.2 (src/harmony.cpp:86-88)."""
        if self.N < 40:
            return 0.2
        return self.block_size

    @property
    def n_blocks(self) -> int:
        """ceil(1 / block_size) (src/harmony.cpp:280)."""
        return int(math.ceil(1.0 / self.effective_block_size - 1e-12))

    @property
    def cells_per_block(self) -> int:
        """floor(N * block_size) (src/harmony.cpp:281)."""
        return int(self.N * self.effective_block_size)

    @property
    def last_block_size(self) -> int:
        """The final block absorbs the remainder (src/harmony.cpp:296-300)."""
        return self.N - (self.n_blocks - 1) * self.cells_per_block

    @property
    def max_block_size(self) -> int:
        return max(self.cells_per_block, self.last_block_size)

    @property
    def covariate_offsets(self) -> Tuple[int, ...]:
        """Start row of each covariate in the stacked design (src/harmony.cpp:96-97)."""
        offs, acc = [], 0
        for b in self.B_vec:
            offs.append(acc)
            acc += b
        return tuple(offs)

    @property
    def n_covariates(self) -> int:
        return len(self.B_vec)

    @property
    def norm_const(self) -> float:
        """Objective scaling 2000/N (src/harmony.cpp:159)."""
        return 2000.0 / float(self.N)

    # ---- Trace capacities -------------------------------------------------

    @property
    def kmeans_trace_capacity(self) -> int:
        return 1 + self.max_iter_harmony * self.max_iter_cluster

    @property
    def harmony_trace_capacity(self) -> int:
        return 1 + self.max_iter_harmony


def dtype_name(dtype) -> str:
    """Canonical name of a dtype given as a string, numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return str(getattr(torch, dtype)).removeprefix("torch.")
    return np.dtype(dtype).name


def default_nclust(n_cells: int) -> int:
    """K heuristic ``min(round(N/30), 100)`` (R/ui.R:192-194); Python's
    ``round`` is round-half-to-even, as is R's."""
    return min(round(n_cells / 30), 100)


_IMPLS = ("auto", "kernel", "torch")


def finalize_engine_config(cfg: HarmonyConfig) -> HarmonyConfig:
    """Resolve the 'auto' knobs for the GPU engine.

    - ``virtual_r=None`` resolves by dtype, as in the JAX package: reduced
      precision engines would skip writing R, which only the rotate
      schedule supports; that path is not ported yet (ROADMAP A9).
    - ``estep_impl``/``mstep_impl='auto'`` pick the hand-written kernels for
      float32 engines (the kernels are fp32 only) and the plain PyTorch path
      otherwise. The M-step kernels serve single-covariate runs; others stay
      on the dense PyTorch contractions whatever the setting (ops/ridge.py).
    """
    for name in ("estep_impl", "mstep_impl"):
        if getattr(cfg, name) not in _IMPLS:
            raise HarmonyConfigError(
                f"{name} must be one of {_IMPLS}, got {getattr(cfg, name)!r}"
            )
    if cfg.shuffle_mode != "permute":
        raise NotImplementedError(
            f"shuffle_mode={cfg.shuffle_mode!r} is not ported yet; only the "
            "reference-exact 'permute' schedule runs (ROADMAP A9: the rotate "
            "schedule)"
        )
    if cfg.virtual_r is None:
        cfg = dataclasses.replace(
            cfg, virtual_r=getattr(torch, cfg.dtype).itemsize < 4
        )
    if cfg.virtual_r:
        raise NotImplementedError(
            "virtual R (the default for reduced-precision dtypes) needs the "
            "rotate schedule, which is not ported yet (ROADMAP A9)"
        )
    impl = "kernel" if cfg.dtype == "float32" else "torch"
    if cfg.estep_impl == "auto":
        cfg = dataclasses.replace(cfg, estep_impl=impl)
    if cfg.mstep_impl == "auto":
        cfg = dataclasses.replace(cfg, mstep_impl=impl)
    return cfg
