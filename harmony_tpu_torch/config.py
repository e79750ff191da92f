"""Configuration for the PyTorch/CUDA Harmony engine.

The port's own copy of ``harmony_tpu/config.py``: the same two-tier surface
(first-class ``run_harmony`` arguments plus :func:`harmony_options`,
reference ``R/harmony_option.R:33-55``) and a resolved, frozen
:class:`HarmonyConfig` that every engine phase receives.

Only the knobs that mean something on a GPU are kept. The TPU-only
resolutions of the JAX package (sorted permute blocks, the permute
phase's sub-tile padding choice) have no counterpart here. The matmul
precision resolves by dtype as in the JAX package
(:func:`resolve_matmul_precision`). A reduced-precision engine (bfloat16,
float16) under the resolved 'bfloat16' takes one bf16 pass for the
products of the rotate schedule's kernels that the JAX package traces
under it (:attr:`HarmonyConfig.bf16_products`: K6's and K11's g = Y^T Zn,
K10's W R); every other product runs in IEEE fp32 on operands upcast from
the storage dtype, which each resolved precision allows ('bfloat16'
permits bf16 passes, 'float32' and 'highest' require fp32). The rotate
schedule keeps the JAX package's sub-tile and padding formula, because it
fixes the block partition (see :func:`finalize_engine_config`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
    # Physical cell-axis length: the rotate schedule pads N to whole cell
    # tiles. Pad cells have zero Z, code 0 and zero R, so they add nothing
    # to any statistic; None means no padding.
    N_pad: Optional[int] = None

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
    # Precision of the products (harmony_tpu/config.py:159-162): 'auto'
    # resolves by dtype in finalize_engine_config.
    matmul_precision: str = "float32"
    ridge_solver: str = "auto"  # 'auto' | 'cholesky' | 'solve' | 'arrowhead'
    # E-step round and M-step contractions: 'kernel' (the hand-written
    # CUDA kernels, ops/cuda_estep.py and ops/cuda_ridge.py; their plain
    # twins on CPU tensors), 'torch' (the plain PyTorch path), or 'auto'
    # (resolved by finalize_engine_config).
    estep_impl: str = "auto"
    mstep_impl: str = "auto"
    # 'permute' (the reference-exact fresh permutation per round) or
    # 'rotate' (cells shuffled once at ingest; each round a random tile
    # rotation and block order, ops/rotate.py).
    shuffle_mode: str = "permute"
    # Rotate schedule: cells per schedule tile (shrunk by
    # finalize_engine_config), the batch-tiled layout's tile width, the
    # M-step moment strategy ('auto' | 'tiled' | 'dense'), the assignment
    # op order of the stats-carrying round ('fused_vpu'; 'fused_mxu' is the
    # same function; 'legacy' the reference's two normalisations) and
    # whether the rounds carry per-tile statistics (K6/K7) or read the old
    # block statistics from R (K12); see :attr:`rotate_route`.
    estep_sub_tile: int = 4096
    mstep_tile: int = 256
    mstep_mode: str = "auto"
    # Cells per tile of the segmented M-step's layout (ops/segments.py).
    segment_tile: int = 1024
    estep_variant: str = "fused_vpu"
    rotate_stats_carry: bool = True
    # Virtual R: no round writes the (K, N) assignment matrix; the final
    # round emits its per-block penalty tables, the correction recomputes R
    # from them (K10) and the run materialises R once at its end (K11).
    # Taken by the static-budget rotate kernel path with a batch-tiled
    # layout (engine._virtual_gate); None resolves by dtype as in the JAX
    # package (off for float32).
    virtual_r: "bool | None" = None
    # Permute schedule: run a clustering phase as the fused R-gather-free
    # phase (K2/K3, ops/permute_phase.py) instead of per-round updates;
    # None resolves in finalize_engine_config. The port's spelling of what
    # estep_impl='pallas' selects on the permute schedule in the JAX package.
    permute_fused: Optional[bool] = None
    # The cell shards of a mesh run (sharding.CellMesh.size), set by
    # finalize_engine_config; the rotate schedule's blocks and tiles are
    # per shard. Not a field of the JAX config, whose finalize takes the
    # mesh as an argument.
    n_shards: int = 1

    verbose: bool = False

    def __post_init__(self):
        if self.N < 6:
            # src/harmony.cpp:83-85
            raise HarmonyConfigError("Refusing to run with less than 6 cells")
        if sum(self.B_vec) != self.B:
            raise HarmonyConfigError("B must equal sum(B_vec)")
        if self.N_pad is not None and self.N_pad < self.N:
            raise HarmonyConfigError("N_pad must be >= N")

    @property
    def Np(self) -> int:
        """Physical (possibly padded) length of the cell axis."""
        return self.N if self.N_pad is None else self.N_pad

    @property
    def rotate_route(self) -> Optional[str]:
        """The rotate round this config runs (None on the permute
        schedule): 'cell', the cell-granular round (ops/estep.py), below
        ``n_blocks * 128`` cells, where tiles of 128 cells or more cannot
        make the reference's block count (harmony_tpu/config.py:396-405);
        else 'carry', the stats-carrying rounds (K6/K7), or 'two_phase',
        the rounds that read the old block statistics from R (K12), by
        ``rotate_stats_carry``. On a mesh the bound applies to each shard's
        cells, and without the stats carry the route is 'cell': K12 has no
        sharded form, and the JAX package's 'auto' takes its XLA
        cell-granular round there (harmony_tpu/config.py:393-394)."""
        if self.shuffle_mode != "rotate":
            return None
        if self.Np // self.n_shards < self.n_blocks * 128:
            return "cell"
        if self.rotate_stats_carry:
            return "carry"
        return "two_phase" if self.n_shards == 1 else "cell"

    @property
    def bf16_products(self) -> bool:
        """Do the rotate kernels take the bf16 product form: K6's and K11's
        g = Y^T Zn and K10's W R on operands rounded to bf16 (round to
        nearest even), summed in fp32? The JAX package traces these
        products under ``jax.default_matmul_precision('bfloat16')``
        (harmony_tpu/engine.py:783-798), one bf16 pass on the TPU. True
        exactly for a bfloat16 or float16 engine under the resolved
        precision 'bfloat16'; a float32 engine keeps fp32 products under
        every precision, which the permission allows. An unresolved 'auto'
        resolves by dtype here, as the JAX engine resolves it when it
        traces (harmony_tpu/engine.py:792)."""
        return (self.dtype in ("bfloat16", "float16")
                and resolve_matmul_precision(self.dtype, self.matmul_precision) == "bfloat16")

    @property
    def tiled_route(self) -> bool:
        """Does the run take the routes on which the JAX package runs its
        Pallas E-step (the rotate schedule's tile routes, the fused permute
        phase), and with them the batch-tiled ingest order and M-step under
        ``mstep_mode='auto'`` (harmony_tpu/api.py:484-502,
        harmony_tpu/engine.py:808-827)? Call it on a finalised config."""
        return self.rotate_route in ("carry", "two_phase") or bool(self.permute_fused)

    @property
    def graph_route(self) -> bool:
        """Does ``driver.harmonize`` run the iterations through
        ``engine.run_rounds`` (the counterpart of the JAX package's
        one-dispatch path, harmony_tpu/driver.py:122-155)? A property of the
        route alone: true on one device with the kernels, on every route:
        the stats-carrying rotate route under any budget, the two-phase
        rotate route (K12), the cell-granular rotate round (its schedule
        table read on the device), the fused permute phase and the
        per-round permute route (K1). On the card ``run_rounds`` replays
        one captured iteration an iteration, the re-entry and the rounds
        that the windowed early stop may skip as guarded regions on device
        flags; on CPU tensors it runs the same iteration eagerly, with the
        same bits. The mesh routes keep the host loop: gloo's collectives
        cannot be captured."""
        return self.n_shards == 1 and self.estep_impl == "kernel"

    @property
    def use_segments(self) -> bool:
        """Does the M-step take the segmented layout (ops/segments.py) when
        no batch-tiled layout exists? 'segment' always, 'dense' never, and
        'auto' at N >= 65,536 and B >= 32 (harmony_tpu/config.py:313-321)."""
        if self.mstep_mode in ("segment", "dense"):
            return self.mstep_mode == "segment"
        return self.N >= 65536 and self.B >= 32

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


def resolve_matmul_precision(dtype: str, matmul_precision: str = "auto") -> str:
    """Resolve the 'auto' matmul precision by engine dtype, as the JAX
    package does (harmony_tpu/config.py:341-360): 'bfloat16' for engines
    of fewer than 4 bytes, 'highest' for float64, 'float32' otherwise.
    'bfloat16' is a permission to run products on bf16 operands where the
    platform has such passes: a reduced-precision engine takes it in the
    rotate kernels' products (:attr:`HarmonyConfig.bf16_products`) and
    runs the rest in fp32 on upcast operands, which it allows."""
    if matmul_precision != "auto":
        return matmul_precision
    dt = getattr(torch, dtype_name(dtype))
    if dt.itemsize < 4:
        return "bfloat16"
    if dt == torch.float64:
        return "highest"
    return "float32"


def default_nclust(n_cells: int) -> int:
    """K heuristic ``min(round(N/30), 100)`` (R/ui.R:192-194); Python's
    ``round`` is round-half-to-even, as is R's."""
    return min(round(n_cells / 30), 100)


_IMPLS = ("auto", "kernel", "torch")
_SHUFFLE_MODES = ("permute", "rotate")
_MSTEP_MODES = ("auto", "tiled", "dense", "segment")
_VARIANTS = ("fused_vpu", "fused_mxu", "legacy")


_PRECISIONS = ("auto", "bfloat16", "float32", "highest")
# The largest finite float16: a float16 engine stores each batch's size,
# and O and E (each at most a batch's size), in float16
FLOAT16_MAX = 65504


def check_float16_batches(dtype, batch_sizes) -> None:
    """Refuse a float16 engine with a batch of more than 65,504 cells, the
    largest float16. The state stores the batch sizes, O and E in the
    engine dtype (harmony_tpu/state.py:166); a larger batch's size is
    rounded, and from 65,520 cells it is inf: its avg_R = O / batch_sizes
    (harmony_tpu/ops/ridge.py:58) is 0, the M-step's mask drops it and the
    batch is never corrected, with nothing to say so. The JAX package runs
    on silently; the port raises instead."""
    if dtype_name(dtype) != "float16":
        return
    big = np.flatnonzero(np.asarray(batch_sizes) > FLOAT16_MAX)
    if big.size:
        raise HarmonyConfigError(
            f"dtype='float16' stores each batch's size and its O and E in float16, whose "
            f"largest value is {FLOAT16_MAX}; batch row(s) {big.tolist()} hold "
            f"{np.asarray(batch_sizes)[big].astype(np.int64).tolist()} cells, past it (from "
            "65,520 cells the size is inf and the batch is never corrected). Use "
            "dtype='bfloat16' or 'float32', or split the batches"
        )


def _rotate_geometry(cfg: HarmonyConfig) -> HarmonyConfig:
    """Sub-tile T and padded N of the rotate schedule, by the JAX package's
    formula (harmony_tpu/config.py:453-482): each of the ``n_shards``
    shards gets at least ``n_blocks`` tiles where it can and a whole number
    of tiles (N is padded to ``n_shards * T``). The budget loop
    guarded a TPU core's VMEM there; on the GPU nothing depends on it, but
    T is the schedule's quantum: tiles make the blocks, so the two packages
    draw the same block partition only with the same T and N_pad."""
    T = cfg.estep_sub_tile
    pc_extra = 4 * cfg.K if cfg.B > 32 else 0
    budget = (12 if cfg.B <= 32 else 10) * 2**20
    while T > 512 and T * (8 * (cfg.K + cfg.d + cfg.B) + pc_extra) > budget:
        T //= 2
    per_block = max(cfg.Np // cfg.n_shards // max(cfg.n_blocks, 1), 1)
    fit = 128
    while fit * 2 <= per_block:
        fit *= 2
    T = max(128, min(T, fit))
    align = cfg.n_shards * T
    Npt = -(-cfg.Np // align) * align
    return dataclasses.replace(
        cfg, estep_sub_tile=T, N_pad=None if Npt == cfg.N else Npt
    )


def finalize_engine_config(cfg: HarmonyConfig, mesh=None) -> HarmonyConfig:
    """Resolve the 'auto' knobs for the GPU engine, on one device or on the
    cell shards of ``mesh`` (a ``sharding.CellMesh``, or anything with a
    ``size``), which sets ``n_shards``.

    - ``dtype='bfloat16'`` and ``'float16'`` are the reduced-precision
      engines: the state is stored in the engine dtype; the rotate
      kernels' products take one bf16 pass under the resolved 'bfloat16'
      (:attr:`HarmonyConfig.bf16_products`), every other product and sum
      runs in fp32 on upcast operands, cast back where the JAX engine
      casts. A float16 engine with a batch of more than 65,504 cells is
      refused where the batch sizes are known
      (:func:`check_float16_batches`).
    - ``matmul_precision='auto'`` resolves by dtype
      (:func:`resolve_matmul_precision`, harmony_tpu/config.py:483-486);
      values other than those in ``_PRECISIONS`` raise
      ``HarmonyConfigError``.
    - ``virtual_r=None`` resolves by dtype, as in the JAX package
      (harmony_tpu/config.py:492-504): on for bfloat16 and float16, off
      for float32 and float64; True selects virtual R where ``engine._virtual_gate``
      admits it and is ignored elsewhere, as the JAX package ignores it.
    - ``estep_impl``/``mstep_impl='auto'`` pick the hand-written kernels for
      float32, bfloat16 and float16 engines (K6, K7, K10 and K11 read and
      write the 2-byte storage on the virtual route; the other kernels run
      on float32 copies made at their wrappers) and the plain PyTorch path
      for float64; 'kernel' on CPU tensors runs the kernels' plain twins.
    - ``shuffle_mode='rotate'`` runs the round :attr:`HarmonyConfig.rotate_route`
      names. The tile routes ('carry', 'two_phase') get the JAX package's
      tile geometry, whether or not the rounds carry stats
      (harmony_tpu/config.py:453-482); the cell-granular route gets none,
      as the JAX package's XLA path gets none (on a mesh it takes
      ``rotate_stats_carry=False`` too). ``estep_variant='legacy'``
      selects the reference's two-normalise op order of K7, K10 and K11 on
      the stats-carrying route and is ignored on the other two, which have
      one op sequence each, as the JAX package ignores it there.
    - ``permute_fused=None`` resolves to True under the JAX package's gate
      (harmony_tpu/config.py:421-432): the permute schedule, the kernels,
      ``Np >= 200_000``, ``K <= 256`` and a static round count
      (``max_iter_cluster <= window_size + 2``, so the windowed early stop
      cannot fire); to False otherwise, so ``estep_impl='torch'`` keeps the
      per-round loop. True forces the fused phase at any size (the kernels,
      or the plain twin under 'torch' or on CPU tensors) and raises without
      a static round count. The JAX package's sub-tile choice for this phase
      (config.py:434-452) only sizes its TPU padding: the port's kernels
      cover each block's exact cell range, so it has no counterpart.
    """
    for name in ("estep_impl", "mstep_impl"):
        if getattr(cfg, name) not in _IMPLS:
            raise HarmonyConfigError(
                f"{name} must be one of {_IMPLS}, got {getattr(cfg, name)!r}"
            )
    for name, allowed in (("shuffle_mode", _SHUFFLE_MODES),
                          ("mstep_mode", _MSTEP_MODES),
                          ("estep_variant", _VARIANTS)):
        if getattr(cfg, name) not in allowed:
            raise HarmonyConfigError(
                f"{name} must be one of {allowed}, got {getattr(cfg, name)!r}"
            )
    if cfg.matmul_precision not in _PRECISIONS:
        raise HarmonyConfigError(
            f"matmul_precision must be one of {_PRECISIONS}, got {cfg.matmul_precision!r}"
        )
    if mesh is not None:
        cfg = dataclasses.replace(cfg, n_shards=int(mesh.size))
    reduced = getattr(torch, cfg.dtype).itemsize < 4
    cfg = dataclasses.replace(
        cfg, matmul_precision=resolve_matmul_precision(cfg.dtype, cfg.matmul_precision))
    if cfg.virtual_r is None:
        cfg = dataclasses.replace(cfg, virtual_r=reduced)
    if cfg.shuffle_mode == "rotate" and cfg.rotate_route != "cell":
        cfg = _rotate_geometry(cfg)
    impl = "kernel" if cfg.dtype in ("float32", "bfloat16", "float16") else "torch"
    if cfg.estep_impl == "auto":
        cfg = dataclasses.replace(cfg, estep_impl=impl)
    if cfg.mstep_impl == "auto":
        cfg = dataclasses.replace(cfg, mstep_impl=impl)
    static = cfg.max_iter_cluster <= cfg.window_size + 2
    if cfg.shuffle_mode != "permute":
        if cfg.permute_fused:
            raise HarmonyConfigError("permute_fused=True needs shuffle_mode='permute'")
        fused = False
    elif cfg.permute_fused is None:
        fused = (cfg.estep_impl == "kernel" and cfg.Np >= 200_000
                 and cfg.K <= 256 and static)
    else:
        fused = bool(cfg.permute_fused)
        if fused and not static:
            raise HarmonyConfigError(
                "permute_fused=True needs a static round count: max_iter_cluster "
                f"<= window_size + 2 = {cfg.window_size + 2}, got "
                f"{cfg.max_iter_cluster}"
            )
    return dataclasses.replace(cfg, permute_fused=fused)
