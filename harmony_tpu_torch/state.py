"""HarmonyState: the engine state as a dataclass of tensors.

The port's counterpart of ``harmony_tpu/state.py`` (the C++ engine's member
state, ``src/harmony.h:20-70``). Layout follows the JAX package, cells
last: Z_orig/Z_corr (d, Np), Y (d, K), R (K, Np), O/E (K, B), codes
(ncov, Np), where Np = ``cfg.Np`` pads the cell axis as the JAX state
does (pad cells: zero Z, code 0, zero R). Trace buffers have fixed
capacity with integer cursors.

The JAX state carries a PRNG key; here the randomness comes from a
``torch.Generator`` seeded from the same integer (``key`` holds
``[0, seed]``, the layout of ``jax.random.PRNGKey(seed)``).

On a mesh (``mesh``, a ``sharding.CellMesh``) a rank's state holds its own
columns of the cell-axis fields (:data:`CELL_FIELDS`) and the replicated
rest; :func:`state_to_arrays` gathers the JAX package's global arrays and
:func:`state_from_arrays` takes this rank's part of them.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .config import HarmonyConfig, check_float16_batches
from .ops.normalize import l2_normalize_columns
from .preprocess import DesignMatrix
from .runtime import AsyncIngest, engine_cast, span, timing

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
# The torch generator's state (not a JAX state field: the JAX state's key
# advances with every draw, a torch.Generator keeps its position inside).
GENERATOR_FIELD = "torch_generator"
# The virtual-R context (harmony_tpu/state.py:78-88): None unless the run
# takes virtual R.
VIRTUAL_FIELDS = ("virt_pen", "virt_blkmap", "virt_Zn", "virt_Y")
# The fields held in the engine dtype (harmony_tpu/state.py:127-166;
# virt_Y snapshots state.Y, harmony_tpu/engine.py:748-749); the traces,
# virt_pen and virt_Zn stay float32.
ENGINE_DTYPE_FIELDS = ("Z_orig", "Z_corr", "Y", "R", "O", "E", "Pr_b", "batch_sizes",
                       "sigma", "theta", "lamb", "virt_Y")
# The fields with a trailing cell axis: on a mesh each rank holds its
# columns (harmony_tpu/sharding.py:86-93's P(None, CELL_AXIS)). virt_pen
# stacks the shards' tables on its leading axis and virt_blkmap is one
# entry a tile, both sharded with the tiles.
CELL_FIELDS = ("Z_orig", "Z_corr", "R", "codes", "virt_Zn")


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
    # The joint-batch moment table (n_joint+1, K, d+1) of R that the fused
    # permute phase accumulated for the next correction (K3), or None;
    # engine.correct consumes it. Not a field of the JAX state, whose
    # cluster returns it instead.
    tiled_moments: Optional[torch.Tensor] = None
    # Virtual-R context: what reproduces the LAST clustering round's
    # assignments without R having been written (ops/rotate.py VirtualR):
    # its per-block penalty tables, its tile -> block map, its normalised
    # layout (the tensor K6 wrote, not a copy) and the centroids it used.
    # engine.correct recomputes R from it and engine.materialize_r turns it
    # into the user-facing R; until then the state's R is stale.
    virt_pen: Optional[torch.Tensor] = None  # (nb, K, B) float32
    virt_blkmap: Optional[torch.Tensor] = None  # (NT,) int32
    virt_Zn: Optional[torch.Tensor] = None  # (d, Npt) float32
    virt_Y: Optional[torch.Tensor] = None  # (d, K) engine dtype
    # The last phase's Gram table (Npt, K) float32, K6's, which the
    # virtual-R correction (K10) reads instead of forming g again; set with
    # the context, consumed by engine.correct, so no phase holds two. Not a
    # field of the JAX state: a state built from its arrays has none, and
    # its correction writes R from virt_Y and virt_Zn (K11), then applies
    # it (K9).
    virt_G: Optional[torch.Tensor] = None
    # The device cursor (n_kmeans, n_harmony, n_rounds), int64 on the
    # state's device, while engine.run_rounds runs an iteration, else None:
    # the trace writes go there and advance it on the device, so one
    # captured iteration serves every iteration, and the host ints are set
    # from it with one read after the run. Not a field of the JAX state,
    # whose cursors are device scalars already.
    cursor: Optional[torch.Tensor] = None

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
    Z,
    design: DesignMatrix,
    sigma: np.ndarray,
    theta: np.ndarray,
    lamb: np.ndarray,
    seed: int,
    device,
    timers=None,
    mesh=None,
) -> HarmonyState:
    """Build the initial state (``harmony::setup``, src/harmony.cpp:29-111):
    casts to the engine dtype, L2-normalises ``Z_corr`` columns
    (src/harmony.cpp:42) and computes the batch statistics. Clustering state
    stays zero until ``engine.init_cluster``. The cell axis is padded to
    ``cfg.Np`` with inert zero cells of code 0, as the JAX state is.

    ``Z`` is the (d, Np) device tensor of :meth:`runtime.AsyncIngest.result`,
    padded and in the engine dtype, or the (d, N) host array in engine
    order, which goes to the device through the same
    :class:`runtime.AsyncIngest`. The call is the span ``init_state``, its
    normalisation the scope ``ingest_normalize``; ``timers`` (a
    ``runtime.PhaseTimers``) is made the active timers while it runs. On a
    ``mesh`` the state holds
    this rank's columns: a device ``Z`` is the rank's (d, Np / size) slice,
    a host ``Z`` the whole (d, N) array, of which only the rank's columns
    are copied; ``design`` is the whole design. A float16 engine with a
    batch past float16's range raises (:func:`config.check_float16_batches`)."""
    with timing(timers), span("init_state"):
        check_float16_batches(cfg.dtype, design.batch_sizes())
        dev = torch.device(device)
        dtype = getattr(torch, cfg.dtype)
        codes = design.codes.astype(np.int32)
        pad = cfg.Np - cfg.N
        if pad:
            codes = np.concatenate([codes, np.zeros((codes.shape[0], pad), np.int32)], axis=1)
        n_loc = cfg.Np
        if mesh is not None:
            from .sharding import shard_cells

            codes = np.ascontiguousarray(shard_cells(codes, cfg, mesh))
            n_loc = codes.shape[1]
        if not isinstance(Z, torch.Tensor):
            Z = AsyncIngest(Z, cfg, dev, mesh=mesh).result()
        if Z.shape[1] != n_loc or Z.dtype != dtype or Z.device.type != dev.type:
            raise ValueError(f"a device Z must be ({cfg.d}, {n_loc}) {dtype} on {dev}, got "
                             f"{tuple(Z.shape)} {Z.dtype} on {Z.device}")
        Z_orig = Z
        with span("ingest_normalize", sync=True):
            Z_corr = l2_normalize_columns(Z_orig)
        batch_sizes = design.batch_sizes().astype(np.float64)
        Pr_b = batch_sizes / cfg.N
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        zf = lambda n: torch.zeros(n, dtype=_F32, device=dev)
        kcap, hcap = cfg.kmeans_trace_capacity, cfg.harmony_trace_capacity
        return HarmonyState(
            Z_orig=Z_orig,
            Z_corr=Z_corr,
            Y=torch.zeros((cfg.d, cfg.K), dtype=dtype, device=dev),
            R=torch.zeros((cfg.K, n_loc), dtype=dtype, device=dev),
            O=torch.zeros((cfg.K, cfg.B), dtype=dtype, device=dev),
            E=torch.zeros((cfg.K, cfg.B), dtype=dtype, device=dev),
            codes=torch.as_tensor(codes, device=dev),
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


def is_bf16_bits(a: np.ndarray) -> bool:
    """Does ``a`` hold bf16 values as 16-bit patterns: ml_dtypes' bfloat16,
    which numpy cannot convert, or the raw ``'V2'`` an ``.npz`` stores it
    as?"""
    return a.dtype.itemsize == 2 and (a.dtype.name == "bfloat16" or a.dtype.kind == "V")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A tensor of the array's values; a bf16 array (:func:`is_bf16_bits`)
    is read as its 16-bit patterns, so no bit changes and ml_dtypes is not
    needed."""
    if is_bf16_bits(a):
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as float32 holding the same values, which
    ``.astype(jnp.bfloat16)`` turns back into the same bits; float16 as
    numpy's float16, bit for bit."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def state_from_arrays(
    cfg: HarmonyConfig, arrays: Dict[str, np.ndarray], device, mesh=None
) -> HarmonyState:
    """Build a state from numpy arrays named as the JAX state's fields, so a
    test can hand a ``harmony_tpu`` state (padded or not) straight to the
    port. ``key`` (the
    JAX ``[0, seed]`` key data) seeds the generator; it may be omitted.
    ``GENERATOR_FIELD``, where present, sets the generator's state
    (:func:`set_generator_state`), so the port's draws continue. The
    virtual-R fields are carried where present and not None. Floating
    fields the engine stores in its dtype (``ENGINE_DTYPE_FIELDS``) are
    cast to ``cfg.dtype``: exact for the float32 arrays of
    :func:`state_to_arrays` that hold a bf16 state's values and for the
    float16 arrays of a float16 state. On a ``mesh``
    the arrays are the global ones (the JAX package's layout) and the state
    takes this rank's part: its columns of :data:`CELL_FIELDS`, its rows
    of the stacked penalty tables and its tiles' entries of the tile ->
    block map (global block ids)."""
    dev = torch.device(device)
    if mesh is not None:
        from .sharding import shard_fields

        arrays = {k: (np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in shard_fields(arrays, cfg, mesh).items()}
    missing = [f for f in ARRAY_FIELDS if f not in arrays and f != "key"]
    if missing:
        raise KeyError(f"state arrays missing fields: {missing}")
    dtype = getattr(torch, cfg.dtype)
    kw = {}
    for f in ARRAY_FIELDS + VIRTUAL_FIELDS:
        if f == "key" or arrays.get(f) is None:
            continue
        a = np.asarray(arrays[f])
        if f in _CURSORS:
            kw[f] = int(a.item())
            continue
        t = _tensor(a, dev)
        kw[f] = (engine_cast(t, dtype) if f in ENGINE_DTYPE_FIELDS and t.is_floating_point()
                 else t)
    key = np.asarray(arrays.get("key", np.zeros(2, np.uint32))).astype(np.uint64)
    seed = int(key.reshape(-1)[-1]) | (int(key.reshape(-1)[0]) << 32)
    gen = _generator(seed, dev)
    if arrays.get(GENERATOR_FIELD) is not None:
        set_generator_state(gen, arrays[GENERATOR_FIELD])
    return HarmonyState(**kw, seed=seed, generator=gen)


def set_generator_state(gen: torch.Generator, state: np.ndarray) -> None:
    """Continue ``gen`` from a saved ``get_state()``. A state saved from a
    generator of another device type (the card's Philox against the CPU's
    Mersenne Twister) cannot continue there; the generator keeps its seed
    and a warning says so."""
    state = torch.as_tensor(np.asarray(state, dtype=np.uint8))
    if state.numel() != gen.get_state().numel():
        warnings.warn(
            f"the saved generator state ({state.numel()} bytes) is not one of a "
            f"{gen.device.type} generator; the resumed draws start from the seed instead",
            stacklevel=3)
        return
    gen.set_state(state)


def state_to_arrays(state: HarmonyState, with_generator: bool = False,
                    mesh=None) -> Dict[str, np.ndarray]:
    """Every JAX state field as numpy (cursors as 0-d int32 arrays), the
    virtual-R fields only where set; bf16 fields as float32 arrays holding
    their values, float16 fields as float16 arrays. ``with_generator``
    adds ``GENERATOR_FIELD``, the torch generator's state
    (``get_state()``), so a state built from these arrays
    continues the port's draws where this one stands. On a ``mesh`` the
    cell-axis fields are gathered (a collective: every rank calls it) into
    the JAX package's global arrays: the ranks' columns in rank order, the
    penalty tables stacked (size * nb, K, B) beside the map's global block
    ids (harmony_tpu/sharding.py:86-93)."""
    if mesh is not None:
        from .sharding import gather_cells, gather_rows

        full = {f: gather_cells(getattr(state, f), mesh) for f in CELL_FIELDS
                if getattr(state, f) is not None}
        if state.virt_pen is not None:
            full["virt_pen"] = gather_rows(state.virt_pen, mesh)
            full["virt_blkmap"] = gather_cells(state.virt_blkmap, mesh)
        state = dataclasses.replace(state, **full)
    out = {GENERATOR_FIELD: state.generator.get_state().numpy()} if with_generator else {}
    for f in ARRAY_FIELDS:
        if f == "key":
            out[f] = np.array(
                [(state.seed >> 32) & 0xFFFFFFFF, state.seed & 0xFFFFFFFF],
                dtype=np.uint32,
            )
        elif f in _CURSORS:
            out[f] = np.asarray(getattr(state, f), dtype=np.int32)
        else:
            out[f] = host_numpy(getattr(state, f))
    for f in VIRTUAL_FIELDS:
        if getattr(state, f) is not None:
            out[f] = host_numpy(getattr(state, f))
    return out
