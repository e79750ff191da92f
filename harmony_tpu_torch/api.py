"""Public API: ``run_harmony`` — NumPy in / NumPy out, on the card.

Counterpart of ``harmony_tpu/api.py`` (``RunHarmony.default``,
R/ui.R:91-309), with the same signature plus ``device``. ``device=None``
means the card; without one the call raises instead of carrying on on the
CPU. Every argument of the JAX package's ``run_harmony`` selects a path
that runs here; nothing is rerouted. ``mesh`` runs the cells sharded over
``torch.distributed`` ranks (:mod:`.sharding`), one process a device, on
every route and in bf16 and float16 too.
``shuffle_mode='auto'`` at 100k cells and up runs the rotate schedule;
``shuffle_mode='permute'`` at 200k cells and up the fused permute phase.
The M-step takes the layout the JAX package takes
(``engine.mstep_layout``): batch-tiled where the ingest order has one on
those two paths (the rotate schedule's tile routes), else segmented at
65,536 cells and 32 batches and up (and always under the config's
``mstep_mode='segment'``), else dense.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Union

import numpy as np

from .config import (
    HarmonyConfig,
    HarmonyOptions,
    check_legacy_args,
    finalize_engine_config,
    harmony_options,
)
from . import sharding
from .driver import run as _run
from .engine import mstep_layout
from .preprocess import (
    DesignMatrix,
    build_design,
    expand_hyperparams,
    orient_embedding,
    resolve_config,
)
from .ops.tiled import build_batch_tiled_order, choose_tiled_tile, count_joint_levels
from .runtime import AsyncIngest, PhaseTimers, resolve_device
from .state import HarmonyState, host_numpy, init_state

# Below this many cells 'auto' keeps the reference-exact 'permute' schedule.
AUTO_ROTATE_MIN_CELLS = 100_000

_logger = logging.getLogger("harmony_tpu_torch")


def _resolve_shuffle_mode(
    shuffle_mode: str, n_cells: int, parity_hooks: bool, verbose: bool
) -> str:
    """Resolve shuffle_mode='auto': 'permute' when the run is small or
    injects parity hooks (init_Y), 'rotate' otherwise. Explicit modes pass
    through."""
    if shuffle_mode != "auto":
        if (
            shuffle_mode == "permute"
            and n_cells >= AUTO_ROTATE_MIN_CELLS
            and not parity_hooks
            and verbose
        ):
            _logger.info(
                "shuffle_mode='permute' at %d cells: the reference-exact "
                "schedule re-permutes the cell layout every round; "
                "shuffle_mode='rotate' is the statistically equivalent "
                "schedule for this scale",
                n_cells,
            )
        return shuffle_mode
    if parity_hooks or n_cells < AUTO_ROTATE_MIN_CELLS:
        return "permute"
    if verbose:
        _logger.info(
            "shuffle_mode='auto': using the zero-gather 'rotate' schedule "
            "at %d cells (statistically equivalent; pass "
            "shuffle_mode='permute' for reference-exact trajectories)",
            n_cells,
        )
    return "rotate"


def ingest_perm(cfg: HarmonyConfig, design: DesignMatrix, seed: int, pinned: bool = False):
    """The order the cells are reordered into once at ingest
    (harmony_tpu/api.py:479-525), for the rotate schedule and for the fused
    permute phase unless the caller ``pinned`` the order (``init_Y``): the
    batch-tiled order where the mixture gate allows it on a route that
    takes it (``HarmonyConfig.tiled_route``); else rotate takes a
    plain random permutation and permute keeps the caller's order (it draws
    a fresh permutation every round anyway). Returns (perm or None, the
    batch-tiled tile width or 0); the pair is deterministic in (codes,
    seed), so a resume rebuilds it from a checkpoint's provenance."""
    if not (cfg.shuffle_mode == "rotate" or (cfg.permute_fused and not pinned)):
        return None, 0
    tiled_t = None
    if cfg.mstep_mode in ("auto", "tiled") and cfg.tiled_route:
        # on a mesh the mixture gate applies to each shard's cells
        # (harmony_tpu/api.py:499-502)
        tiled_t = choose_tiled_tile(cfg, count_joint_levels(design.codes), cfg.n_shards)
    return order_from_recipe(design, cfg.shuffle_mode, seed, tiled_t or 0), int(tiled_t or 0)


def order_from_recipe(design: DesignMatrix, shuffle_mode: str, seed: int, tiled_tile: int):
    """The ingest order a run with this recipe took (None: none): the
    batch-tiled order of ``tiled_tile`` cells, else a plain permutation
    from ``seed`` on the rotate schedule."""
    if tiled_tile:
        return build_batch_tiled_order(design.codes, tiled_tile, seed)[0]
    if shuffle_mode == "rotate":
        return np.random.default_rng(seed).permutation(design.n_cells)
    return None


def apply_ingest_order(design: DesignMatrix, perm: Optional[np.ndarray], Z=None):
    """The ingest order ``perm`` (None: none) applied on the host to the
    design and, where given, the (d, N) array ``Z``. Returns (``Z`` in
    ingest order or None, design, the inverse permutation or None). The
    embedding a run uploads is reordered on the device instead
    (:meth:`runtime.AsyncIngest.result`)."""
    if perm is None:
        return Z, design, None
    design = dataclasses.replace(design, codes=design.codes[:, perm])
    return None if Z is None else Z[:, perm], design, np.argsort(perm)


@dataclasses.dataclass
class HarmonyResult:
    """Result object mirroring the reference engine's exposed fields
    (RCPP_MODULE, src/harmony.cpp:672-709). Arrays are host copies.

    Cell-indexed arrays (Z_corr, Z_orig, R, embeddings) come back in the
    caller's cell order without the pad cells; where the run reordered its
    cells at ingest (rotate, and the fused permute phase) the ``state`` and
    ``design`` hold the ingest order and ``ingest_inv`` maps back."""

    config: HarmonyConfig
    state: HarmonyState
    design: DesignMatrix
    timers: Optional[PhaseTimers] = None
    ingest_inv: Optional[np.ndarray] = None
    # the run's sharding.CellMesh (None: one device): the state holds this
    # rank's columns, and the cell arrays gather every rank's, so each rank
    # reads them in the same order (collectives)
    mesh: Optional[object] = None

    def phase_seconds(self) -> dict:
        return self.timers.as_dict() if self.timers is not None else {}

    @property
    def N(self) -> int:
        return self.config.N

    @property
    def d(self) -> int:
        return self.config.d

    @property
    def K(self) -> int:
        return self.config.K

    @property
    def B(self) -> int:
        return self.config.B

    @staticmethod
    def _host(X) -> np.ndarray:
        """A host copy; bf16 comes back as float32 holding the same values
        (numpy has no bf16 without ml_dtypes, which the port does not use)."""
        return host_numpy(X)

    def _cells(self, X) -> np.ndarray:
        """Drop the pad cells and undo the ingest order on the cell axis; on
        a mesh every rank's columns first (a collective)."""
        if self.mesh is not None:
            X = sharding.gather_cells(X, self.mesh)
        X = self._host(X[:, : self.config.N])
        return X if self.ingest_inv is None else X[:, self.ingest_inv]

    @property
    def Z_corr(self) -> np.ndarray:
        """(d, N) corrected embedding (``getZcorr``)."""
        return self._cells(self.state.Z_corr)

    @property
    def Z_orig(self) -> np.ndarray:
        return self._cells(self.state.Z_orig)

    @property
    def Y(self) -> np.ndarray:
        """(d, K) centroids (``getCentroids``)."""
        return self._host(self.state.Y)

    @property
    def R(self) -> np.ndarray:
        """(K, N) soft assignments (``getR``)."""
        return self._cells(self.state.R)

    @property
    def O(self) -> np.ndarray:
        return self._host(self.state.O)

    @property
    def E(self) -> np.ndarray:
        return self._host(self.state.E)

    @property
    def embeddings(self) -> np.ndarray:
        """(N, d) corrected embedding, the default user-facing output."""
        return self.Z_corr.T

    @property
    def W(self) -> np.ndarray:
        """(K, B+1, d) per-cluster MoE betas, intercept rows zeroed,
        recomputed from the final state (the reference exposes only the
        last cluster's, src/harmony.cpp:686), through the run's M-step
        layout (batch-tiled, segmented or dense)."""
        from .ops.ridge import moe_correct_ridge

        s = self.state
        codes = s.codes if self.mesh is None else sharding.gather_cells(s.codes, self.mesh)
        layout = mstep_layout(self.config, self._host(codes), s.device, self.mesh)
        _, _, W = moe_correct_ridge(
            self.config, s.Z_orig, s.R, s.O, s.E, s.codes, s.batch_sizes,
            s.lamb, s.Y, tiled=layout.tiled, segments=layout.segments, cells=layout.cells,
            mesh=self.mesh,
        )
        return self._host(W)

    def get_lambda(self) -> np.ndarray:
        """K x (B+1) ridge-penalty matrix (``getLambda``, src/harmony.cpp:657-669)."""
        if self.config.lambda_estimation:
            lam = self.config.alpha * self.E
            return np.concatenate([np.zeros((self.K, 1), lam.dtype), lam], axis=1)
        return np.broadcast_to(self._host(self.state.lamb), (self.K, self.B + 1)).copy()

    @property
    def sigma(self) -> np.ndarray:
        return self._host(self.state.sigma)

    @property
    def theta(self) -> np.ndarray:
        return self._host(self.state.theta)

    @property
    def Pr_b(self) -> np.ndarray:
        return self._host(self.state.Pr_b)

    @property
    def B_vec(self):
        return self.config.B_vec

    @property
    def alpha(self) -> float:
        return self.config.alpha

    def _traces(self):
        return self.state.trace_lists(self.config)

    @property
    def objective_kmeans(self) -> np.ndarray:
        return self._traces()["objective_kmeans"]

    @property
    def objective_kmeans_dist(self) -> np.ndarray:
        return self._traces()["objective_kmeans_dist"]

    @property
    def objective_kmeans_entropy(self) -> np.ndarray:
        return self._traces()["objective_kmeans_entropy"]

    @property
    def objective_kmeans_cross(self) -> np.ndarray:
        return self._traces()["objective_kmeans_cross"]

    @property
    def objective_harmony(self) -> np.ndarray:
        return self._traces()["objective_harmony"]

    @property
    def kmeans_rounds(self) -> np.ndarray:
        return self._traces()["kmeans_rounds"]


def resolve_mesh(mesh, device=None):
    """The ``mesh`` argument of :func:`run_harmony` as a
    ``sharding.CellMesh`` or None: ``"auto"`` is every rank of the
    initialised default group (None when it has one process or none, as
    harmony_tpu/api.py:426-429 does), on ``device`` or this rank's card."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be None, 'auto' or a sharding.CellMesh, got {mesh!r}")
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return None
        return sharding.make_mesh(device)
    return mesh


def run_harmony(
    data_mat,
    meta_data,
    vars_use: Optional[Sequence[str]] = None,
    theta: Optional[Union[float, Sequence[float]]] = None,
    sigma: Union[float, Sequence[float]] = 0.1,
    lamb: Optional[Union[float, Sequence[float]]] = None,
    nclust: Optional[int] = None,
    max_iter: int = 10,
    early_stop: bool = True,
    plot_convergence: bool = False,
    return_object: bool = False,
    verbose: bool = False,
    seed: int = 0,
    options: Optional[HarmonyOptions] = None,
    dtype: str = "float32",
    matmul_precision: str = "auto",
    ridge_solver: str = "auto",
    init_Y: Optional[np.ndarray] = None,
    mesh=None,
    shuffle_mode: str = "auto",
    estep_impl: str = "auto",
    mstep_impl: str = "auto",
    virtual_r: Optional[bool] = None,
    abort=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    stream_ingest="auto",
    device=None,
    **legacy,
):
    """Run Harmony integration on a cell-embedding matrix.

    Parameters mirror ``harmony_tpu.run_harmony`` (R/ui.R:91-107); ``lamb``
    is the reference's ``lambda`` (``None`` enables estimation), ``seed``
    seeds the ``torch.Generator`` behind the k-means draws and the
    per-round permutations, and ``init_Y`` (d x K or K x d) injects the
    initial centroids for parity runs. ``estep_impl``/``mstep_impl``: 'kernel' (the CUDA kernels),
    'torch' (plain PyTorch) or 'auto' (kernels for float32, bfloat16 and
    float16). ``device``:
    None for the card, or a torch device such as ``"cpu"``.

    ``shuffle_mode``: 'permute' is the reference-exact schedule; 'rotate'
    shuffles the cells once at ingest (the batch-tiled order of
    ops/tiled.py where it qualifies, else a plain permutation from
    ``seed``) and runs the stats-carrying rotate rounds (K6/K7) with the
    batch-tiled M-step (K7's fused moments, K9); below ``n_blocks * 128``
    cells (2,560 at the default ``block_size``) it runs the cell-granular
    rotate round instead (plain PyTorch, every round reading and writing
    R, with the dense M-step unless the order is batch-tiled), since whole
    tiles cannot make the reference's block count there. The rounds that
    read the old statistics from R on the tile schedule (K12,
    ``HarmonyConfig.rotate_stats_carry=False``) have no argument here, as
    in the JAX package: they are reached through the config and the
    driver (``preprocess.resolve_config``, ``dataclasses.replace``,
    ``finalize_engine_config``, ``state.init_state``, ``driver.run``).
    'auto' picks rotate at 100k cells and up
    unless ``init_Y`` is given. 'permute' at 200k cells and up (K <= 256,
    the default clustering budget, the kernels) runs each clustering phase
    as the fused R-gather-free phase (K2/K3; ``HarmonyConfig.permute_fused``
    resolves it): the permutations per round are the reference's, and without ``init_Y`` the cells are reordered
    once at ingest into the batch-tiled order, so the M-step takes its
    moments from K3 and corrects through K9. Runs with ``init_Y`` keep the
    caller's cell order.

    ``dtype``: 'float32' (the default), 'float64' (plain PyTorch), or
    'bfloat16' or 'float16', the reduced-precision engines: Z_orig, Z_corr,
    Y, R, O, E, sigma, theta, lambda, Pr_b and the batch sizes are stored
    in that dtype, as the JAX package stores them, and every sum runs in
    fp32 on operands upcast at the boundary, with results cast back where
    the JAX engine casts them; the arrays of a bf16 result come back as
    float32 numpy arrays holding the bf16 values, those of a float16
    result as float16 arrays. A float16 engine refuses a batch of more
    than 65,504 cells (``config.check_float16_batches``: its size, O and
    E would overflow float16).
    ``matmul_precision``: 'auto' resolves by dtype as in the JAX package
    ('bfloat16' for the reduced-precision engines, under which the rotate
    kernels' products g = Y^T Zn and the correction's W R take one bf16
    pass, ``HarmonyConfig.bf16_products``; every other product stays fp32,
    which it allows), or 'bfloat16', 'float32', 'highest' ('float32' and
    'highest' keep every product fp32).

    ``virtual_r``: None resolves by dtype as in the JAX package (off for
    float32, on for bfloat16 and float16). True, on a rotate run with the
    default clustering budget and
    a batch-tiled layout (the kernels), writes no (K, N) R during the
    rounds: the last round of each phase fuses the M-step's moments and
    stores its penalty tables, the correction recomputes R from them (K10)
    and R is rebuilt once at the end of the run (K11), so ``R`` and ``W``
    of the result are those of a run that wrote R. Elsewhere it is
    ignored, as the JAX package ignores it. A user-set ``mstep_tile`` that
    is not a multiple of 64 (160, with an ``estep_sub_tile`` it divides)
    runs too: K7 splits a piece's moments at a tile boundary and K10 cuts
    its steps at tile edges.

    The embedding goes to the card in engine-dtype column chunks, cast on
    the host, from a background thread (:class:`runtime.AsyncIngest`); the
    ingest order is then applied on the card (on a mesh each rank copies
    its columns of the order). ``stream_ingest``: 'auto' (the default) and
    True overlap the copy with the ingest order and the M-step layout;
    False finishes the copy first (on a mesh, where the copy needs the
    order, right after it). The state is the same bit for bit either way. The result's ``phase_seconds()`` splits the ingest:
    ``ingest_orient``, ``ingest_order``, ``ingest_stream`` (the wait for
    the copy) and ``ingest`` around the state's construction.

    ``mesh``: None (one device), ``"auto"`` (every rank of the initialised
    default ``torch.distributed`` group, on this rank's card, or on
    ``device`` where given; None when the group has one process or none,
    as the JAX package takes ``"auto"``) or a :class:`sharding.CellMesh`
    (``sharding.initialize_distributed``, then ``sharding.make_mesh``). Every
    rank calls ``run_harmony`` with the same arguments and the whole data;
    each streams and holds only its own cells (the cell axis padded to the
    mesh, ``sharding.pad_for_mesh``), runs the kernels on them and
    all-reduces the statistics, and the result's cell arrays gather every
    rank's cells in the caller's order (collectives: read them on every
    rank). Every route runs on a mesh, in float32, bf16 and float16
    (``dtype='bfloat16'``, ``'float16'``): the stats-carrying rotate route (R written or
    virtual), the fused permute phase, the per-round permute schedule and
    the cell-granular rotate round, each with the batch-tiled, segmented or
    dense M-step (``engine``'s module docstring); the rounds of the last
    two are plain PyTorch per rank, as they are XLA in the JAX package.
    The backend is the caller's:
    NCCL for one rank a card, gloo for several ranks on one card or on the
    CPU.

    ``abort`` (a :class:`runtime.AbortFlag`) is polled between rounds; a set
    flag raises ``KeyboardInterrupt``. ``checkpoint_path`` writes a minimal
    checkpoint (:mod:`checkpoint`) every ``checkpoint_every`` rounds, with
    the ingest order's recipe as its provenance, so ``harmony-torch run``
    resumes it; a diverged run raises :class:`runtime.DivergenceError`
    without replacing the last good checkpoint. ``plot_convergence`` draws
    :func:`plot.convergence_plot` (matplotlib) after the run. An
    AnnData-like ``data_mat`` (with ``obsm`` and ``obs``) goes to
    :func:`adapters.run_harmony_anndata` with ``meta_data`` (or
    ``vars_use``) naming the covariates.

    Returns (N, d) corrected embeddings, or a :class:`HarmonyResult` when
    ``return_object=True``.
    """
    if hasattr(data_mat, "obsm") and hasattr(data_mat, "obs"):
        # an AnnData-like first argument routes to the adapter, meta_data
        # naming the covariates (the UseMethod analog, R/RunHarmony.R:27-29)
        from .adapters import run_harmony_anndata

        group_by = vars_use if vars_use is not None else meta_data
        if isinstance(group_by, str):
            group_by = [group_by]
        return run_harmony_anndata(
            data_mat, group_by, theta=theta, sigma=sigma, lamb=lamb, nclust=nclust,
            max_iter=max_iter, early_stop=early_stop, plot_convergence=plot_convergence,
            verbose=verbose, seed=seed, options=options, dtype=dtype,
            matmul_precision=matmul_precision, ridge_solver=ridge_solver, init_Y=init_Y,
            mesh=mesh, shuffle_mode=shuffle_mode, estep_impl=estep_impl,
            mstep_impl=mstep_impl, virtual_r=virtual_r, abort=abort,
            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
            stream_ingest=stream_ingest, device=device, **legacy,
        )
    check_legacy_args(**legacy)
    mesh = resolve_mesh(mesh, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    if options is None:
        options = harmony_options()
    timers = PhaseTimers(dev)

    with timers.scope("ingest_orient"):
        design = build_design(meta_data, vars_use)
        N = design.n_cells
        Z = orient_embedding(data_mat, N, verbose=verbose)
    d = Z.shape[0]
    if verbose:
        from .driver import _ensure_verbose_handler

        _ensure_verbose_handler()
    shuffle_mode = _resolve_shuffle_mode(
        shuffle_mode, N, init_Y is not None, verbose
    )

    cfg = resolve_config(
        n_cells=N, d=d, design=design, nclust=nclust, max_iter=max_iter,
        early_stop=early_stop, options=options, verbose=verbose,
        lambda_estimation=lamb is None, dtype=dtype, ridge_solver=ridge_solver,
        shuffle_mode=shuffle_mode, matmul_precision=matmul_precision,
    )
    if mesh is not None:
        cfg = sharding.pad_for_mesh(cfg, mesh)
    cfg = dataclasses.replace(
        cfg, estep_impl=estep_impl, mstep_impl=mstep_impl, virtual_r=virtual_r
    )
    cfg = finalize_engine_config(cfg, mesh)
    hp = expand_hyperparams(
        design, cfg.K, theta, sigma, lamb, options.tau, verbose=verbose
    )
    if init_Y is not None:
        init_Y = np.asarray(init_Y, dtype=np.float64)
        if init_Y.shape == (cfg.K, cfg.d):
            init_Y = init_Y.T
        if init_Y.shape != (cfg.d, cfg.K):
            raise ValueError(f"init_Y must be (d, K)={cfg.d, cfg.K}")
    # the copy starts now (on a mesh each rank's at the order, of its own
    # columns of it) and overlaps the ingest order and the M-step layout
    with AsyncIngest(Z, cfg, dev, mesh=mesh, overlap=bool(stream_ingest)) as stream:
        with timers.scope("ingest_order"):
            perm, tiled_t = ingest_perm(cfg, design, seed, init_Y is not None)
            _, design, ingest_inv = apply_ingest_order(design, perm)
            stream.order(perm)
        layout = mstep_layout(cfg, design.codes, dev, mesh)
        with timers.scope("ingest_stream"):
            stream.join()
        with timers.scope("ingest_order"):
            Z = stream.result()
    ckpt_meta = {"shuffle_mode": cfg.shuffle_mode, "seed": seed, "tiled_tile": tiled_t,
                 "mesh_size": 0 if mesh is None else mesh.size}
    with timers.scope("ingest"):
        state = init_state(cfg, Z, design, hp.sigma, hp.theta, hp.lamb, seed, dev, timers,
                           mesh)
    del Z
    state = _run(cfg, state, verbose=verbose, Y0=init_Y, abort=abort, timers=timers,
                 layout=layout, checkpoint_path=checkpoint_path,
                 checkpoint_every=checkpoint_every, checkpoint_meta=ckpt_meta, mesh=mesh)
    result = HarmonyResult(config=cfg, state=state, design=design, timers=timers,
                           ingest_inv=ingest_inv, mesh=mesh)
    if plot_convergence:
        # the reference's plot_convergence hook (R/ui.R:285)
        import matplotlib.pyplot as plt

        from .plot import convergence_plot

        convergence_plot(result)
        plt.show()
    if return_object:
        return result
    return result.embeddings
