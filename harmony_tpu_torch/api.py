"""Public API: ``run_harmony`` — NumPy in / NumPy out, on the card.

Counterpart of ``harmony_tpu/api.py`` (``RunHarmony.default``,
R/ui.R:91-309), with the same signature plus ``device``. ``device=None``
means the card; without one the call raises instead of carrying on on the
CPU. Arguments that select a path not ported yet raise
``NotImplementedError`` naming the ROADMAP item; nothing is rerouted.
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
from .driver import run as _run
from .preprocess import (
    DesignMatrix,
    build_design,
    expand_hyperparams,
    orient_embedding,
    resolve_config,
)
from .runtime import PhaseTimers, resolve_device
from .state import HarmonyState, init_state

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


@dataclasses.dataclass
class HarmonyResult:
    """Result object mirroring the reference engine's exposed fields
    (RCPP_MODULE, src/harmony.cpp:672-709). Arrays are host copies."""

    config: HarmonyConfig
    state: HarmonyState
    design: DesignMatrix
    timers: Optional[PhaseTimers] = None

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
        return X.detach().cpu().numpy()

    @property
    def Z_corr(self) -> np.ndarray:
        """(d, N) corrected embedding (``getZcorr``)."""
        return self._host(self.state.Z_corr)

    @property
    def Z_orig(self) -> np.ndarray:
        return self._host(self.state.Z_orig)

    @property
    def Y(self) -> np.ndarray:
        """(d, K) centroids (``getCentroids``)."""
        return self._host(self.state.Y)

    @property
    def R(self) -> np.ndarray:
        """(K, N) soft assignments (``getR``)."""
        return self._host(self.state.R)

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
        last cluster's, src/harmony.cpp:686)."""
        from .ops.ridge import moe_correct_ridge

        s = self.state
        _, _, W = moe_correct_ridge(
            self.config, s.Z_orig, s.R, s.O, s.E, s.codes, s.batch_sizes,
            s.lamb, s.Y,
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to harmony_tpu_torch yet ({item})")


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
    'torch' (plain PyTorch) or 'auto' (kernels for float32). ``device``:
    None for the card, or a torch device such as ``"cpu"``.

    Returns (N, d) corrected embeddings, or a :class:`HarmonyResult` when
    ``return_object=True``.
    """
    if hasattr(data_mat, "obsm") and hasattr(data_mat, "obs"):
        raise _not_ported("the AnnData adapter", "ROADMAP A10")
    check_legacy_args(**legacy)
    if mesh is not None:
        raise _not_ported("mesh (multi-device runs)", "ROADMAP A11")
    if checkpoint_path is not None:
        raise _not_ported("checkpoint_path", "ROADMAP A10")
    if stream_ingest not in ("auto", False):
        raise _not_ported("stream_ingest", "ROADMAP A10")
    if plot_convergence:
        raise _not_ported("plot_convergence", "ROADMAP A10")
    if matmul_precision not in ("auto", "float32", "highest"):
        raise _not_ported(
            f"matmul_precision={matmul_precision!r} (reduced-precision products)",
            "ROADMAP A9",
        )
    dev = resolve_device(device)
    if options is None:
        options = harmony_options()

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
    if shuffle_mode != "permute":
        raise _not_ported(f"shuffle_mode={shuffle_mode!r}", "ROADMAP A9")

    cfg = resolve_config(
        n_cells=N, d=d, design=design, nclust=nclust, max_iter=max_iter,
        early_stop=early_stop, options=options, verbose=verbose,
        lambda_estimation=lamb is None, dtype=dtype, ridge_solver=ridge_solver,
        shuffle_mode=shuffle_mode,
    )
    cfg = dataclasses.replace(
        cfg, estep_impl=estep_impl, mstep_impl=mstep_impl, virtual_r=virtual_r
    )
    cfg = finalize_engine_config(cfg)
    hp = expand_hyperparams(
        design, cfg.K, theta, sigma, lamb, options.tau, verbose=verbose
    )
    if init_Y is not None:
        init_Y = np.asarray(init_Y, dtype=np.float64)
        if init_Y.shape == (cfg.K, cfg.d):
            init_Y = init_Y.T
        if init_Y.shape != (cfg.d, cfg.K):
            raise ValueError(f"init_Y must be (d, K)={cfg.d, cfg.K}")

    timers = PhaseTimers(dev)
    with timers.scope("ingest"):
        state = init_state(cfg, Z, design, hp.sigma, hp.theta, hp.lamb, seed, dev)
    state = _run(cfg, state, verbose=verbose, Y0=init_Y, abort=abort,
                 timers=timers)
    result = HarmonyResult(config=cfg, state=state, design=design, timers=timers)
    if return_object:
        return result
    return result.embeddings
