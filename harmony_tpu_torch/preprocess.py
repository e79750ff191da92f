"""Input pipeline: metadata -> integer batch codes, hyperparameter expansion.

The port's own copy of ``harmony_tpu/preprocess.py`` (R/ui.R:91-309). The
sparse one-hot design Phi (R/ui.R:210-213) is carried as per-covariate
integer codes; every Phi product is then a segment operation on the codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .config import (
    HarmonyConfig, HarmonyConfigError, HarmonyOptions, check_float16_batches, default_nclust,
    dtype_name,
)


@dataclasses.dataclass
class DesignMatrix:
    """Integer-coded categorical design over one or more covariates.

    ``codes[c, n]`` is the level of covariate ``c`` for cell ``n``; the
    global batch row is ``offsets[c] + codes[c, n]`` (src/harmony.cpp:48-65).
    """

    codes: np.ndarray  # (n_cov, N) int32, per-covariate local level ids
    levels: List[np.ndarray]  # per covariate, sorted unique level values
    names: List[str]  # covariate names

    @property
    def n_cells(self) -> int:
        return self.codes.shape[1]

    @property
    def B_vec(self) -> Tuple[int, ...]:
        return tuple(len(lv) for lv in self.levels)

    @property
    def B(self) -> int:
        return int(sum(self.B_vec))

    @property
    def offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for b in self.B_vec:
            offs.append(acc)
            acc += b
        return tuple(offs)

    @property
    def global_codes(self) -> np.ndarray:
        """(n_cov, N) int32 codes offset into the global [0, B) row space."""
        return self.codes + np.asarray(self.offsets, dtype=np.int32)[:, None]

    def batch_sizes(self) -> np.ndarray:
        """N_b: cells per global batch level (rowSums(Phi), R/ui.R:216)."""
        out = np.zeros(self.B, dtype=np.int64)
        gc = self.global_codes
        for c in range(gc.shape[0]):
            out += np.bincount(gc[c], minlength=self.B)
        return out


def build_design(meta_data, vars_use: Optional[Sequence[str]]) -> DesignMatrix:
    """Factor-code covariates from a metadata table or a bare label vector.

    Bare vector metadata becomes one covariate named ``batch_variable``
    (R/ui.R:158-166); missing ``vars_use`` raises (R/ui.R:168-172); levels
    are the sorted unique values (R ``as.factor``, R/ui.R:210-213).
    """
    columns: Dict[str, np.ndarray]
    if hasattr(meta_data, "columns") and hasattr(meta_data, "__getitem__"):
        columns = {str(c): np.asarray(meta_data[c]) for c in meta_data.columns}
    elif isinstance(meta_data, Mapping):
        columns = {str(k): np.asarray(v) for k, v in meta_data.items()}
    else:
        arr = np.asarray(meta_data)
        if arr.ndim != 1:
            raise HarmonyConfigError(
                "meta_data must be a dataframe/mapping of covariates or a "
                "vector with batch values for each cell"
            )
        columns = {"batch_variable": arr}
        vars_use = ["batch_variable"]

    if vars_use is None or len(vars_use) == 0 or any(
        v not in columns for v in vars_use
    ):
        raise HarmonyConfigError(
            "must provide variable names present in meta_data "
            "(e.g. vars_use=['stim'])"
        )

    lengths = {len(v) for v in columns.values()}
    if len(lengths) != 1:
        raise HarmonyConfigError("meta_data columns have inconsistent lengths")

    codes_list, levels_list = [], []
    for name in vars_use:
        levels, codes = np.unique(columns[name], return_inverse=True)
        if len(levels) < 1:
            raise HarmonyConfigError(f"covariate {name!r} has no levels")
        codes_list.append(codes.astype(np.int32))
        levels_list.append(levels)

    return DesignMatrix(
        codes=np.stack(codes_list, axis=0),
        levels=levels_list,
        names=[str(v) for v in vars_use],
    )


def orient_embedding(data_mat, n_cells: int, verbose: bool = False) -> np.ndarray:
    """Return the embedding as (d, N) float64, transposing cells-as-rows
    input (R/ui.R:178-188)."""
    data_mat = np.asarray(data_mat)
    if data_mat.ndim != 2:
        raise HarmonyConfigError("data_mat must be a 2-D cell embedding matrix")
    if data_mat.shape[0] == n_cells:
        data_mat = data_mat.T
    if data_mat.shape[1] != n_cells:
        raise HarmonyConfigError(
            "number of labels do not correspond to number of samples in data "
            "matrix"
        )
    return np.ascontiguousarray(data_mat, dtype=np.float64)


@dataclasses.dataclass
class ExpandedHyperparams:
    """Per-level hyperparameter vectors as handed to the engine."""

    sigma: np.ndarray  # (K,)
    theta: np.ndarray  # (B,)
    lamb: np.ndarray  # (B+1,) with 0 intercept; ignored in estimation mode
    lambda_estimation: bool


def expand_hyperparams(
    design: DesignMatrix,
    nclust: int,
    theta: Optional[Union[float, Sequence[float]]],
    sigma: Union[float, Sequence[float]],
    lamb: Optional[Union[float, Sequence[float]]],
    tau: float,
    verbose: bool = False,
) -> ExpandedHyperparams:
    """Expand user hyperparameters to per-level vectors (R/ui.R:196-258)."""
    n_vars = len(design.B_vec)
    B = design.B

    if theta is None:
        theta_per_var = np.full(n_vars, 2.0)
    else:
        theta_per_var = np.atleast_1d(np.asarray(theta, dtype=np.float64))
        if theta_per_var.size != n_vars:
            raise HarmonyConfigError("Please specify theta for each variable")

    theta_vec = np.concatenate(
        [np.full(b, theta_per_var[i]) for i, b in enumerate(design.B_vec)]
    )
    # theta * (1 - exp(-(N_b/(K*tau))^2)) (R/ui.R:258); tau=0 leaves theta
    N_b = design.batch_sizes().astype(np.float64)
    if tau > 0:
        theta_vec = theta_vec * (1.0 - np.exp(-((N_b / (nclust * tau)) ** 2)))

    sigma_vec = np.atleast_1d(np.asarray(sigma, dtype=np.float64))
    if sigma_vec.size == 1 and nclust > 1:
        sigma_vec = np.full(nclust, sigma_vec[0])
    if sigma_vec.size != nclust:
        raise HarmonyConfigError("sigma must be a scalar or length-K vector")

    if lamb is None:
        return ExpandedHyperparams(
            sigma=sigma_vec,
            theta=theta_vec,
            lamb=np.zeros(B + 1, dtype=np.float64),
            lambda_estimation=True,
        )
    lamb_arr = np.atleast_1d(np.asarray(lamb, dtype=np.float64))
    if not np.all(lamb_arr > 0):
        raise HarmonyConfigError("Provided lambdas must be positive")
    if lamb_arr.size == 1:
        lamb_vec = np.concatenate([[0.0], np.full(B, lamb_arr[0])])
    else:
        if lamb_arr.size != n_vars:
            raise HarmonyConfigError(
                f"You specified a lambda value for each covariate but the "
                f"number of lambdas specified ({lamb_arr.size}) and the number "
                f"of covariates ({n_vars}) mismatch."
            )
        lamb_vec = np.concatenate(
            [[0.0]] + [np.full(b, lamb_arr[i]) for i, b in enumerate(design.B_vec)]
        )
    return ExpandedHyperparams(
        sigma=sigma_vec, theta=theta_vec, lamb=lamb_vec, lambda_estimation=False
    )


def resolve_config(
    n_cells: int,
    d: int,
    design: DesignMatrix,
    nclust: Optional[int],
    max_iter: int,
    early_stop: bool,
    options: HarmonyOptions,
    verbose: bool,
    lambda_estimation: bool = False,
    dtype: str = "float32",
    ridge_solver: str = "cholesky",
    shuffle_mode: str = "permute",
    matmul_precision: str = "auto",
) -> HarmonyConfig:
    """Assemble the static engine config (R/ui.R:133-150, 192-194). A
    float16 engine with a batch past float16's range raises
    (:func:`config.check_float16_batches`)."""
    check_float16_batches(dtype, design.batch_sizes())
    if nclust is None:
        nclust = default_nclust(n_cells)
    nclust = max(int(nclust), 1)
    epsilon_harmony = options.epsilon_harmony if early_stop else -np.inf
    return HarmonyConfig(
        N=n_cells,
        d=d,
        K=nclust,
        B=design.B,
        B_vec=design.B_vec,
        max_iter_harmony=max_iter,
        max_iter_cluster=options.max_iter_cluster,
        epsilon_cluster=options.epsilon_cluster,
        epsilon_harmony=float(epsilon_harmony),
        alpha=options.alpha,
        batch_prop_cutoff=options.batch_prop_cutoff,
        lambda_estimation=lambda_estimation,
        block_size=options.block_size,
        shuffle_mode=shuffle_mode,
        dtype=dtype_name(dtype),
        # 'auto' resolves by dtype in finalize_engine_config
        matmul_precision=matmul_precision,
        ridge_solver=ridge_solver,
        verbose=verbose,
    )
