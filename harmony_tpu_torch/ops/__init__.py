"""Tensor operations of the PyTorch/CUDA engine.

Plain PyTorch modules mirror ``harmony_tpu/ops``; ``cuda_estep`` and
``cuda_ridge`` wrap the hand-written CUDA kernels (sources in ``csrc/``).
"""

from .assign import compute_distances, initial_assignments, make_blocks
from .estep import RoundResult, block_update_round, objective_from_stats
from .kmeans import kmeans_centers
from .normalize import l1_normalize_columns, l2_normalize_columns
from .objective import compute_objective
from .ridge import moe_correct_ridge
from .stats import compute_E, compute_O, one_hot_design, penalty_for_cells
