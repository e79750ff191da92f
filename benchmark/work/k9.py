"""K9, the batch-tiled correction (``ops/cuda_ridge.py``,
``tiled_correction``), float32.

It corrects the cells of the batch-pure layout tiles: reads R (K, n) and
Z_orig (d, n) and the joint batches' coefficients (n_joint + 1, d, K),
writes Z_corr (d, n), and forms 2 K d n FLOPs of products.
"""


def call_work(K: int, d: int, n_cells: int, n_joint: int):
    """(bytes, FLOPs) of one call over ``n_cells`` cells."""
    return 4 * (K * n_cells + 2 * d * n_cells + (n_joint + 1) * d * K), 2.0 * K * d * n_cells
