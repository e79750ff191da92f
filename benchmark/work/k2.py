"""K2, the fused permute phase's head and rounds (``ops/cuda_permute.py``,
``permute_rounds``), float32.

A phase reads Z (d, N) and the codes once and each round's permutation
(int64), and writes each cell's block id once; the distances G = 2 (1 -
Y^T Z) are needed once a phase, 2 K d N FLOPs, as Y and Z are fixed
within it. The per-round statistics and penalty tables are small.
"""


def phase_work(K: int, d: int, N: int, ncov: int, rounds: int):
    """(bytes, FLOPs) of one phase of ``rounds`` rounds."""
    return 4 * (d * N + ncov * N + N) + 8 * N * rounds, 2.0 * K * d * N
