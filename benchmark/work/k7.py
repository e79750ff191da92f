"""K7, one stats-carrying rotate round (``ops/cuda_rotate.py``,
``rotate_update_round_v2``), float32.

Every round reads the phase's Gram table G (Np, K) and the codes, and
reads and writes the per-tile table (NT, K, B). The phase's last round
also writes R (K, Np) where the route writes it and, with the fused
moments, reads Z_orig (d, Np) and writes the joint-batch moments
(n_joint + 1, K, d + 1), whose product is 2 K (d + 1) Np FLOPs. The
assignment chain's elementwise operations are not counted.
"""


def round_work(K: int, d: int, Np: int, ncov: int, NT: int, B: int, write_r: bool = False,
               n_joint: int = -1):
    """(bytes, FLOPs) of one K7 round; ``n_joint`` >= 0 adds the fused
    moments of that many joint batches (the last round's)."""
    nbytes = 4 * (K * Np + ncov * Np + 2 * NT * K * B)
    flops = 0.0
    if write_r:
        nbytes += 4 * K * Np
    if n_joint >= 0:
        nbytes += 4 * (d * Np + (n_joint + 1) * K * (d + 1))
        flops += 2.0 * K * (d + 1) * Np
    return nbytes, flops
