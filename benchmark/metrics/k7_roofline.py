"""k7_roofline: K7's share of its roofline in the profiled slice.

K7 is the stats-carrying rotate round (ops/cuda_rotate.py,
``rotate_update_round_v2``): per round ``rot_assign_kernel`` once a
block and ``rot_commit_kernel`` once a block and once more; on a phase's
last round the fused moments' per-joint sum (``sum_chunks_kernel`` of
``tiled.cu``, which on the stats-carrying route no other kernel launches).
Its work: ``work/k7.py``, the last round writing R and the moments.
"""

from benchmark.context import roofline
from benchmark.work import k7, peaks

SYMBOLS = ("rot_assign_kernel", "rot_commit_kernel", "sum_chunks_kernel")


def read(ctx):
    cfg, tiled = ctx.cfg, ctx.layout.tiled
    NT = cfg.Np // cfg.estep_sub_tile
    nb = min(cfg.n_blocks, NT)
    R = cfg.max_iter_cluster
    its = sum(ctx.profiled)
    nj = -1 if tiled is None else int(tiled.joint_codes.shape[1])
    args = (cfg.K, cfg.d, cfg.Np, cfg.n_covariates, NT, cfg.B)
    bound = its * ((R - 1) * peaks.bound_seconds(*k7.round_work(*args))
                   + peaks.bound_seconds(*k7.round_work(*args, write_r=True, n_joint=nj)))
    return roofline(ctx, "k7_roofline", SYMBOLS, "rot_assign_kernel", nb * R * its, bound)
