"""k2_roofline: K2's share of its roofline in the profiled slice.

K2 is the fused permute phase's head and rounds (ops/cuda_permute.py,
``permute_rounds``; ``permute_phase.cu``): ``head_kernel`` once a phase,
then a round's ``round_cells_kernel`` (the removal pass, then one pass a
block) and ``commit_kernel`` (once a block and once more). The name
``commit_kernel`` is K1's too (``estep_round.cu``); no cell that reports
this metric runs K1. Its work: ``work/k2.py``.
"""

from benchmark.context import roofline
from benchmark.work import k2, peaks

SYMBOLS = ("head_kernel", "round_cells_kernel", "commit_kernel")


def read(ctx):
    cfg = ctx.cfg
    R = cfg.max_iter_cluster
    its = sum(ctx.profiled)
    bound = its * peaks.bound_seconds(*k2.phase_work(cfg.K, cfg.d, cfg.N, cfg.n_covariates, R))
    return roofline(ctx, "k2_roofline", SYMBOLS, "round_cells_kernel",
                    (cfg.n_blocks + 1) * R * its, bound)
