"""k9_roofline: K9's share of its roofline in the profiled slice.

K9 is the batch-tiled correction (ops/cuda_ridge.py, ``tiled_correction``;
``tiled_correction_kernel`` of ``tiled.cu``), once an iteration over the
cells of the batch-pure layout tiles. Its work: ``work/k9.py``.
"""

from benchmark.context import roofline
from benchmark.work import k9, peaks

SYMBOLS = ("tiled_correction_kernel",)


def read(ctx):
    tiled = ctx.layout.tiled
    if tiled is None:
        return None
    cfg = ctx.cfg
    its = sum(ctx.profiled)
    bound = its * peaks.bound_seconds(*k9.call_work(cfg.K, cfg.d, int(tiled.n_pure),
                                                    int(tiled.joint_codes.shape[1])))
    return roofline(ctx, "k9_roofline", SYMBOLS, "tiled_correction_kernel", its, bound)
