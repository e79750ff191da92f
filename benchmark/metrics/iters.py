"""iters: the mean number of Harmony iterations an integration of the
traced window ran after the profiled slice (``state.n_harmony``; the
early stop, driver.harmonize)."""


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(j.iterations for j in ctx.jobs) / len(ctx.jobs)
