"""Convergence plotting (the analog of ``HarmonyConvergencePlot``,
R/utils.R:50-81), as ``harmony_tpu/plot.py`` draws it: the clustering
objective per k-means step, one colour per Harmony round. Needs
matplotlib, imported at the call."""

from __future__ import annotations

from typing import Optional

import numpy as np


def convergence_plot(result, round_start: int = 1, round_end: Optional[int] = None, ax=None):
    """Scatter the clustering objective per k-means step, one colour per
    Harmony round, of a :class:`harmony_tpu_torch.api.HarmonyResult`.

    The initial (pre-clustering) objective is dropped, as the reference's
    ``tail(objective_kmeans, -1)`` drops it (R/utils.R:64). Returns the
    axes."""
    import matplotlib.pyplot as plt

    rounds = np.asarray(result.kmeans_rounds)
    vals = np.asarray(result.objective_kmeans)[1:]
    harmony_idx = np.concatenate([np.full(r, i + 1) for i, r in enumerate(rounds)]
                                 or [np.zeros(0, np.int64)])
    if round_end is None:
        round_end = int(harmony_idx.max()) if harmony_idx.size else 0
    m = (harmony_idx >= round_start) & (harmony_idx <= round_end)
    vals = vals[: len(harmony_idx)][m]
    harmony_idx = harmony_idx[m]
    idx = np.arange(1, len(vals) + 1)
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4))
    for h in np.unique(harmony_idx):
        sel = harmony_idx == h
        ax.scatter(idx[sel], vals[sel], label=f"{h}", s=18)
    ax.set_xlabel("Clustering Step #")
    ax.set_ylabel("Objective Function")
    ax.legend(title="Integration #", fontsize=8)
    return ax
