"""The embedding a cell integrates, made on the device from the seed.

One generator for every configuration, driven by its ``generator`` block:
cells of ``cell_types`` types (type centres ``type_scale`` times a normal
draw), each batch shifted by an offset (``batch_scale`` times a normal
draw), plus unit normal noise. How the cells fall into batches and types
is the block's ``kind``:

* ``uniform``: every cell draws its type and its batch uniformly (the
  draws of ``chip_smoke.synthetic``, which every chip figure of the port
  since its first slice used);
* ``skewed``: batch sizes in proportion to lognormal draws
  (``size_sigma``), each batch's type composition a Dirichlet draw
  (``composition_alpha``), as real atlases are uneven in both.

Everything is drawn from one ``torch.Generator`` on the device seeded
with the run's seed, in a few large calls, so the same seed gives the
same data.
"""

from __future__ import annotations

from typing import Tuple

import torch


def make(conf: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z (N, d) float32, batch labels (N,) int64), both on ``device``."""
    N, d, B = int(conf["cells"]), int(conf["dims"]), int(conf["batches"])
    gen = conf["generator"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_types = int(gen["cell_types"])
    if gen["kind"] == "uniform":
        types = torch.randint(0, n_types, (N,), generator=g, device=device)
        batches = torch.randint(0, B, (N,), generator=g, device=device)
    elif gen["kind"] == "skewed":
        batches, types = _skewed(N, B, n_types, float(gen["size_sigma"]),
                                 float(gen["composition_alpha"]), g, device)
    else:
        raise ValueError(f"unknown generator kind {gen['kind']!r}")
    tc = torch.randn(n_types, d, generator=g, device=device) * float(gen["type_scale"])
    bo = torch.randn(B, d, generator=g, device=device) * float(gen["batch_scale"])
    noise = torch.randn(N, d, generator=g, device=device) * float(gen["noise"])
    Z = tc[types] + bo[batches] + noise
    return Z, batches


def _skewed(N, B, n_types, size_sigma, alpha, g, device):
    """Batch labels with lognormal sizes (each batch at least one cell),
    types from each batch's Dirichlet(alpha) composition, cells shuffled."""
    w = torch.exp(size_sigma * torch.randn(B, generator=g, device=device, dtype=torch.float64))
    raw = w / w.sum() * (N - B)
    sizes = torch.floor(raw).long() + 1
    # the cells the floors left over, to the largest remainders
    short = N - int(sizes.sum())
    sizes[torch.argsort(raw - torch.floor(raw), descending=True)[:short]] += 1
    batches = torch.repeat_interleave(torch.arange(B, device=device), sizes)
    if alpha != 1.0:
        raise ValueError("only Dirichlet(1) compositions are drawn here")
    # Dirichlet(1): normalised unit exponentials
    e = -torch.log(torch.rand(B, n_types, generator=g, device=device,
                              dtype=torch.float64).clamp(min=1e-300))
    cdf = torch.cumsum(e / e.sum(dim=1, keepdim=True), dim=1)
    cdf[:, -1] = 1.0
    u = torch.rand(N, generator=g, device=device, dtype=torch.float64)
    types = torch.searchsorted(cdf[batches], u[:, None]).squeeze(1).clamp(max=n_types - 1)
    order = torch.randperm(N, generator=g, device=device)
    return batches[order], types[order]
