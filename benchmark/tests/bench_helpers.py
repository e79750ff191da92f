"""Helpers of the benchmark's tests."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def small_cell(name: str, cells: int, dims: int = 16, batches: int = 3, nclust: int = 16,
               profiled_cells: int = 0):
    """The named cell of BENCHMARK.json cut to a size the CPU runs in
    seconds; its limits are the cell's own."""
    from benchmark import manifest

    c = manifest.cell(name)
    conf = dict(c.config, cells=cells, dims=dims, batches=batches)
    conf["harmony"] = dict(conf["harmony"], nclust=nclust)
    return c._replace(config=conf, traffic=dict(c.traffic, profiled_cells=profiled_cells))
