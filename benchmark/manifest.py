"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations, the traffic mixes and the metrics. Everything that belongs
to one of them sits in a file of its own under ``benchmark/``:

* ``configs/<config>.json``: the deployment: sizes, the data generator's
  parameters, the settings (``BENCHMARK.json`` gives the path);
* ``traffic/<traffic>.json``: the job mix run against it (schedule, job
  seeds, the traced slice);
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct`` for the cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns its value or None.

A later change adds a cell, a mix or a metric by adding files and entries;
no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load(path: Path = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: dict, cell: str) -> bool:
    """Does ``cell`` report ``metric``: every cell, or those it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: Optional[dict] = None) -> Cell:
    """The named cell with its configuration, traffic mix and limits."""
    m = load() if manifest is None else manifest
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in m["configs"]}
    conf = _json(ROOT / configs[w["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _json(HERE / "limits" / f"{name}.json")
    return Cell(name=name, config=conf, traffic=traffic, limits=limits, chips=int(w["chips"]),
                end_to_end=[e for e in m["end_to_end"] if reports(e, name)],
                per_layer=[p for p in m["per_layer"] if reports(p, name)])


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(per_layer: List[dict]) -> Dict[str, object]:
    return {p["name"]: metric_reader(p["name"]) for p in per_layer}
