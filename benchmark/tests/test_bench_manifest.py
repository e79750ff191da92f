"""BENCHMARK.json against the benchmark's contract, and the harness
finding a cell and a metric added as new files only."""

import importlib.util
import json
import re
import shutil
import sys

import pytest

from bench_helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def test_keys_and_names(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) == tuple(w["name"].split(".", 1))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    reports = lambda m, c: "workloads" not in m or c in m["workloads"]
    for p in bench["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert p["moves"] in e2e and 1 <= len(p["layer"]) <= 200
        for c in cells:
            if reports(p, c):
                # the metric it moves is reported where it is
                assert reports(e2e[p["moves"]], c), (p["name"], c)
        for c in p.get("workloads", []):
            assert c in cells
        if p["name"].endswith("_roofline"):
            assert p["unit"] == "%"
    for c in cells:
        got = [m["name"] for m in bench["end_to_end"] if reports(m, c)]
        assert "setup_s" in got and len(got) >= 2
        assert any(reports(p, c) for p in bench["per_layer"])


def test_files_exist(bench):
    from benchmark import check, manifest

    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.relative_to(ROOT).parts[0] == "benchmark"
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.traffic["shuffle_mode"] in ("rotate", "permute")
        assert set(check.REQUIRED) <= set(cell.limits) <= set(check.NUMBERS)
        assert cell.limits["iterations"] == 0
    for p in bench["per_layer"]:
        assert callable(manifest.metric_reader(p["name"]))


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A new cell (configuration, traffic mix, limits) and a new per-layer
    metric take files and manifest entries only: the harness lists them."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "hca-500k.json").read_text())
    conf.update(name="dummy", cells=4096)
    (b / "configs" / "dummy.json").write_text(json.dumps(conf))
    (b / "traffic" / "slow.json").write_text(json.dumps({"shuffle_mode": "permute"}))
    (b / "limits" / "dummy.slow.json").write_text((b / "limits" / "hca-500k.rotate.json")
                                                  .read_text())
    (b / "metrics" / "dummy_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.jobs))\n")
    bench["configs"].append({"name": "dummy", "source": "https://example.org",
                             "file": "benchmark/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.slow", "config": "dummy", "traffic": "slow",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_count", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "integrate_s", "workloads": ["dummy.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = importlib.util.spec_from_file_location("copied_manifest", b / "manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cell = mod.cell("dummy.slow")
    assert cell.config["cells"] == 4096 and cell.traffic["shuffle_mode"] == "permute"
    assert [p["name"] for p in cell.per_layer][-1] == "dummy_count"
    assert "integrate_p95_s" not in [e["name"] for e in cell.end_to_end]
    from benchmark.context import Context, Job

    ctx = Context(cfg=None, layout=None, jobs=[Job(3, 0.1, 0.2)] * 2, profiled=[], slice=None)
    sys.path.insert(0, str(tmp_path))
    try:
        assert mod.readers(cell.per_layer)["dummy_count"](ctx) == 2.0
    finally:
        sys.path.remove(str(tmp_path))
    assert "dummy.slow" not in [w["name"] for w in mod.load(ROOT / "BENCHMARK.json")
                                ["workloads"]]
