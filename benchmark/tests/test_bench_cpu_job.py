"""Whole runs of each cell at a tiny size on the CPU, through the port's
plain path (its kernels' plain twins), held to the plain reference by the
cell's own limits; and the reference against the port on the routes a
cell may take."""

import numpy as np
import pytest
import torch

from bench_helpers import small_cell

SEED = 2**31 + 977


@pytest.mark.parametrize("name,cells,batches,engine", [
    ("hca-500k.rotate", 16384, 3, None),
    ("hca-500k.permute", 16384, 3, {"permute_fused": True}),
    ("hca-500k.permute", 6000, 3, None),
    ("atlas-10m.rotate", 30000, 6, None),
])
def test_run_is_correct(name, cells, batches, engine):
    from benchmark import run

    cell = small_cell(name, cells, batches=batches)
    res = run.run_cell(cell, SEED, 0.5, False, "cpu", engine_overrides=engine)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check" and len(res["check"]) == 2 * len(cell.limits)
    assert set(res["metrics"]) == {e["name"] for e in cell.end_to_end}
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_traced_run_reads_its_metrics():
    from benchmark import run

    cell = small_cell("hca-500k.rotate", 16384, profiled_cells=16384)
    res = run.run_cell(cell, SEED + 1, 0.5, True, "cpu")
    assert res["correct"], res["check"]
    m = res["metrics"]
    # the CPU has no device trace: the readers of device metrics return nothing
    assert set(m) == {"iters", "init_ms", "iteration_ms"}
    assert m["iters"]["value"] >= 1 and m["iteration_ms"]["value"] > 0
    assert res["run"]["profiled_jobs"] == 1


@pytest.mark.parametrize("shuffle,cells,engine", [
    ("rotate", 16384, None), ("permute", 6000, None),
    ("permute", 16384, {"permute_fused": True})])
def test_reference_follows_the_port(shuffle, cells, engine):
    """One job of the port and the float64 reference from the same seed:
    float32's gaps on every route the cells take."""
    from benchmark import check, data, prepare
    from benchmark.reference import harmony as ref
    from benchmark.reference import ingest

    cell = small_cell(f"hca-500k.{shuffle}", cells)
    Z, lab = data.make(cell.config, SEED, "cpu")
    p = prepare.prepare(cell.config, cell.traffic, Z, lab, SEED, engine)
    assert p.cfg.permute_fused == bool(engine)
    st = ref.settings(prepare.settings(cell.config), cells, shuffle)
    geo = ingest.geometry(lab.numpy(), cells, 16, st.K, 3, shuffle, st.block_size, SEED,
                          permute_fused=(engine or {}).get("permute_fused"))
    assert geo.n_pad == p.cfg.Np
    js = prepare.job_seed(SEED, 5)
    nums = check.compare(check.program_outputs(prepare.job(p, js), cells),
                         ref.integrate(Z, lab, 3, st, geo, js))
    assert nums["iterations"] == 0
    assert nums["R_abs"] < 1e-5 and nums["Zcorr_rel"] < 1e-5 and nums["Y_abs"] < 1e-5
    assert nums["objective_rel"] < 1e-5


def test_job_leaves_its_input_as_it_was():
    """Every job of a window starts from the same prepared embedding."""
    from benchmark import data, prepare

    cell = small_cell("hca-500k.rotate", 16384)
    Z, lab = data.make(cell.config, SEED, "cpu")
    p = prepare.prepare(cell.config, cell.traffic, Z, lab, SEED)
    before = p.Z.clone()
    prepare.job(p, prepare.job_seed(SEED, 0))
    assert torch.equal(before, p.Z)


def test_data_is_the_seeds():
    from benchmark import data

    cell = small_cell("atlas-10m.rotate", 20000, batches=10)
    a, la = data.make(cell.config, SEED, "cpu")
    b, lb = data.make(cell.config, SEED, "cpu")
    c, _ = data.make(cell.config, SEED + 1, "cpu")
    assert torch.equal(a, b) and torch.equal(la, lb) and not torch.equal(a, c)
    sizes = torch.bincount(la, minlength=10)
    assert int(sizes.sum()) == 20000 and int(sizes.min()) >= 1
    assert float(sizes.max()) > 2 * float(sizes.float().median())  # lognormal skew
    assert np.isfinite(a.numpy()).all()
