"""A run with its timed path broken underneath must come out not correct:
once for each fault a cell can have. A step that returns its state
unchanged (the correction leaves Z_corr and the centroids as they were);
half of the cells left out of the correction's regression, the rest
counted twice; an answer altered where it is produced (one cell of the
corrected embedding). No cell runs across chips, so no exchange can be
left out."""

import dataclasses

import pytest

from bench_helpers import small_cell

SEED = 2**31 + 4099


def _unchanged(real):
    def fake(cfg, state, layout=None, mesh=None):
        out = real(cfg, state, layout, mesh)
        return dataclasses.replace(out, Z_corr=state.Z_corr, Y=state.Y)
    return fake


def _half(real):
    def fake(cfg, state, layout=None, mesh=None):
        R = state.R.clone()
        R[:, 1::2] = 0.0
        R[:, 0::2] *= 2.0
        return real(cfg, dataclasses.replace(state, R=R, tiled_moments=None), layout, mesh)
    return fake


def _altered(job):
    def broken(p, seed, timers=None):
        state = job(p, seed, timers)
        state.Z_corr[0, :] += 1e-3 * float(state.Z_corr.abs().max())
        return state
    return broken


@pytest.mark.parametrize("name,cells,batches", [
    ("hca-500k.rotate", 16384, 3), ("hca-500k.permute", 16384, 3),
    ("atlas-10m.rotate", 30000, 6)])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_caught(monkeypatch, name, cells, batches, fault):
    from benchmark import run
    from harmony_tpu_torch import engine

    engine_over = {"permute_fused": True} if "permute" in name else None
    cell = small_cell(name, cells, batches=batches)
    wrap = None
    if fault == "altered":
        wrap = _altered
    else:
        monkeypatch.setattr(engine, "correct",
                            (_unchanged if fault == "unchanged" else _half)(engine.correct))
    res = run.run_cell(cell, SEED, 0.2, False, "cpu", engine_overrides=engine_over,
                       fault=wrap)
    assert not res["correct"], res["check"]
