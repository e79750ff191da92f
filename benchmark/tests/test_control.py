"""The control on the card: the reference in TF32 (float32 products on
the tensor cores, the precision below the configurations' float32) put
in the program's place must fail the cell's limits. At the cells' own
size it runs by ``python3 benchmark/control.py``; here at 200,000 cells
(atlas-10m at 2,000,000), one seed."""

import pytest
import torch


SEED = 2**31 + 6007


@pytest.mark.card
@pytest.mark.parametrize("name,cells", [("hca-500k.rotate", 200_000),
                                        ("hca-500k.permute", 200_000),
                                        ("atlas-10m.rotate", 2_000_000)])
def test_control_fails(card, name, cells):
    from benchmark import control, manifest

    cell = manifest.cell(name)
    cell = cell._replace(config=dict(cell.config, cells=cells))
    nums = control.control_numbers(cell, SEED, card)
    assert any(k in cell.limits and not v <= cell.limits[k] for k, v in nums.items()), nums


@pytest.mark.card
def test_float64_control_passes(card):
    """The same path without TF32, in float64, reads nought: the control
    fails for its precision, not for its path."""
    from benchmark import control, manifest

    cell = manifest.cell("hca-500k.rotate")
    cell = cell._replace(config=dict(cell.config, cells=50_000))
    nums = control.control_numbers(cell, SEED, card, dtype=torch.float64, tf32=False)
    assert all(v <= 1e-9 for v in nums.values()), nums
