"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the checkout. Those marked ``card`` need a CUDA card and skip
without one (the chip: ``python3 -m pytest benchmark/tests -q -m card``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    import torch

    # several workers share the host's cores: two threads each, not all
    torch.set_num_threads(2)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda:0")
