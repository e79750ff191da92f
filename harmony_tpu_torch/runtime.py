"""Runtime pieces the API uses: device choice, phase timers, divergence.

Counterpart of the parts of ``harmony_tpu/runtime.py`` that ``api`` needs.
Timers synchronise with the card at the end of each scope, so a scope's
wall time is the work it enqueued, not its dispatch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, raise instead of falling back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimers:
    """Named wall-clock accumulators (the reference's ``timers`` map,
    src/timer.h:20). ``device`` is synchronised at each scope's end."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self._acc[name] = self._acc.get(name, 0.0) + dt

    def as_dict(self) -> Dict[str, float]:
        return dict(self._acc)


class DivergenceError(RuntimeError):
    """The objective trace went non-finite (NaN/Inf) mid-run. Index 0 is the
    initial clustering's objective; index i >= 1 the objective after round i."""

    def __init__(self, round_idx: int, values):
        self.round_idx = round_idx
        self.values = values
        if round_idx == 0:
            where = (
                "at initialization (the objective of the initial "
                "clustering, before any harmony round — the input itself "
                "is likely non-finite or badly scaled)"
            )
        else:
            where = f"at round {round_idx}"
        super().__init__(
            f"harmony objective became non-finite {where} "
            f"(objective trace tail: {values}); the run has diverged — "
            "check input scaling (embeddings should be PCA-scaled), "
            "sigma > 0, and lambda >= 0"
        )
