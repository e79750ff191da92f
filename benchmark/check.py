"""The comparison that decides ``correct``.

A checked job is compared with the plain reference (``reference/``) run
from the same inputs and the same job seed. The numbers compared, each
held to the cell's own limit (``limits/<cell>.json``):

* ``iterations``: the gap of the Harmony iteration counts (the early
  stop), exact;
* ``objective_rel``: the widest gap of the objective trace (after the
  k-means init and after each iteration's clustering), each over the
  magnitude of the reference's objective at that point. Compared only
  in a cell whose limits name it: where the objective's terms nearly
  cancel, float32's rounding of the terms is a large share of their sum
  and the gap swings past any limit the control's readings leave;
* ``R_abs``: the widest gap of the last round's assignments R;
* ``Zcorr_rel``: the widest gap of the corrected embedding over the
  largest magnitude of the reference's;
* ``Y_abs``: the widest gap of the final centroids (unit columns).

A number that is not finite fails.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

NUMBERS = ("objective_rel", "iterations", "R_abs", "Zcorr_rel", "Y_abs")
# what every cell compares; ``objective_rel`` only where its limits name it
REQUIRED = ("iterations", "R_abs", "Zcorr_rel", "Y_abs")


def program_outputs(state, N: int, cols: Optional[torch.Tensor] = None) -> dict:
    """What a job produced, taken off the program's state: its objective
    trace and iteration count, and R, Z_corr (all cells, or the columns
    ``cols``) and Y, copies on the device, in engine order."""
    R, Zc = state.R[:, :N], state.Z_corr[:, :N]
    if cols is not None:
        R, Zc = R.index_select(1, cols), Zc.index_select(1, cols)
    n = int(state.n_harmony)
    obj = state.objective_harmony[:n].detach().cpu().numpy().astype(np.float64)
    return {"objective": obj, "iterations": n - 1, "Y": state.Y.detach().clone(),
            "R": R.detach().clone(), "Z_corr": Zc.detach().clone()}


def compare(prog: dict, ref, cols: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The compared numbers of one job (``prog`` from
    :func:`program_outputs`, ``ref`` a ``reference.harmony.Result``)."""
    R_r, Z_r = ref.R, ref.Z_corr
    if cols is not None:
        R_r, Z_r = R_r.index_select(1, cols), Z_r.index_select(1, cols)
    dev = R_r.device

    def gap(a, b):
        return float((a.to(dev, torch.float64) - b.to(torch.float64)).abs().max())

    n = min(len(prog["objective"]), len(ref.objective_harmony))
    o_p, o_r = np.asarray(prog["objective"][:n]), np.asarray(ref.objective_harmony[:n])
    return {
        "objective_rel": float(np.max(np.abs(o_p - o_r) / np.abs(o_r))),
        "iterations": float(abs(prog["iterations"] - ref.iterations)),
        "R_abs": gap(prog["R"], R_r),
        "Zcorr_rel": gap(prog["Z_corr"], Z_r) / float(Z_r.abs().max()),
        "Y_abs": gap(prog["Y"], ref.Y),
    }


def verdict(numbers: Dict[str, Dict[str, float]], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over every checked job's numbers
    that the cell has a limit for (``REQUIRED`` and any others of
    ``NUMBERS``); a required limit missing, or a number that is not finite,
    fails."""
    rows, ok = [], True
    for job, nums in numbers.items():
        for k in [k for k in NUMBERS if k in REQUIRED or k in limits]:
            v, lim = nums[k], limits.get(k)
            good = lim is not None and np.isfinite(v) and v <= lim
            ok = ok and good
            rows.append((f"{job}.{k}", v, lim))
    return ok, rows
