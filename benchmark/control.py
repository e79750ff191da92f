"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed one precision below the one the
configuration states (float32 with TF32 products for float32), held to
the float64 reference by the same numbers (``check.compare``). The
limits sit below what it reads, so a program that computed so would fail.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--cells N]

prints one JSON line a seed: the control's compared numbers and the
cell's limits. It runs on the card at the cell's size (``--cells`` cuts
the cell count, for the test); the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(cell, seed: int, device, dtype=None, tf32: bool = True) -> dict:
    """The compared numbers of the control against the float64 reference,
    on the window's first job of a run with ``seed``."""
    import torch

    from benchmark import check, data, prepare
    from benchmark.reference import harmony as ref
    from benchmark.reference import ingest

    dtype = torch.float32 if dtype is None else dtype
    conf, traffic = cell.config, cell.traffic
    Z, labels = data.make(conf, seed, device)
    N, d = Z.shape
    st = ref.settings(prepare.settings(conf), N, traffic["shuffle_mode"])
    geo = ingest.geometry(labels.cpu().numpy(), N, d, st.K, int(conf["batches"]), st.shuffle,
                          st.block_size, seed)
    js = prepare.job_seed(seed, 0)
    B = int(conf["batches"])
    good = ref.integrate(Z, labels, B, st, geo, js)
    low = ref.integrate(Z, labels, B, st, geo, js, dtype=dtype, tf32=tf32)
    out = {"objective": low.objective_harmony, "iterations": low.iterations, "Y": low.Y,
           "R": low.R, "Z_corr": low.Z_corr}
    return check.compare(out, good)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cells", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import manifest

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    if args.cells:
        cell = cell._replace(config=dict(cell.config, cells=args.cells))
    for s in args.seeds.split(","):
        nums = control_numbers(cell, int(s), "cuda:0")
        print(json.dumps({"workload": cell.name, "seed": int(s), "control": nums,
                          "limits": cell.limits,
                          "fails": [k for k, v in nums.items()
                                    if not (v <= cell.limits.get(k, float("inf")))]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
