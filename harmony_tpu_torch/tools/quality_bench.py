"""Record the port's quality metrics: the counterpart of the repository's
``tools/quality_bench.py`` (which runs the JAX package and wrote
``QUALITY.json``), with the same sections and JSON keys:

* ``parity``: Z_corr's max-abs error and the objective trajectory's largest
  relative delta against the float64 oracle on the four vendored fixtures
  (``tests/fixtures/parity/``), their centroids and permutations injected.
* ``converge``: iterations to converge, the k-means rounds, the objective
  trace and the end-to-end wall (a first and a second call) of
  ``run_harmony`` at the reference's defaults on ``cell_lines`` and
  ``pbmc_stim`` (``datasets.pbmc_dataset``).
* ``e2e``: the end-to-end wall of one ``run_harmony`` call (ingest, init,
  every round, the run-end R, the host copy of the result) on the bench's
  synthetic cells: 500,000 x 50, K = 100, B = 10 in float32, and
  10,000,000 x 50 in 100 batches in bf16 unless ``--skip-10m``.

Usage (from the root of a checkout)::

    python -m harmony_tpu_torch.tools.quality_bench --out q.json \\
        [--sections parity,converge,e2e] [--skip-10m] [--device cpu]

Each section replaces its key in ``--out`` (other keys are kept) with its
``meta`` entry: the device it ran on and the section's wall. It runs on the
card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "parity")


def platform(device) -> dict:
    """The device a section ran on."""
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "device": torch.cuda.get_device_name(device),
                "n_devices": torch.cuda.device_count()}
    return {"platform": device.type, "device": str(device), "n_devices": 1}


def _commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, check=False).stdout.strip()
    except OSError:
        return "unknown"
    return out or "unknown"


def parity_fixture(path: str, device) -> dict:
    """One fixture through the engine on ``device``: its centroids and
    permutations injected, as tests/test_torch_parity.py replays it."""
    from harmony_tpu_torch import driver, engine
    from harmony_tpu_torch.config import finalize_engine_config, harmony_options
    from harmony_tpu_torch.preprocess import DesignMatrix, resolve_config
    from harmony_tpu_torch.state import init_state

    with np.load(path, allow_pickle=False) as f:
        z = {k: f[k] for k in f.files}
    codes = z["codes"]
    ncov, N = codes.shape
    design = DesignMatrix(codes=codes.astype(np.int32),
                          levels=[np.arange(len(np.unique(codes[c]))) for c in range(ncov)],
                          names=[str(v) for v in z["vars_use"]])
    cfg = finalize_engine_config(resolve_config(
        n_cells=N, d=z["Z"].shape[0], design=design, nclust=int(z["nclust"]),
        max_iter=int(z["max_iter"]), early_stop=True,
        options=harmony_options(max_iter_cluster=int(z["max_iter_cluster"])), verbose=False))
    state = init_state(cfg, z["Z"], design, z["sigma"], z["theta"], z["lamb"], 0, device)
    state = engine.init_cluster_from(cfg, state, z["Y0"])
    state = driver.harmonize(cfg, state, max_iter=int(z["max_iter"]), perms=z["perms"])
    Zc = state.Z_corr.double().cpu().numpy()
    tr = np.asarray(state.trace_lists(cfg)["objective_kmeans"], np.float64)
    oracle = z["oracle_objective_kmeans"]
    n = min(len(tr), len(oracle))
    return {
        "n_cells": int(N),
        "max_abs_err_vs_oracle": float(np.abs(Zc - z["oracle_Z_corr"]).max()),
        "objective_max_rel_delta_vs_oracle": float(
            np.abs((tr[:n] - oracle[:n]) / oracle[:n]).max()),
    }


def section_parity(device, names=None) -> dict:
    """Every fixture (or those of ``names``) against its float64 oracle."""
    out = {}
    for name in sorted(os.listdir(FIXDIR)):
        if name.endswith(".npz") and (names is None or name[:-4] in names):
            out[name[:-4]] = parity_fixture(os.path.join(FIXDIR, name), device)
    return out


def section_converge(device) -> dict:
    """Iterations to converge and the end-to-end wall at the reference's
    defaults on the bundled datasets."""
    from harmony_tpu_torch import run_harmony
    from harmony_tpu_torch.datasets import cell_lines, pbmc_dataset

    out = {}
    for loader in (cell_lines, pbmc_dataset):
        ds = loader()
        vars_use = ["dataset"] if ds.name == "cell_lines" else list(ds.meta_data)[:1]
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = run_harmony(ds.scaled_pcs.astype(np.float32), ds.meta_data, vars_use,
                              return_object=True, device=device)
            _ = res.embeddings  # the host copy closes the end-to-end window
            walls.append(time.perf_counter() - t0)
        out[ds.name] = {
            "n_cells": int(ds.n_cells),
            "vars_use": vars_use,
            "iters_to_converge": int(res.state.n_rounds),
            "kmeans_rounds": [int(v) for v in res.kmeans_rounds],
            "wall_s_end_to_end": round(walls[0], 3),
            "wall_s_end_to_end_warm": round(walls[1], 3),
            "objective_harmony": [round(float(v), 6) for v in res.objective_harmony],
            "reference_wall_claim": ("~4 seconds on an unspecified desktop CPU "
                                     "(the reference's README)"
                                     if ds.name == "cell_lines" else None),
        }
    return out


def e2e_one(n_cells: int, d: int, n_batches: int, dtype: str, device, repeats: int = 2
            ) -> dict:
    """``repeats`` end-to-end ``run_harmony`` calls on the bench's cells."""
    import torch

    from harmony_tpu_torch import run_harmony
    from harmony_tpu_torch.bench import make_synthetic_cells

    Z, batches = make_synthetic_cells(n_cells, d, n_batches, seed=0)
    walls, info = [], {}
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = run_harmony(Z, {"dataset": batches}, ["dataset"], nclust=100, dtype=dtype,
                          return_object=True, device=device)
        _ = res.embeddings
        walls.append(time.perf_counter() - t0)
        info = {
            "iters_run": int(res.state.n_rounds),
            "phase_seconds": {k: round(v, 3) for k, v in res.phase_seconds().items()},
            "config": {"estep_impl": res.config.estep_impl,
                       "shuffle_mode": res.config.shuffle_mode,
                       "virtual_r": bool(res.config.virtual_r),
                       "matmul_precision": res.config.matmul_precision},
        }
        del res  # two live states at 10M would double the peak
        if device.type == "cuda":
            torch.cuda.empty_cache()
    warm = min(walls[1:]) if len(walls) > 1 else None
    return {
        "n_cells": n_cells, "d": d, "n_batches": n_batches, "dtype": dtype,
        "wall_s": round(walls[0], 3),
        "wall_s_all": [round(w, 3) for w in walls],
        "wall_s_warm": None if warm is None else round(warm, 3),
        "wall_s_warm_per_iter": (None if warm is None
                                 else round(warm / max(info["iters_run"], 1), 4)),
        **info,
    }


def section_e2e(device, skip_10m: bool) -> dict:
    out = {"canonical_500k": e2e_one(500_000, 50, 10, "float32", device)}
    if not skip_10m:
        out["baseline_10m"] = e2e_one(10_000_000, 50, 100, "bfloat16", device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", default="parity,converge,e2e")
    ap.add_argument("--skip-10m", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="a torch device such as 'cpu' (default: the card)")
    args = ap.parse_args(argv)

    from harmony_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    doc = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            doc = json.load(fh)
    doc.setdefault("meta", {})
    for s in [s.strip() for s in args.sections.split(",") if s.strip()]:
        t0 = time.perf_counter()
        if s == "parity":
            doc["parity"] = section_parity(device)
        elif s == "converge":
            doc["converge"] = section_converge(device)
        elif s == "e2e":
            doc["e2e"] = section_e2e(device, args.skip_10m)
        else:
            raise SystemExit(f"unknown section {s!r}")
        doc["meta"][s] = {"commit": _commit(),
                          "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                          "section_wall_s": round(time.perf_counter() - t0, 1),
                          **platform(device)}
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"[quality_bench] wrote section {s!r} -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
