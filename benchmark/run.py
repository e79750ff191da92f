"""The port's benchmark: whole Harmony integrations on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run: the cell's embedding is made on the card from the seed
(``data.py``); ``run_harmony``'s steps up to the rounds are run through
the port's library functions (``prepare.py``); one whole integration
warms up every shape (it captures the iteration's graph). That is the
set-up (``setup_s``). Then the window: a closed loop of integrations,
one after another as one analyst or pipeline runs them, each
``state.init_state`` and ``driver.run`` from a seed of its own, for
``--seconds``. With ``--trace 0`` it reports the cell's end-to-end
metrics. With ``--trace 1`` the first jobs run under ``torch.profiler``,
then, once its trace is read, ``--seconds`` of jobs under the port's
phase timers, and it reports the per-layer metrics (``metrics/``): the
timers' from the jobs after the profiled ones, which the profiler
slows. After the window the last job, and the columns of a job drawn
from the seed, are compared with the plain reference (``check.py``), and
the run prints each compared number beside its limit, on standard error
and as the result's last key.

The last line of standard output is one JSON object. The run exits 2
without a result where there is no card (or fewer than the cell asks
for), 3 where the port or anything of JAX is loaded or missing.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# what must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "harmony_tpu")
# warm-up integrations before the window: one captures the graph; after
# it the window's first job reads within the spread of the window's job
# walls, and a second warm-up would move no metric by 0.1% (H100)
WARMUP_JOBS = 1
# the cells of the job drawn from the seed that are compared
CHECK_COLUMNS = 1024


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``harmony_tpu_torch`` is not ``harmony_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})


def _job_index(seed: int, expected: int) -> int:
    import numpy as np

    return int(np.random.default_rng([int(seed) % 2**63, 1]).integers(0, max(1, expected)))


def _sample_columns(seed: int, N: int, n: int, device):
    import numpy as np
    import torch

    cols = np.random.default_rng([int(seed) % 2**63, 2]).choice(N, size=min(n, N),
                                                                replace=False)
    return torch.as_tensor(np.sort(cols), device=device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             engine_overrides=None, t0: float = None, fault=None) -> dict:
    """One run of ``cell`` (a ``manifest.Cell``) on ``device``: the result's
    object. ``engine_overrides`` (tests only) sets HarmonyConfig fields,
    ``fault`` (tests only) wraps the job, to break the timed path."""
    import torch

    from benchmark import check, data, prepare
    from benchmark.context import Context, Job
    from benchmark.manifest import readers
    from benchmark.reference import harmony as ref
    from benchmark.reference import ingest
    from harmony_tpu_torch import engine
    from harmony_tpu_torch.runtime import PhaseTimers

    t0 = _T0 if t0 is None else t0
    dev = torch.device(device)
    conf, traffic = cell.config, cell.traffic
    over = engine_overrides or {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = prepare.job if fault is None else fault(prepare.job)

    # ---- set-up -----------------------------------------------------------
    parts = {"imports_s": time.perf_counter() - t0}
    tp = time.perf_counter()
    torch.zeros(1, device=dev)
    prepare.synchronize(dev)
    parts["device_init_s"] = time.perf_counter() - tp
    tp = time.perf_counter()
    Z, labels = data.make(conf, seed, dev)
    prepare.synchronize(dev)
    parts["data_s"] = time.perf_counter() - tp
    tp = time.perf_counter()
    p = prepare.prepare(conf, traffic, Z, labels, seed, over)
    del Z, labels
    cfg = p.cfg
    parts["prepare_s"] = time.perf_counter() - tp
    tw = time.perf_counter()
    for j in range(-WARMUP_JOBS, 0):
        state = job(p, prepare.job_seed(seed, j))
    del state
    parts["warmup_s"] = time.perf_counter() - tw
    warm_s = parts["warmup_s"] / WARMUP_JOBS
    prepare.synchronize(dev)
    setup_s = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- window -----------------------------------------------------------
    sampled = _job_index(seed, int(0.5 * seconds / max(warm_s, 1e-3)))
    cols = _sample_columns(seed, cfg.N, CHECK_COLUMNS, dev)
    profiled_n = max(1, math.ceil(float(traffic.get("profiled_cells", 0)) / cfg.N)) \
        if trace else 0
    walls, jobs, kept = [], [], None
    slice_, profiled = None, []
    state = None
    t_start = time.perf_counter()

    def one(j, timed=True):
        nonlocal state, kept
        state = None
        timers = PhaseTimers(dev) if trace and timed else None
        a = time.perf_counter()
        state = job(p, prepare.job_seed(seed, j), timers)
        walls.append((a, time.perf_counter()))
        it = prepare.iterations(state)
        if trace and timed:
            ph = timers.as_dict()
            jobs.append(Job(iterations=it, init_s=ph.get("init_cluster", 0.0),
                            run_rounds_s=ph.get("run_rounds", 0.0)))
        if j == sampled:
            kept = (j, check.program_outputs(state, cfg.N, cols))
        return it

    j, trace_s = 0, None
    if trace:
        from benchmark import trace as tr

        profiled, slice_ = tr.profile(lambda: [one(i, False) for i in range(profiled_n)])
        j = profiled_n
        trace_s = time.perf_counter() - t_start
        # the timed jobs get the whole window after the trace has been read
        t_start = time.perf_counter()
    while j == profiled_n or walls[-1][1] - t_start < seconds:
        one(j)
        j += 1
    t_end = walls[-1][1]
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_jobs = len(walls)

    # ---- the check --------------------------------------------------------
    last = (n_jobs - 1, check.program_outputs(state, cfg.N))
    state = None
    engine.clear_graphs()
    if cuda:
        torch.cuda.empty_cache()
    Z, labels = data.make(conf, seed, dev)
    st = ref.settings(prepare.settings(conf), cfg.N, traffic["shuffle_mode"])
    B = int(conf["batches"])
    geo = ingest.geometry(labels.cpu().numpy(), cfg.N, cfg.d, st.K, B, st.shuffle,
                          st.block_size, seed, permute_fused=over.get("permute_fused"))
    numbers = {}
    tc = time.perf_counter()
    for name, (jj, out), c in [("last", last, None)] + ([("sampled", kept, cols)] if kept else []):
        r = ref.integrate(Z, labels, B, st, geo, prepare.job_seed(seed, jj))
        numbers[name] = check.compare(out, r, c)
        del r
    check_s = time.perf_counter() - tc
    correct, rows = check.verdict(numbers, cell.limits)

    # ---- metrics ----------------------------------------------------------
    res = {"correct": bool(correct), "attempted": n_jobs, "failed": 0}
    durs = sorted(b - a for a, b in walls)
    if not trace:
        values = {
            "integrate_s": (t_end - t_start) / n_jobs,
            "integrate_p95_s": (statistics.quantiles(durs, n=20, method="inclusive")[-1]
                                if len(durs) > 1 else durs[0]),
            "peak_mem_gib": window_peak / 2**30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        ctx = Context(cfg=cfg, layout=p.layout, jobs=jobs, profiled=profiled, slice=slice_)
        fns = readers(cell.per_layer)
        metrics = {}
        for m in cell.per_layer:
            v = fns[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    res["metrics"] = metrics
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if trace and slice_ is not None:
        from benchmark import trace as tr

        dev_info["busy_s"] = tr.busy_seconds(slice_)
        dev_info["window_s"] = tr.window_seconds(slice_)
        res["breakdown"] = {"device_ops": tr.top_device_ops(slice_),
                            "idle_gaps": tr.idle_gaps(slice_)}
    res["device"] = dev_info
    res["run"] = {"jobs": n_jobs, "sampled_job": kept[0] if kept else None,
                  "profiled_jobs": len(profiled), "setup_parts": parts,
                  "first_job_s": walls[0][1] - walls[0][0],
                  "job_s_min_median_max": [durs[0], statistics.median(durs), durs[-1]],
                  "check_s": check_s, "iterations_last": last[1]["iterations"]}
    if trace and slice_ is not None and profiled:
        # a profiled job's wall against one of the jobs the timers read
        timed = [b - a for a, b in walls[len(profiled):]]
        res["run"]["trace_s"] = trace_s
        res["run"]["slice_s_per_job"] = dev_info["window_s"] / len(profiled)
        res["run"]["timed_job_s"] = sum(timed) / len(timed)
    res["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import harmony_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port does not import: {e}", file=sys.stderr)
        return 3
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"correct: {res['correct']}", file=sys.stderr)
    for k, v in res["check"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
