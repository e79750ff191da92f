"""One rank of a multi-process Harmony run, and a dry run of N ranks.

Counterpart of ``tools/multihost_worker.py`` and of
``__graft_entry__.dryrun_multichip``. Every rank builds the same synthetic
problem from a seed (``bench.make_synthetic_cells``), joins the
``torch.distributed`` group at ``tcp://localhost:PORT`` and runs Harmony
on its shard of the cells; it prints one JSON line with the replicated
objective traces, its kernel launches, the collectives an iteration and
its timings.

One rank (start one per rank; ``--device cpu --backend gloo`` on the CPU):

    python -m harmony_tpu_torch.multihost_worker --rank 0 --world-size 2 \\
        --port 29500 --backend gloo --device cpu [--cells 4096]

Modes:

* default: ``run_harmony(..., mesh=)`` on the cells, as a user calls it
  (``--dtype`` its dtype); with ``--no-stats-carry`` or ``--mstep-mode``,
  options ``run_harmony`` has no argument for, the same steps through the
  config and the driver (:func:`driver_result`). Rank 0 also reports the
  batch separation before and after, the largest deviation of R's column
  sums from 1, and with ``--out`` writes the embeddings there (``.npz``).
  ``--bench-pairs P`` then times full rounds with
  ``bench.run_bench(mesh=)`` on the same cells (P pairs; its
  ``seconds_per_iter``, warm-up excluded). It also times an all-reduce of
  16 kB on the group (``allreduce_16k_ms``).
* ``--inject MODE[,MODE]`` (rotate, virtual, rotate_rounds, permute,
  permute_rounds, rotate_cell, segment, virtual_bf16; ``INJECT_MODES``):
  the driver with injected centroids and randomness on a batch-tiled
  order, once per ``--variants`` entry (``kernel``: the kernels,
  ``torch``: the plain path, ``materialised``: the kernels without virtual
  R), every rank drawing every shard's schedule (or the global
  permutations and cell-granular schedules) from one numpy generator and
  taking its own; rank 0 writes each run's gathered Z_corr and traces to
  ``--out``.
* ``--dryrun N``: start N ranks of this module on one sharded Harmony run
  at tiny shapes (gloo; ``--device``, default the card, ``--device cpu``
  on the CPU), each with a time limit, and check that they finish, agree bit for bit on their traces and
  centroids, and give finite values; prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

# the kernels' wrappers by the names the records use (K1-K12; LL the
# k-means init's Lloyd round)
_WRAPPERS = (
    ("K1", "cuda_estep", "block_update_round"), ("K2", "cuda_permute", "permute_rounds"),
    ("K3", "cuda_permute", "materialize"), ("K4", "cuda_ridge", "moments"),
    ("K5", "cuda_ridge", "correction"), ("K6", "cuda_rotate", "reassign"),
    ("K7", "cuda_rotate", "rotate_update_round_v2"), ("K8", "cuda_ridge", "tile_moments"),
    ("K9", "cuda_ridge", "tiled_correction"), ("K10", "cuda_rotate", "virtual_correction"),
    ("K11", "cuda_rotate", "materialize_r"), ("K12", "cuda_estep", "rotate_update_round_v1"),
    ("LL", "kmeans", "_lloyd_round"),
)
INJECT_MODES = ("rotate", "virtual", "rotate_rounds", "permute", "permute_rounds",
                "rotate_cell", "segment", "virtual_bf16")
# each injected mode's config changes; the rest of the problem is shared
_INJECT_CHANGES = {
    "rotate": {}, "virtual": {}, "rotate_rounds": {"max_iter_cluster": 6},
    "permute": {"shuffle_mode": "permute", "permute_fused": True},
    "permute_rounds": {"shuffle_mode": "permute", "max_iter_cluster": 6},
    "rotate_cell": {"rotate_stats_carry": False}, "segment": {"mstep_mode": "segment"},
    "virtual_bf16": {"dtype": "bfloat16"},
}


def launch_counts() -> dict:
    """Each kernel's launches so far (its wrapper's ``launches``)."""
    from . import ops

    return {k: getattr(getattr(ops, mod), fn).launches for k, mod, fn in _WRAPPERS}


def reset_launch_counts() -> None:
    from . import ops

    for _, mod, fn in _WRAPPERS:
        getattr(getattr(ops, mod), fn).launches = 0


def free_port() -> int:
    """A free TCP port of localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def separation(emb: np.ndarray, batches: np.ndarray) -> float:
    """Mean distance between the batch centroids of the L2-normalised
    cells (N, d): how far apart the batches sit."""
    E = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    cents = np.stack([E[batches == b].mean(0) for b in np.unique(batches)])
    return float(np.mean([np.linalg.norm(a - c) for i, a in enumerate(cents)
                          for c in cents[i + 1:]]))


def _peak_mib(device) -> float:
    import torch

    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**20


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def allreduce_ms(mesh, n: int = 4096, reps: int = 50) -> float:
    """Wall milliseconds of one all-reduce of ``n`` float32 values on the
    mesh's device (after five unmeasured ones), the host waiting for each."""
    import torch

    from . import sharding

    t = torch.ones(n, device=mesh.device)
    for _ in range(5):
        sharding.all_reduce_sum(t, mesh)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        sharding.all_reduce_sum(t, mesh)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) / reps * 1e3


def driver_result(Z, meta: dict, mesh, nclust, max_iter: int, seed: int, shuffle_mode: str,
                  options, early_stop: bool = True, device=None, Y0=None, **change):
    """What ``run_harmony(Z, meta, list(meta), ..., mesh=)`` computes, for
    config fields it has no argument for (``change``: ``rotate_stats_carry``,
    ``mstep_mode``, ``estep_variant``, any other field, and its own
    ``dtype``, ``estep_impl``, ``mstep_impl``, ``virtual_r``), through its
    steps: the config padded and finalised for the mesh, the ingest order,
    the M-step layout, the streamed state and the driver (``Y0`` injects
    the initial centroids); ``mesh`` None runs on ``device`` (None: the
    card). Returns the ``api.HarmonyResult``."""
    from .api import (HarmonyResult, _resolve_shuffle_mode, apply_ingest_order, ingest_perm)
    from .config import finalize_engine_config
    from .driver import run
    from .engine import mstep_layout
    from .preprocess import build_design, expand_hyperparams, orient_embedding, resolve_config
    from .runtime import AsyncIngest, PhaseTimers, resolve_device
    from .sharding import pad_for_mesh
    from .state import init_state

    design = build_design(meta, list(meta))
    n = design.n_cells
    dev = resolve_device(device) if mesh is None else mesh.device
    Zt = orient_embedding(Z, n)
    cfg = resolve_config(
        n_cells=n, d=Zt.shape[0], design=design, nclust=nclust, max_iter=max_iter,
        early_stop=early_stop, options=options, verbose=False, lambda_estimation=True,
        ridge_solver="auto", shuffle_mode=_resolve_shuffle_mode(shuffle_mode, n, False, False),
        dtype=change.pop("dtype", "float32"))
    if mesh is not None:
        cfg = pad_for_mesh(cfg, mesh)
    cfg = finalize_engine_config(dataclasses.replace(cfg, **change), mesh)
    timers = PhaseTimers(dev)
    with timers.scope("ingest_order"):
        perm, _ = ingest_perm(cfg, design, seed)
        _, design, inv = apply_ingest_order(design, perm)
        layout = mstep_layout(cfg, design.codes, dev, mesh)
    hp = expand_hyperparams(design, cfg.K, None, 0.1, None, options.tau)
    with timers.scope("ingest"):
        Zd = AsyncIngest(Zt, cfg, dev, mesh=mesh).result(perm)
        state = init_state(cfg, Zd, design, hp.sigma, hp.theta, hp.lamb, seed, dev, timers,
                           mesh)
    state = run(cfg, state, timers=timers, layout=layout, Y0=Y0, mesh=mesh)
    return HarmonyResult(config=cfg, state=state, design=design, timers=timers,
                         ingest_inv=inv, mesh=mesh)


def _run(args, mesh) -> dict:
    """run_harmony on the synthetic cells, as a user calls it, or through
    :func:`driver_result` for ``--no-stats-carry`` and ``--mstep-mode``."""
    import torch

    from . import sharding
    from .api import run_harmony
    from .bench import make_synthetic_cells
    from .config import harmony_options
    from .state import host_numpy

    Z, batches = make_synthetic_cells(args.cells, args.dims, args.batches, seed=args.seed)
    meta = {"dataset": batches.astype(str)}
    options = harmony_options(block_size=args.block_size,
                              max_iter_cluster=args.max_iter_cluster)
    reset_launch_counts()
    sharding.reset_counters()
    _reset_peak(mesh.device)
    t0 = time.perf_counter()
    if args.no_stats_carry or args.mstep_mode != "auto":
        res = driver_result(Z, meta, mesh, args.nclust, args.max_iter, args.seed,
                            args.shuffle, options, not args.no_early_stop,
                            rotate_stats_carry=not args.no_stats_carry,
                            mstep_mode=args.mstep_mode, dtype=args.dtype,
                            estep_impl=args.impl, mstep_impl=args.impl,
                            virtual_r=args.virtual or None)
    else:
        res = run_harmony(Z, meta, ["dataset"], nclust=args.nclust, max_iter=args.max_iter,
                          seed=args.seed, shuffle_mode=args.shuffle, options=options,
                          estep_impl=args.impl, mstep_impl=args.impl,
                          virtual_r=args.virtual or None, early_stop=not args.no_early_stop,
                          dtype=args.dtype, mesh=mesh, return_object=True)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    coll = sharding.counters()
    ph = res.phase_seconds()
    n_it = int(res.state.n_rounds)
    out = {
        "objective_harmony": res.objective_harmony.tolist(),
        "objective_kmeans": res.objective_kmeans.tolist(),
        "n_iter": n_it, "wall_s": wall,
        "seconds_per_iter": (ph["run_rounds"] if "run_rounds" in ph else
                             ph.get("cluster", 0.0) + ph.get("correct", 0.0)) / max(n_it, 1),
        "phase_seconds": ph, "launches": launches, "collectives": coll,
        "allreduce_16k_ms": allreduce_ms(mesh),
        "peak_mib": _peak_mib(mesh.device),
        "config": {"N": res.config.N, "Np": res.config.Np, "T": res.config.estep_sub_tile,
                   "K": res.config.K, "route": res.config.rotate_route,
                   "permute_fused": res.config.permute_fused,
                   "virtual": res.state.virt_pen is not None, "dtype": res.config.dtype,
                   "mstep": _mstep_kind(res, mesh)},
    }
    # every rank reads the gathered arrays (collectives), rank 0 reports
    emb = res.embeddings
    R = res.R
    if mesh.rank == 0:
        out.update(
            separation_in=separation(Z, batches), separation_out=separation(emb, batches),
            finite=bool(np.isfinite(emb).all()), shape=list(emb.shape),
            r_colsum_err=float(np.max(np.abs(R.sum(axis=0) - 1.0))),
        )
        if args.out:
            np.savez(args.out, embeddings=emb, Y=host_numpy(res.state.Y))
    if args.bench_pairs:
        from .bench import run_bench

        os.environ["HARMONY_BENCH_PAIRS"] = str(args.bench_pairs)
        out["bench"] = run_bench(n_cells=args.cells, d=args.dims, n_batches=args.batches,
                                 nclust=args.nclust, seed=args.seed, shuffle_mode=args.shuffle,
                                 virtual_r=args.virtual or None, estep_impl=args.impl,
                                 dtype=args.dtype, mesh=mesh)
    return out


def _mstep_kind(res, mesh) -> str:
    """The M-step layout the run took: tiled, segment or dense."""
    from .engine import mstep_layout

    lay = mstep_layout(res.config, res.design.codes, mesh.device, mesh)
    return "tiled" if lay.tiled is not None else "segment" if lay.segments else "dense"


def inject_problem(mode: str, cells: int, dims: int, batches: int, nclust: int,
                   rounds: int, seed: int):
    """The host side of an injected run: the config before its
    implementation knobs, the design and (d, N) cells in a batch-tiled
    order at tile 128, the hyperparameters and the initial centroids."""
    from .bench import make_synthetic_cells
    from .config import harmony_options
    from .ops.tiled import build_batch_tiled_order
    from .preprocess import build_design, expand_hyperparams, orient_embedding, resolve_config

    Z, b = make_synthetic_cells(cells, dims, batches, seed=seed)
    design = build_design({"batch": b.astype(str)}, ["batch"])
    change = dict(_INJECT_CHANGES[mode])
    base = resolve_config(
        n_cells=cells, d=dims, design=design, nclust=nclust, max_iter=rounds,
        early_stop=False, options=harmony_options(
            max_iter_cluster=change.pop("max_iter_cluster", 4)),
        verbose=False, lambda_estimation=True, ridge_solver="auto",
        shuffle_mode=change.pop("shuffle_mode", "rotate"),
    )
    base = dataclasses.replace(base, mstep_tile=128, **change)
    perm, _ = build_batch_tiled_order(design.codes, 128, 0)
    design = dataclasses.replace(design, codes=design.codes[:, perm])
    Zt = orient_embedding(Z, cells)[:, perm]
    hp = expand_hyperparams(design, base.K, None, 0.1, None, 0.0)
    rng = np.random.default_rng(seed + 1)
    Y0 = Zt[:, rng.choice(cells, base.K, replace=False)]
    return base, design, Zt, hp, Y0


def inject_draws(cfg, mesh_size: int, rank: int, rounds: int, seed: int):
    """The injected randomness of every shard from one numpy generator,
    this rank's taken: per round, the schedule table of max_iter_cluster
    (rotation, block order) rows over the shard's tiles, or the global
    permutations, or the global table of (cell rotation, block order) rows
    of the cell-granular round."""
    from .ops import rotate

    rng = np.random.default_rng(seed + 2)
    if cfg.shuffle_mode == "permute":
        return {"perms": np.stack([np.stack([rng.permutation(cfg.N)
                                             for _ in range(cfg.max_iter_cluster)])
                                   for _ in range(rounds)])}
    if cfg.rotate_route == "cell":
        return {"schedules": [rotate.schedule_table(
            [(int(rng.integers(cfg.Np)), rng.permutation(cfg.n_blocks).tolist())
             for _ in range(cfg.max_iter_cluster)]) for _ in range(rounds)]}
    NT = cfg.Np // mesh_size // cfg.estep_sub_tile
    nb = len(rotate.block_sizes(cfg, NT)[0])
    every = [[[(int(rng.integers(NT)), rng.permutation(nb).tolist())
               for _ in range(mesh_size)] for _ in range(cfg.max_iter_cluster)]
             for _ in range(rounds)]
    return {"schedules": [rotate.schedule_table([r[rank] for r in rnd]) for rnd in every]}


def _inject(args, mesh) -> dict:
    """The injected runs of each --inject mode and --variants entry."""
    import torch

    from . import driver, engine, sharding
    from .config import finalize_engine_config
    from .state import host_numpy, init_state

    out, saved = {}, {}
    for mode in args.inject.split(","):
        base, design, Zt, hp, Y0 = inject_problem(mode, args.cells, args.dims, args.batches,
                                                  args.nclust, args.max_iter, args.seed)
        for variant in args.variants.split(","):
            if variant == "materialised" and mode != "virtual":
                continue
            impl = "torch" if variant == "torch" else "kernel"
            virtual = mode.startswith("virtual") and variant == "kernel"
            cfg = dataclasses.replace(base, estep_impl=impl, mstep_impl=impl, virtual_r=virtual)
            cfg = finalize_engine_config(sharding.pad_for_mesh(cfg, mesh), mesh)
            layout = engine.mstep_layout(cfg, design.codes, mesh.device, mesh)
            draws = inject_draws(cfg, mesh.size, mesh.rank, args.max_iter, args.seed)
            st = init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, args.seed,
                            mesh.device, mesh=mesh)
            reset_launch_counts()
            sharding.reset_counters()
            _reset_peak(mesh.device)
            t0 = time.perf_counter()
            st = driver.run(cfg, st, Y0=Y0, layout=layout, mesh=mesh, **draws)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            key = f"{mode}/{variant}"
            tr = st.trace_lists(cfg)
            out[key] = {"objective_kmeans": tr["objective_kmeans"].tolist(),
                        "objective_harmony": tr["objective_harmony"].tolist(),
                        "kmeans_rounds": tr["kmeans_rounds"].tolist(),
                        "seconds": time.perf_counter() - t0, "launches": launch_counts(),
                        "collectives": sharding.counters(),
                        "peak_mib": _peak_mib(mesh.device),
                        "virtual": st.virt_pen is not None,
                        "tiled": layout.tiled is not None,
                        "segments": layout.segments is not None, "route": cfg.rotate_route}
            Zc = sharding.gather_cells(st.Z_corr, mesh)
            if mesh.rank == 0:
                saved[key.replace("/", "__")] = host_numpy(Zc)[:, : cfg.N]
            del st, Zc
    if mesh.rank == 0 and args.out:
        np.savez(args.out, **saved)
    return out


def _rank_main(args) -> int:
    import torch

    from . import sharding

    if args.device == "cpu" or (args.device is None and not torch.cuda.is_available()):
        torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.initialize_distributed(
        backend=args.backend, init_method=f"tcp://localhost:{args.port}",
        world_size=args.world_size, rank=args.rank, timeout=args.timeout)
    mesh = sharding.make_mesh(args.device)
    body = _inject(args, mesh) if args.inject else _run(args, mesh)
    line = {"rank": mesh.rank, "world_size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), **body}
    print(json.dumps(line), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(argvs, timeout: float, env=None, cwd=None):
    """Start one process per command line in ``argvs``, wait for all of
    them up to ``timeout`` seconds in total, kill every one of them on
    expiry, and return their (returncode, stdout, stderr); a process
    killed at the limit gets returncode None."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=cwd) for a in argvs]
    deadline = time.monotonic() + timeout
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, so, se))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            so, se = p.communicate()
            out.append((None, so, se))
    return out


def spawn(n: int, extra, timeout: float, env=None, cwd=None):
    """Start ``n`` ranks of this module with the arguments ``extra`` (and
    --rank/--world-size/--port) and wait for them (:func:`run_ranks`)."""
    port = free_port()
    return run_ranks([[sys.executable, "-m", "harmony_tpu_torch.multihost_worker", "--rank",
                       str(r), "--world-size", str(n), "--port", str(port), *extra]
                      for r in range(n)], timeout, env, cwd)


def json_line(stdout: str) -> dict:
    """The JSON line a rank printed last."""
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])


def dryrun(n: int, device=None, timeout: float = 120.0) -> dict:
    """One sharded Harmony run on ``n`` gloo ranks at tiny shapes (4,096
    cells a rank in three batches, four blocks of eight 128-cell tiles
    each: the stats-carrying rotate route with the batch-tiled M-step,
    whose mixture gate wants two tiles of each batch in a block): every
    rank must finish
    within ``timeout`` seconds with finite values, and the ranks' traces
    must agree bit for bit. ``device`` None means each rank's card, and
    raises without one. Raises ``RuntimeError`` otherwise."""
    from .runtime import resolve_device

    resolve_device(device)
    where = [] if device is None else ["--device", str(device)]
    extra = ["--backend", "gloo", *where, "--cells", str(4096 * n), "--dims", "8",
             "--batches", "3", "--nclust", "5", "--max-iter", "2", "--shuffle", "rotate",
             "--block-size", "0.25"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = spawn(n, extra, timeout, cwd=root)
    bad = [(r, rc, se[-2000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
    if bad:
        raise RuntimeError(f"dryrun: ranks failed or timed out: {bad}")
    lines = [json_line(so) for _, so, _ in res]
    first = lines[0]
    for ln in lines[1:]:
        if ln["objective_harmony"] != first["objective_harmony"]:
            raise RuntimeError("dryrun: the ranks' objective traces differ")
    if not (first["finite"] and np.isfinite(first["objective_harmony"]).all()):
        raise RuntimeError("dryrun: non-finite output")
    return {"dryrun": n, "ok": True, "N": first["config"]["N"], "Np": first["config"]["Np"],
            "objective_harmony": first["objective_harmony"], "shape": first["shape"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="start N gloo ranks on a tiny sharded run and check them")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: each rank's card)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait (init_process_group's timeout)")
    ap.add_argument("--threads", type=int, default=1, help="torch threads of a CPU rank")
    ap.add_argument("--cells", type=int, default=4096)
    ap.add_argument("--dims", type=int, default=8)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--nclust", type=int, default=8)
    ap.add_argument("--max-iter", type=int, default=3)
    ap.add_argument("--max-iter-cluster", type=int, default=4)
    ap.add_argument("--block-size", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shuffle", choices=["rotate", "permute", "auto"], default="rotate")
    ap.add_argument("--impl", choices=["auto", "kernel", "torch"], default="auto")
    ap.add_argument("--virtual", action="store_true")
    ap.add_argument("--dtype", choices=["float32", "bfloat16", "float16"], default="float32")
    ap.add_argument("--no-stats-carry", action="store_true",
                    help="rotate_stats_carry=False (on a mesh the cell-granular round)")
    ap.add_argument("--mstep-mode", choices=["auto", "tiled", "dense", "segment"],
                    default="auto")
    ap.add_argument("--no-early-stop", action="store_true")
    ap.add_argument("--bench-pairs", type=int, default=0,
                    help="then time rounds with bench.run_bench(mesh=), this many pairs")
    ap.add_argument("--inject", default="", help=f"comma-separated of {INJECT_MODES}")
    ap.add_argument("--variants", default="kernel,torch")
    ap.add_argument("--out", default="", help="rank 0 writes its arrays here (.npz)")
    args = ap.parse_args(argv)
    if args.dryrun:
        print(json.dumps(dryrun(args.dryrun, args.device, min(args.timeout, 120.0))),
              flush=True)
        return 0
    return _rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
