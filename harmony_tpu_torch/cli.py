"""Command-line interface of the port: Harmony on saved matrices, on the card.

Usage:
    harmony-torch run --embeddings emb.npy --meta meta.csv --vars dataset \\
        --out corrected.npy [--nclust 50] [--theta 2] [--max-iter 10] \\
        [--checkpoint run.npz] [--device cpu]
    harmony-torch bench [--cells 100000] [--dims 50] [--batches 10]

Multi-device, one process a device under torchrun:
    torchrun --nproc_per_node=N -m harmony_tpu_torch.cli run --mesh auto ...

Counterpart of ``harmony_tpu/cli.py`` (``harmony-tpu``), with the same
flags plus ``--device`` (default: the card; without one the command
fails) and ``--backend``. The embeddings file may be ``.npy`` (cells x
dims) or ``.csv``; metadata is a CSV with a header naming the covariates.
``run`` resumes from ``--checkpoint`` when that file exists. ``--mesh
auto`` shards the cells over the ranks torchrun started (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` from the
environment) on ``--backend`` (nccl, one rank a card; gloo for several
ranks on one card or ``--device cpu``); every rank reads the inputs, and
rank 0 alone writes ``--out`` and prints the bench payload.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np


def _load_matrix(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    return np.loadtxt(path, delimiter=",", skiprows=1)


def _load_meta(path: str):
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = list(reader)
    return {h: np.array([r[i] for r in rows]) for i, h in enumerate(header)}


def _mesh(args):
    """The mesh of ``--mesh``: None without it or in a one-process run;
    with it the default ``torch.distributed`` group from torchrun's
    environment on ``--backend`` (initialised here), one rank a device. An
    integer (bench) is the mesh size, which must be the world size."""
    if args.mesh is None:
        return None
    from .sharding import initialize_distributed, make_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh != "auto" and int(args.mesh) != world:
        raise SystemExit(f"--mesh {args.mesh}: the mesh size must be the number of ranks "
                         f"torchrun started (WORLD_SIZE={world})")
    if world <= 1 and args.mesh == "auto":
        return None
    initialize_distributed(backend=args.backend)
    return make_mesh(args.device)


def _is_writer(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _resume_run(args, Z, meta, mesh=None) -> np.ndarray:
    """Continue a run from ``--checkpoint`` for up to ``--max-iter`` more
    rounds, with the usual early stop. A minimal checkpoint needs the
    original embedding and design, which the command has at hand; where the
    run reordered its cells at ingest, the order is rebuilt from the
    checkpoint's provenance ({shuffle_mode, seed, tiled_tile}) and undone
    on the result. Flags that would change the checkpointed config are
    ignored, with a warning. ``--mesh`` is honoured: the checkpoint's
    arrays are taken apart over the ranks again (harmony_tpu/cli.py:60-135);
    a checkpoint of a mesh run resumed without one says so."""
    from .api import HarmonyResult, apply_ingest_order, order_from_recipe
    from .checkpoint import load_checkpoint, read_checkpoint_meta
    from .driver import harmonize
    from .engine import mstep_layout
    from .preprocess import build_design, orient_embedding
    from .runtime import PhaseTimers, resolve_device

    dev = resolve_device(args.device) if mesh is None else mesh.device
    design = build_design(meta, args.vars.split(","))
    Zd = orient_embedding(Z, design.n_cells, verbose=args.verbose)
    ckpt_meta = read_checkpoint_meta(args.checkpoint)
    orig_mesh_size = int(ckpt_meta.get("mesh_size", 0))
    if mesh is None and orig_mesh_size > 1:
        print(f"note: this checkpoint came from a {orig_mesh_size}-rank mesh run; resuming "
              "on one device (run under torchrun with --mesh auto to resume sharded)",
              file=sys.stderr)
    perm = order_from_recipe(design, ckpt_meta.get("shuffle_mode"),
                             int(ckpt_meta.get("seed", 0)), int(ckpt_meta.get("tiled_tile", 0)))
    Zd, design, ingest_inv = apply_ingest_order(design, perm, Zd)
    cfg, state = load_checkpoint(args.checkpoint, Z=Zd, design=design,
                                 extra_rounds=args.max_iter, device=dev, mesh=mesh)
    if mesh is not None:
        ckpt_meta = {**ckpt_meta, "mesh_size": mesh.size}
    ignored = [
        name for name, val, default in (
            ("--nclust", args.nclust, None),
            ("--theta", args.theta, None),
            ("--lamb", args.lamb, None),
            ("--seed", args.seed, 0),
            ("--shuffle-mode", args.shuffle_mode, "auto"),
            ("--dtype", args.dtype, None),
            ("--estep-impl", args.estep_impl, "auto"),
            ("--virtual-r", args.virtual_r, "auto"),
        ) if val != default
    ]
    if ignored and _is_writer(mesh):
        print(
            f"warning: resuming from {args.checkpoint}; ignoring "
            f"{', '.join(ignored)} (hyperparameters come from the "
            "checkpointed config). --max-iter counts ADDITIONAL rounds.",
            file=sys.stderr,
        )
    timers = PhaseTimers(dev)
    layout = mstep_layout(cfg, design.codes, dev, mesh)
    state = harmonize(cfg, state, max_iter=args.max_iter, verbose=args.verbose, timers=timers,
                      layout=layout, checkpoint_path=args.checkpoint,
                      checkpoint_meta=ckpt_meta, mesh=mesh)
    return HarmonyResult(config=cfg, state=state, design=design, timers=timers,
                         ingest_inv=ingest_inv, mesh=mesh).embeddings


def _cmd_run(args) -> int:
    from .api import run_harmony
    from .config import harmony_options

    Z = _load_matrix(args.embeddings)
    meta = _load_meta(args.meta)
    mesh = _mesh(args)
    t0 = time.perf_counter()
    if args.checkpoint:
        from .checkpoint import normalize_checkpoint_path

        args.checkpoint = normalize_checkpoint_path(args.checkpoint)
    if args.checkpoint and os.path.exists(args.checkpoint):
        if _is_writer(mesh):
            print(f"resuming from checkpoint {args.checkpoint}")
        out = _resume_run(args, Z, meta, mesh)
    else:
        theta = None
        if args.theta is not None:
            theta = [float(t) for t in args.theta.split(",")]
            if len(theta) == 1:
                theta = theta[0]
        out = run_harmony(
            Z, meta, args.vars.split(","), theta=theta, nclust=args.nclust, lamb=args.lamb,
            max_iter=args.max_iter, seed=args.seed, verbose=args.verbose,
            shuffle_mode=args.shuffle_mode, mesh=mesh, options=harmony_options(),
            checkpoint_path=args.checkpoint, dtype=args.dtype or "float32",
            estep_impl=args.estep_impl,
            virtual_r=None if args.virtual_r == "auto" else args.virtual_r == "on",
            device=args.device,
        )
    dt = time.perf_counter() - t0
    out = np.asarray(out)
    if _is_writer(mesh):
        np.save(args.out, out)
        print(f"wrote {args.out}  shape={out.shape}  ({dt:.2f}s)")
    return 0


def _cmd_bench(args) -> int:
    from .bench import run_bench

    mesh = _mesh(args)
    result = run_bench(
        n_cells=args.cells, d=args.dims, n_batches=args.batches, nclust=args.nclust,
        max_iter=args.max_iter, seed=args.seed, shuffle_mode=args.shuffle_mode,
        dtype=args.dtype, mesh=mesh, estep_impl=args.estep_impl, budget_s=args.budget,
        device=args.device,
    )
    if _is_writer(mesh):
        print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="harmony-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run Harmony on saved matrices")
    pr.add_argument("--embeddings", required=True)
    pr.add_argument("--meta", required=True)
    pr.add_argument("--vars", required=True, help="comma-separated covariates")
    pr.add_argument("--out", required=True)
    pr.add_argument("--nclust", type=int, default=None)
    pr.add_argument("--theta", default=None)
    pr.add_argument("--lamb", type=float, default=None)
    pr.add_argument("--max-iter", type=int, default=10)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument(
        "--shuffle-mode", choices=["auto", "permute", "rotate"], default="auto",
        help="'permute' = reference-exact schedule; 'rotate' = the schedule "
        "for large runs; 'auto' (default) picks permute below 100k cells, "
        "rotate above",
    )
    pr.add_argument("--mesh", choices=["auto"], default=None,
                    help="shard the cells over the ranks torchrun started (one process "
                    "a device)")
    pr.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="torch.distributed backend of --mesh (default nccl, one rank a "
                    "card; gloo for several ranks on one card or on the CPU)")
    pr.add_argument("--dtype", default=None,
                    choices=["float32", "float64", "bfloat16", "float16"],
                    help="engine dtype: float32 (default), float64, bfloat16 or float16")
    pr.add_argument("--estep-impl", choices=["auto", "kernel", "torch"], default="auto",
                    dest="estep_impl",
                    help="'kernel' = the CUDA kernels, 'torch' = plain PyTorch, "
                    "'auto' (default) = the kernels for float32, bfloat16 and float16")
    pr.add_argument(
        "--virtual-r", choices=["auto", "on", "off"], default="auto", dest="virtual_r",
        help="never write the (K, N) assignment matrix during rounds ('auto' "
        "resolves by dtype: on for bfloat16 and float16, off for float32)",
    )
    pr.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="write a crash-recovery checkpoint every round ('.npz' is "
        "appended if missing); if PATH already exists, resume from it — "
        "hyperparameter flags are then ignored (the checkpointed config "
        "wins) and --max-iter counts ADDITIONAL rounds",
    )
    pr.add_argument("--device", default=None,
                    help="torch device (default: the card; e.g. 'cpu')")
    pr.add_argument("--verbose", action="store_true")
    pr.set_defaults(fn=_cmd_run)

    pb = sub.add_parser("bench", help="synthetic benchmark")
    pb.add_argument("--cells", type=int, default=100_000)
    pb.add_argument("--dims", type=int, default=50)
    pb.add_argument("--batches", type=int, default=10)
    pb.add_argument("--nclust", type=int, default=100)
    pb.add_argument("--max-iter", type=int, default=2)
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--shuffle-mode", choices=["permute", "rotate"], default="rotate",
                    help="schedule to benchmark (default: rotate, the large-run "
                    "schedule; permute = reference-exact)")
    pb.add_argument("--dtype", default=None,
                    choices=["float32", "float64", "bfloat16", "float16"],
                    help="engine dtype (e.g. bfloat16 or float16)")
    pb.add_argument("--mesh", default=None, metavar="auto|N",
                    help="shard the cells over the ranks torchrun started: 'auto', or "
                    "the mesh size N (the number of ranks)")
    pb.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="torch.distributed backend of --mesh")
    pb.add_argument("--estep-impl", choices=["auto", "kernel", "torch"], default="auto",
                    dest="estep_impl")
    pb.add_argument("--budget", type=float, default=None, metavar="SECONDS",
                    help="measurement wall-clock budget")
    pb.add_argument("--device", default=None,
                    help="torch device (default: the card; e.g. 'cpu')")
    pb.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
