"""Multi-device scaling of the port: the counterpart of the repository's
``tools/scaling_bench.py`` (which runs the JAX package).

One program, ``bench.run_bench`` on the same cells, on a mesh of 1 rank
and on a mesh of N ranks (``torch.distributed``, one process a rank, this
module started once a rank), each leg's rank 0 printing its payload; then
the throughput of each leg and the scaling efficiency,
N-rank cells/s over (1-rank cells/s x N). The 1-rank leg takes the sharded
code path too (``mesh=1``), so the two legs run one program, as the JAX
tool's legs do (tools/scaling_bench.py:64-98).

Usage (from the root of a checkout)::

    python -m harmony_tpu_torch.tools.scaling_bench --ranks 2 \\
        [--cells 2000000] [--dims 50] [--batches 10] [--nclust 100] \\
        [--shuffle rotate|permute] [--backend nccl|gloo] [--device cpu]

Ranks take one card each (``cuda:rank % device_count``); more ranks than
cards need ``--backend gloo`` (NCCL takes one rank a card), and then
measure what sharing a card costs, not what the mesh gains. ``--device
cpu`` runs the ranks on the CPU. It prints JSON lines: one a leg
(``devices``, ``cells_per_sec_total``, ``seconds_per_iter``), then the
efficiency (``multi_device_scaling_efficiency``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(args) -> int:
    """One rank of a leg: run_bench on the leg's mesh; rank 0 prints."""
    from harmony_tpu_torch import sharding
    from harmony_tpu_torch.bench import run_bench

    sharding.initialize_distributed(args.backend, f"tcp://localhost:{args.port}",
                                    args.world, args.rank_id, timeout=args.timeout)
    r = run_bench(n_cells=args.cells, d=args.dims, n_batches=args.batches,
                  nclust=args.nclust, max_iter=args.max_iter, mesh=args.world,
                  shuffle_mode=args.shuffle, device=args.device)
    if args.rank_id == 0:
        print(json.dumps(r), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def leg(args, world: int) -> dict:
    """The run_bench payload of a mesh of ``world`` ranks."""
    from harmony_tpu_torch.multihost_worker import free_port, json_line, run_ranks

    port = free_port()
    base = [sys.executable, "-m", "harmony_tpu_torch.tools.scaling_bench", "--port", str(port),
            "--world", str(world), "--cells", str(args.cells), "--dims", str(args.dims),
            "--batches", str(args.batches), "--nclust", str(args.nclust),
            "--max-iter", str(args.max_iter), "--shuffle", args.shuffle,
            "--backend", args.backend, "--timeout", str(args.timeout)]
    if args.device:
        base += ["--device", args.device]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    res = run_ranks([base + ["--rank-id", str(r)] for r in range(world)], args.timeout,
                    env=env, cwd=REPO)
    bad = [(r, rc, se[-2000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
    if bad:
        raise RuntimeError(f"scaling_bench: ranks of the {world}-rank leg failed: {bad}")
    return json_line(res[0][1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2, help="ranks of the N-rank leg")
    ap.add_argument("--cells", type=int, default=2_000_000)
    ap.add_argument("--dims", type=int, default=50)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--nclust", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=2, help="timed rounds a pair")
    ap.add_argument("--shuffle", choices=["rotate", "permute"], default="rotate")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: nccl with a card a rank, else gloo")
    ap.add_argument("--device", default=None, help="'cpu' runs the ranks on the CPU")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds a leg may take")
    # a rank of a leg (started by the legs, not by hand)
    ap.add_argument("--rank-id", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_id is not None:
        return _rank(args)
    if args.backend is None:
        import torch

        cards = torch.cuda.device_count() if args.device is None else 0
        args.backend = "nccl" if args.ranks <= cards else "gloo"
    results = {}
    for world in sorted({1, args.ranks}):
        r = leg(args, world)
        results[world] = {"devices": r["n_devices"],
                          "cells_per_sec_total": r["value"] * r["n_devices"],
                          "seconds_per_iter": r["seconds_per_iter"],
                          "platform": r["platform"]}
        print(json.dumps(results[world]), flush=True)
    if len(results) > 1:
        base, top = results[1], results[args.ranks]
        eff = top["cells_per_sec_total"] / (base["cells_per_sec_total"] * top["devices"])
        print(json.dumps({"metric": "multi_device_scaling_efficiency", "value": round(eff, 4),
                          "from_devices": base["devices"], "to_devices": top["devices"],
                          "backend": args.backend}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
