#!/usr/bin/env python3
"""On-card smoke test of harmony_tpu_torch.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # every phase, one card

Phases (``--phases`` picks a subset, comma-separated):

1. env       the card's name and power limit, torch/CUDA versions; TF32 off.
2. build     nvcc builds every kernel from harmony_tpu_torch/csrc.
3. kernels   K1, K2 (its head, the phase's distances, too), K3 (reading
             the head's distances, with and without the fused moments; its R
             bit-equal with and without them and over two launches), K4 and K5 (through the per-tile
             batch index, at random and batch-sorted codes, 60k cells,
             300 batches, a ragged N with an absent batch and K = 300;
             two launches bit-equal), K6 (its Gram table too; two launches
             bit-equal; its assign and reduce launches timed apart),
             K7 (with and without writing R, and a phase's last round with
             the fused moments and the penalty tables; g from K6's Gram
             table), K8, K9, K10, K11
             and K12 against their plain PyTorch versions on the card, at the main
             paths' shapes and at one ragged shape (K7's last round, K10
             and K11 also at K = d = 100; K1, K2, K3, K6 and K7 also at
             the segment paths' 40 batches, K2 and K3 also at 400
             batches and at K = 300); K11's R against the R K7 wrote in the
             same round, K10 (reading K6's Gram table) against K9 on that
             R; K9 and K10 twice bit-equal, K9 also on rows that are not a
             multiple of 4 cells, with one staged slice of R (K = 400) and
             past 256 dims; the correction's route without G and past
             K10's limits (K = 300, d = 300), K11 then K9, equal to K10;
             K11 with the centroids staged and read from device memory;
             K10 with one correction group (B = 100); K10's time beside
             K11 then K9 on its R, the path it fuses; K7, K10 and K11 in
             the legacy op order too, at the main shape (timed) and the
             shapes above; K7's last round and K10 on 160-cell layout tiles
             (T = 2560) at 200k x 50 (timed, the "160-cell tile" form,
             K7's launches profiled by kernel), a ragged and a wide shape
             and the legacy order; a profile of K7's last round at T = 2560
             on 160- and 256-cell tiles at 200k and 500k (probe_k7_tiles); K11's R equal to K7's and K10 equal to K9 on
             it (1e-6; 0.0 expected); kernel, plain and
             library-call times (K1's and K2's a phase of rounds, per
             round: K1's with its scatter back to the cells' order, K2's
             with its head), the device time and achieved bytes a second
             of K2's and K7's cell passes, and the least time the card
             could take. Each main path also prints its peak device memory.
3b. lloyd    the k-means init's Lloyd round (ops/kmeans.py _lloyd_round,
             csrc/kmeans.cu) against its plain version on the synthetic
             cells (unit columns, K = 100 cells as centroids) at 500,000
             and 10,000,000 x 50: ms a round, launches, the bound, the
             plain version's ms, the largest gap in Y (LLOYD_GAP); two
             rounds bit-equal; ten rounds chained as kmeans_centers runs
             them. Every path below launches LL_RUN Lloyd kernels a k-means
             init (each rank's on the mesh; none in the graph cells' rounds).
4. traj      20k-cell runs with injected centroids and randomness, once
             through the kernels and once through the plain path: the
             per-round permute schedule and the fused permute phase
             (injected permutations), the rotate schedule (injected
             rotations and block orders), the rotate schedule with
             virtual R, also against the kernels' materialised run, and the
             rotate schedule without the stats carry (K12), and 2,000
             cells on the cell-granular rotate round (injected schedule
             tables; K4, K5); then
             run_harmony on 2,000 cells with shuffle_mode="rotate", which
             takes the cell-granular round through run_rounds and a
             capture: no K6, K7 or K12.
5. permute   run_harmony on 500,000 x 50 cells, 10 batches, K = 100, the
             permute schedule, which at this size runs the fused phase on
             the batch-tiled ingest order; K2, K3 and K9 must be launched,
             K1 and K8 must not.
6. permute_rounds  the same call with max_iter_cluster = 6, a round count
             the fused phase does not take: K1, K4 and K5 must be launched;
             it prints the size of the run's K4/K5 cell index and profiles
             one round.
7. main      run_harmony on the same cells with shuffle_mode left at its
             default, which resolves to the rotate schedule; K6, K7 (its
             last round fusing the M-step's moments) and K9 must be
             launched, K8 must not.
8. virtual   the same call with virtual_r=True: K6, K7, K10 (once per
             iteration) and K11 (once) must be launched, K8 and K9 must not.
             Then the driver on 200,000 x 50 cells, K = 100, B = 10 with a
             user-set mstep_tile=160 and estep_sub_tile=2560: layout tiles
             that are not whole 64-cell pieces. First the reference:
             written R with the fused moments dropped before each
             correction, so K8 sums M from the written R (K6, K7, K8, K9);
             then written R (K6, K7 with its moments split at tile
             boundaries, K9 masking a tile's partial slice; no K8), then
             virtual R (K6, K7, K10 once an iteration, K11 once; no K8 or
             K9); both objective traces are held to the reference's (rtol
             1e-4), the virtual one also to the written one's.
9. rotate_rounds  the default call with max_iter_cluster = 6, a round
             count past the static budget: every round writes R and the
             M-step takes K8: K6, K7, K8 and K9 must be launched.
10. rotate_two_phase  the same cells through the config and the driver
             (resolve_config, rotate_stats_carry=False, finalize_engine_config,
             the batch-tiled ingest order, init_state, driver.run): every
             round reads the old statistics from R and writes R: K12, K8
             and K9 must be launched, K6, K7, K10 and K11 must not; the
             objective trace is held to main's (rtol 1e-4).
11. legacy   the same cells through the config and the driver with
             estep_variant="legacy" on the stats-carrying route, R written
             (K6, K7, K9; no K8, K10, K11 or K12) and virtual (K6, K7, K10
             once per iteration, K11 once; no K8, K9 or K12); the
             objective traces held to main's and virtual's (rtol 1e-4),
             and the virtual one to the written one (rtol 1e-5).
11b. graph   the one-dispatch run (engine.run_rounds, a captured
             iteration replayed an iteration; the re-entry and the rounds
             a window test may skip as guarded regions) in GRAPH_CELLS: the
             main cells (rotate, virtual, bf16, float16, fused permute),
             the per-round routes at 500k (K1 and the carry route at
             max_iter_cluster=10, a phase of one stopping early; K12), K1
             at 50k with one and three covariates (Cholesky's solve),
             pbmc_stim and 80k x 40 batches (segmented M-step), and two
             covariates on the carry route. Each cell's host loop, its
             run_rounds and abort_poll_rounds=1 bit-equal with the host
             loop's launch counts; a cached call runs no iteration eagerly
             and reads the host once; its times, launch calls, idle share
             and peak in $CHIP_SMOKE_OUT/graph.json.
11c. stamps  (in the graph phase's rotate-500k cell, or alone without
             it) the captured iteration's device stamps on the rotate-500k
             graph route, one cached run_rounds call under torch.profiler
             (check_stamps): each iteration's stamped cluster + correct
             against its kernels' interval in the profiler's trace, the
             stamps monotone, K9's launches counted in the replays against
             the trace's, and the global timer's granularity;
             $CHIP_SMOKE_OUT/stamps.json.
12. segment  run_harmony on 200,000 x 50 cells in 40 batches (seed 7,
             shuffle_mode left at its default, so rotate): no batch-tiled
             layout exists at this N and B, so the M-step takes the
             segmented layout (plain PyTorch): K6 and K7 must be launched,
             K4, K5, K8, K9, K10 and K11 must not; then the same at 80,000
             cells, which resolves to the per-round permute schedule: K1
             must be launched, K4 and K5 must not.
13. bf16     run_harmony(..., dtype="bfloat16") on the main shape's cells,
             nothing cut: rotate, the stats carry, virtual R; the bf16
             forms of K6 and K10 once an iteration, K7, K11 once, no K8 or
             K9 (K6, K10 and K11 in the bf16 product form the resolved
             'bfloat16' precision selects); R stored in bf16, its column
             sums within 1e-2 of 1, the
             separation shrinks; its seconds per iteration and peak device
             memory beside the float32 virtual path's. Then the same cells
             from shared initial centroids, early stop off, five
             iterations, in bf16 and float32 (virtual R both): Z_corr
             (relative Frobenius) within 2e-2, the objective entries from
             the first correction on within 2e-2 of the trace's scale and
             the last within 2e-2 of itself (the two before it cancel near
             0 and carry bf16's renormalisation; logged, held_to). Then each
             other route of a bf16 engine (the float32 kernels on float32
             copies) at 20,000 cells through the driver, held to its
             float32 run the same way: per-round permute (K1), the forced
             fused permute phase (K2, K3), rotate writing R (K6, K7),
             without the stats carry (K12), and the cell-granular round at
             2,000 cells (its objective at 5e-2, BF16_CELL_OBJ_RTOL). The kernels phase checks the bf16 forms against
             their float32 forms on the upcast inputs (0.0 required),
             their plain versions and two launches bit-equal, at the main
             shape (timed) and the shapes of K7's last round above, in
             both op orders (fp32 products: their configs keep the
             'float32' precision).
13b. f16     the float16 storage forms of K6, K7, K10 and K11 (fp32
             products) as the kernels phase checks the bf16 ones (0.0
             against the float32 forms on the upcast inputs; timed at the
             main shape), also on 160-cell layout tiles; then the bf16
             product forms of K6, K10 and K11 for bf16 and float16 storage
             (check_products: G within 1e-5 of the product on its own
             operands, K11's R equal to K7's bit for bit, K10's Z_corr the
             rounding of a value within 1e-5 of its twin's), at the main
             shape (timed beside the fp32-product forms), in both op
             orders, on 160-cell tiles and at the ragged, wide, one-group,
             past-K10 and VIRTUAL_WIDE shapes; then run_harmony(...,
             dtype="float16") on the main shape's cells as phase bf16 runs
             its engine (K6 and K10 once an iteration, K7, K11 once, no K8
             or K9; R's column sums within 1e-2 of 1), held to the same
             float32 virtual run at BF16_HELD_RTOL, its peak memory
             printed.
14. bf16_10m (opt-in: named in --phases, not run by default) the bf16 path
             at BASELINE's shape, 10,000,000 x 50 cells, 100 batches, K =
             100: wall, phase seconds (the ingest streamed, the copy
             overlapping the ingest order), seconds per iteration, peak
             device memory; then the float32 engine (virtual R) on the
             same cells beside it, and the bf16 call with
             stream_ingest=False (one iteration, the copy finished before
             the ingest order), logged only.
15. host     the host modules around the engine on the main shape's cells
             (check_host): the harmony-torch CLI on .npy/.csv files against
             run_harmony with the same arguments (<= 1e-6), a checkpointed
             two-round run resumed for one round against three rounds
             without early stop (5e-4), K6, K7 and K9 launched by the CLI;
             stream_ingest=True (the copy overlapped) against False
             (Z_orig bit-equal and equal to the caller's cells, Z_corr
             equal, the ingest's parts timed both ways), the bf16 cast of
             the stream bit-equal to the card's; an abort from a
             thread after round 1 of a checkpointing run (KeyboardInterrupt,
             then the checkpoint resumes); a trace of one round with the
             cluster and correct spans ($CHIP_SMOKE_OUT/trace_host/);
             run_bench at rotate, permute and rotate-virtual-bf16 (payload
             and peak memory); cell_lines() through run_harmony (the
             batch-centroid separation shrinks).
16. mesh     the cells sharded over torch.distributed ranks, each a process
             of harmony_tpu_torch.multihost_worker loading the kernels this
             process built (check_mesh): K6-K11 on the shards of 2 gloo
             ranks against the plain route at 20,000 cells (injected
             centroids and schedules; rotate R written, virtual R, the
             unfused M-step, the permute phase; the traj bounds), and at
             500,000 cells for rotate, virtual R and permute; then
             run_harmony(mesh=) on 500,000 x 50 cells on 2 gloo ranks of
             the one card, nothing cut: mesh_main (K6, K7, K9), mesh_virtual
             (K6, K7, K10, K11) and mesh_permute (the plain sharded phase,
             K8, K9), and the other MESH_PATHS (bf16 and float16 virtual R
             among them), each held to one device's run on the same cells (final
             objective within 5%, separation shrinking, R's columns within
             1e-4 of 1, the ranks' traces equal), with seconds an iteration
             (run_bench on both), all-reduces an iteration and their bytes,
             and each rank's peak memory; then mesh_main on a 1-rank NCCL
             group against one device (objective rtol 1e-5). A rank that
             fails fails the phase. Launches are summed over the ranks.
17. harness  the port's benchmark harnesses (check_harness): python -m
             harmony_tpu_torch.bench at 500,000 x 50, K = 100, B = 10,
             rotate, with a 60 s budget, whose one JSON line must carry the
             JAX payload's keys; a second run, on 20,000 cells, sent
             SIGTERM after its warm-up, which must print exactly one line; the quality tool's
             parity section (the four fixtures against their float64
             oracle, Z_corr within 1e-4, the JAX engine's band logged) and
             converge section (cell_lines and pbmc_stim at the reference's
             defaults); then the sharded checkpoint (check_sharded_
             checkpoint): a 500k virtual-R state saved and loaded on the
             card, bit for bit, timed, and one round from it. Its results
             go to $CHIP_SMOKE_OUT/harness.json.

It prints a JSON line of the kernels' numbers, the card's name and power
limit, and last {"ok": true, "device": {...}}. Any failed check exits 1.
A machine without a GPU, or a directory without the package (the script
copied alone), exits 2 and prints no result: the script runs on the card,
from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
import types

PHASES = ("env", "build", "kernels", "lloyd", "traj", "permute", "permute_rounds", "main", "virtual",
          "graph", "stamps", "rotate_rounds", "rotate_two_phase", "legacy", "segment", "bf16",
          "f16", "host", "mesh", "harness")
# phases run only when named in --phases: the bf16 engine at BASELINE's
# shape, on one card and on the mesh
OPT_IN_PHASES = ("bf16_10m", "mesh_bf16_10m")
# the payload keys of the JAX package's bench (harmony_tpu/bench.py:242-275,
# with the root harness's baseline), which python -m harmony_tpu_torch.bench
# must print
JAX_PAYLOAD_KEYS = ("metric", "value", "unit", "n_cells", "d", "K", "n_batches",
                    "seconds_per_iter", "first_iter_with_compile_s", "n_devices", "platform",
                    "estep_impl", "mstep", "shuffle_mode", "dtype", "vs_baseline")
# the harness phase: the harness's wall-clock budget, and the Z_corr bound
# of the parity fixtures against their float64 oracle (tests/test_parity_
# fixtures.py) beside the JAX engine's band on them (QUALITY.json's parity
# section, up to 1.13e-6)
HARNESS_BUDGET_S, PARITY_ATOL, JAX_PARITY_BAND = 60, 1e-4, 1.13e-6
# BASELINE's north-star shape (BASELINE.json): 10M cells x 50, 100 batches,
# K = 100 (default_nclust), bf16
N_10M, B_10M = 10_000_000, 100
MAIN_PATHS = ("permute", "permute_rounds", "main", "virtual", "rotate_rounds",
              "rotate_two_phase")
# the legacy phase: the driver with the legacy op order, R written and virtual
LEGACY_PATHS = ("legacy", "legacy_virtual")
# the segment phase: (path, cells, schedule its default resolves to)
SEGMENT_PATHS = (("segment", 200_000, "rotate"), ("segment_permute", 80_000, "permute"))
B_SEGMENT = 40
# the mesh phase: two gloo ranks on the one card (NCCL takes one rank a
# device)
MESH_RANKS = 2
# seconds a spawned rank may take (each call of a rank set; the 10M run's)
MESH_RANK_TIMEOUT = 300.0
MESH_10M_TIMEOUT = 1500.0
# pairs of run_bench's timed rounds on each mesh path and its one-device run
MESH_BENCH_PAIRS = 3

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores. The bound of a function is the larger of its bytes over the
# first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# bf16 on the tensor cores, dense (NVIDIA data sheet): the peak of the bf16
# product forms' operations (K6's, K10's and K11's under a reduced-precision
# engine's 'bfloat16' precision)
BF16_TC_FLOP_PER_S = 989e12

# main-path shape: the repo's canonical 500k x 50, K = 100, B = 10
N_MAIN, D_MAIN, K_MAIN, B_MAIN = 500_000, 50, 100, 10
MAX_ITER = 10  # run_harmony's default; early stop is on
LL_RUN = 20  # Lloyd kernel launches a k-means init: 10 rounds of 2
# the mesh phase's full-width paths: each one's cells (the bench generator,
# seed 0, K = 100), batches and settings, and what it must resolve to
# (route, fused permute phase, virtual R, M-step layout); run_bench takes
# the paths whose settings it has ("bench")
_MESH_ROTATE = dict(cells=N_MAIN, batches=B_MAIN, shuffle="rotate", mic=None, carry=True,
                    dtype="float32", virtual=False, bench=True,
                    want=("carry", False, False, "tiled"))
MESH_PATHS = {
    "mesh_main": _MESH_ROTATE,
    "mesh_virtual": {**_MESH_ROTATE, "virtual": True, "want": ("carry", False, True, "tiled")},
    "mesh_permute": {**_MESH_ROTATE, "shuffle": "permute",
                     "want": ("None", True, False, "tiled")},
    "mesh_permute_rounds": {**_MESH_ROTATE, "shuffle": "permute", "mic": 6, "bench": False,
                            "want": ("None", False, False, "dense")},
    "mesh_rotate_cell": {**_MESH_ROTATE, "carry": False, "bench": False,
                         "want": ("cell", False, False, "dense")},
    "mesh_virtual_bf16": {**_MESH_ROTATE, "virtual": True, "dtype": "bfloat16",
                          "want": ("carry", False, True, "tiled")},
    "mesh_virtual_f16": {**_MESH_ROTATE, "virtual": True, "dtype": "float16",
                         "want": ("carry", False, True, "tiled")},
    "mesh_segment": {**_MESH_ROTATE, "cells": 200_000, "batches": B_SEGMENT,
                     "want": ("carry", False, False, "segment")},
}
# layout tiles that are not whole 64-cell pieces: (E-step tile, layout
# tile) and the cells of the virtual phase's runs on them (run_driver: a
# user-set mstep_tile and estep_sub_tile)
TILE160, N_TILE160 = (2560, 160), 200_000
N_SIGTERM = 20_000  # the harness run sent SIGTERM after its warm-up
# K11 past K10's limits (N, d, K, B_vec, seed), then K9: 300 dims (one
# CTA an SM) and v_chain at eight cluster values a lane (K = 256)
VIRTUAL_WIDE = ((20_000, 300, 32, (B_MAIN,), 26), (20_000, D_MAIN, 256, (B_MAIN,), 29))
R_ATOL = 1e-5  # assignments: fp32 with another summation order
SUM_RTOL = 1e-4  # sums: max |kernel - plain| <= SUM_RTOL * max |plain|
# the kernels with reduced-precision forms (the bf16 and float16 engines'
# virtual route): 2-byte storage forms of all four, and the bf16 product
# form of K6, K10 and K11 that those engines take
REDUCED_FORMS = ("K6", "K7", "K10", "K11")
PRODUCT_FORMS = ("K6", "K10", "K11")
# a bf16 product form against its plain twin on the same operands: only the
# order of the fp32 sums differs
PRODUCT_ATOL = 1e-5
# peak device memory of each main path run, MiB
PEAKS = {}
# logs too long for the console (profile, ptxas report); a path setting
OUT_DIR = os.environ.get("CHIP_SMOKE_OUT", "chip_smoke_out")


def iter_seconds(ph: dict, n_it: int) -> float:
    """Seconds a Harmony iteration from a run's timer scopes: on the graph
    route (HarmonyConfig.graph_route) its one run_rounds scope, the
    capture included on a process's first run at a shape and the replays
    after convergence too; elsewhere cluster + correct."""
    t = (ph["run_rounds"] if "run_rounds" in ph
         else ph.get("cluster", 0.0) + ph.get("correct", 0.0))
    return t / max(n_it, 1)


# the log's copy in $CHIP_SMOKE_OUT/chip_smoke.log, once main has opened it
# (a chip run returns only the end of a command's output)
_LOG_COPY = []


def log(*a):
    print(*a, flush=True)
    for fh in _LOG_COPY:
        print(*a, file=fh, flush=True)


def bound(nbytes: float, flops: float, peak: float = FP32_FLOP_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def k7_moments_work(K, d, Np, ncov, nj, nb, B, zbytes):
    """(bytes, flops) of K7's last round with the fused moments: K6's G
    (K, Np), Z_orig (``zbytes`` a value) and the codes read once, the
    moments of nj + 1 joints and nb block tables written once; the moments'
    product 2 K (d + 1) Np (the chain's elementwise operations are not
    counted)."""
    nbytes = 4 * (K * Np + ncov * Np + (nj + 1) * K * (d + 1) + nb * K * B) + zbytes * d * Np
    return nbytes, 2.0 * K * (d + 1) * Np


def k10_work(K, d, Np, ncov, n_pure, zbytes):
    """(bytes, flops) of K10: K6's G (K, Np) and the codes read once,
    Z_orig read and Z_corr written once (``zbytes`` a value); the
    correction's product 2 K d on the cells of pure layout tiles only (a
    trash tile's output is Z_orig)."""
    return 4 * (K * Np + ncov * Np) + 2 * zbytes * d * Np, 2.0 * K * d * n_pure


def time_ms(torch, label, fn, iters: int = 10, warmup: int = 2, reps: int = 3) -> float:
    """ms per call with CUDA events after warm-up: the median of ``reps``
    repeats of ``iters`` back-to-back calls; the spread is logged."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    times.sort()
    log(f"    {label}: {times[reps // 2]:.4f} ms (median of {reps} x {iters} calls; "
        f"min {times[0]:.4f}, max {times[-1]:.4f})")
    return times[reps // 2]


class Failed(Exception):
    pass


def require(cond: bool, what: str):
    if not cond:
        raise Failed(what)


def problem(torch, N, d, K, B_vec, seed, dev):
    """Seeded E-step inputs: unit-norm Z and Y, R from the initial softmax,
    E/O from R, per-covariate codes, a permutation, sigma 0.1, theta 2."""
    from harmony_tpu_torch.config import HarmonyConfig
    from harmony_tpu_torch import ops

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    B = sum(B_vec)
    cfg = HarmonyConfig(N=N, d=d, K=K, B=B, B_vec=tuple(B_vec))
    Z = ops.l2_normalize_columns(torch.randn(d, N, generator=g, device=dev))
    Y = ops.l2_normalize_columns(Z[:, torch.randperm(N, generator=g, device=dev)[:K]]
                                 + 0.1 * torch.randn(d, K, generator=g, device=dev))
    codes = torch.stack([
        torch.randint(0, b, (N,), generator=g, device=dev, dtype=torch.int32)
        for b in B_vec
    ])
    sizes = torch.cat([torch.bincount(codes[c].long(), minlength=b)
                       for c, b in enumerate(B_vec)]).float()
    Pr_b = sizes / N
    sigma = torch.full((K,), 0.1, device=dev)
    theta = torch.full((B,), 2.0, device=dev)
    R = ops.initial_assignments(ops.compute_distances(Y, Z), sigma)
    E = ops.compute_E(R, Pr_b)
    O = ops.compute_O(R, codes, cfg.covariate_offsets, B)
    perm = torch.randperm(N, generator=g, device=dev)
    return cfg, Z, Y, R, E, O, codes, Pr_b, sigma, theta, perm


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def device_ms(torch, fn, names, calls: int = 3, tries: int = 4) -> dict:
    """Device ms per call of ``fn`` under torch.profiler, summed over the
    kernels whose name holds each of ``names`` ({name: ms}). The profiler
    now and then hands back a cycle without one of the kernels: such a
    cycle is profiled again, up to ``tries`` times, and a name still
    without device time reads None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            for n in names:
                if n in e.key:
                    out[n] += t / 1e3 / calls
        missing = [n for n in names if out[n] <= 0.0]
        if not missing:
            return out
        log(f"    torch.profiler recorded no device time for {missing} "
            f"(profile {attempt + 1} of {tries})")
    return {n: (None if n in missing else v) for n, v in out.items()}


def fmt_ms(ms) -> str:
    """A device time from ``device_ms``, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def fmt_rate(nbytes, ms) -> str:
    """``nbytes`` over a device time from ``device_ms``, in GB/s."""
    return "GB/s not measured" if ms is None else f"{nbytes / ms / 1e6:.1f} GB/s"


def check_k1(torch, dev, N, d, K, B_vec, seed, timed, rounds=4):
    """K1 against its plain version on a round as the main path runs it: R
    carried in the previous round's block order (another permutation), the
    new R in this round's. Timed, a phase as the engine runs it: ``rounds``
    rounds, the first with R in the cells' order, then the one scatter back
    to the cells' order at its end; ``ms`` is that phase per round."""
    from harmony_tpu_torch.ops import cuda_estep, estep

    args = list(problem(torch, N, d, K, B_vec, seed, dev))
    cfg, R0 = args[0], args[3]
    ks, _ = cuda_estep._stats_slice(K, cfg.B, len(B_vec), cfg.n_blocks)
    T = cuda_estep.cell_tile(K, d, cfg.B, len(B_vec), cfg.max_block_size,
                             cuda_estep._sm_count(dev))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 100)
    order = torch.randperm(N, generator=g, device=dev)
    args[3] = R0[:, order].contiguous()
    out = cuda_estep.block_update_round(*args, order=order)
    ref = estep.block_update_round(*args, order=order, carry=True)
    torch.cuda.synchronize()
    err = float((out.R - ref.R).abs().max())
    errs = {
        "R": err,
        "E": rel_err(out.E, ref.E),
        "O": rel_err(out.O, ref.O),
        "kmeans_error": rel_err(out.kmeans_error, ref.kmeans_error),
        "entropy": rel_err(out.entropy, ref.entropy),
    }
    log(f"  K1 N={N} d={d} K={K} B_vec={B_vec} ({cfg.n_blocks} blocks, {T} cells an assign "
        f"CTA, old statistics {ks} of {K} clusters a CTA): max|dR|={err:.3e} (atol {R_ATOL}); "
        + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items() if k != "R")
        + f" (rtol {SUM_RTOL}); kmeans_error {float(out.kmeans_error):.7g} vs "
        f"{float(ref.kmeans_error):.7g}, entropy {float(out.entropy):.7g} vs "
        f"{float(ref.entropy):.7g}")
    require(err <= R_ATOL, f"K1 R disagrees: {err}")
    for k, v in errs.items():
        if k != "R":
            require(v <= SUM_RTOL, f"K1 {k} disagrees: {v}")
    row = {"max_abs_err": err}
    if timed:
        perms = [args[10]] + [torch.randperm(N, generator=g, device=dev)
                              for _ in range(rounds - 1)]

        def phase():
            R, E, O, prev = R0, args[4], args[5], None
            for p in perms:
                o = cuda_estep.block_update_round(*args[:3], R, E, O, *args[6:10], p,
                                                  order=prev)
                R, E, O, prev = o.R, o.E, o.O, p
            return torch.empty_like(R).index_copy_(1, prev, R)

        row["ms_round"] = time_ms(torch, "K1 kernel round, R carried",
                                  lambda: cuda_estep.block_update_round(*args, order=order),
                                  iters=5)
        row["ms_phase"] = time_ms(torch, f"K1 kernel phase of {rounds} rounds and its scatter",
                                  phase, iters=2)
        row["ms"] = row["ms_phase"] / rounds
        log(f"    K1 a round of the phase, its scatter included: {row['ms']:.4f} ms")
        row["plain_ms"] = time_ms(
            torch, "K1 plain round",
            lambda: estep.block_update_round(*args, order=order, carry=True), iters=3)
        # one round reads Z, the old R, the codes and the two permutations
        # and writes the new R (E/O/Y are tiny); g = Y^T Z is 2*K*d*N flops
        nbytes = 4 * (d * N + 2 * K * N + len(B_vec) * N) + 16 * N
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * K * d * N)
        row["library_ms"] = None
    return row


def check_permute(torch, dev, N, d, K, B_vec, seed, timed, rounds=4, timed_phase=None):
    """K2 (its head, the phase's distances, and the phase's rounds,
    injected permutations) and K3 (R from the rounds' tables, with and
    without the fused moments) against their plain versions. The cells are
    put in a batch-tiled order first, so the moment table has pure tiles;
    K3 and its plain version get the same tables. Timed, K2's ``ms`` is a
    round of a ``rounds``-round phase, its head included (``ms_one_round``
    a phase of one round; ``timed_phase`` alone times only that)."""
    import numpy as np

    from harmony_tpu_torch.ops import cuda_permute
    from harmony_tpu_torch.ops import permute_phase as pp
    from harmony_tpu_torch.ops.ridge import full_tile_joint
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order

    cfg, Z, Y, _, E, O, codes, Pr_b, sigma, theta, _ = problem(
        torch, N, d, K, B_vec, seed, dev)
    ncov = len(B_vec)
    timed_phase = timed if timed_phase is None else timed_phase
    tile = 256 if N >= 100_000 else 128
    order, layout = build_batch_tiled_order(codes.cpu().numpy(), tile, seed)
    order = torch.as_tensor(order, device=dev)
    Z, codes = Z[:, order].contiguous(), codes[:, order].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    perms = torch.stack([torch.randperm(N, generator=g, device=dev) for _ in range(rounds)])
    Zo = 2.0 * torch.randn(d, N, generator=g, device=dev)
    nj = int(layout.joint_codes.shape[1])
    spec = pp.MomentsSpec(Z_orig=Zo, tile_joint=full_tile_joint(cfg, layout), n_joint=nj,
                          tile=tile)
    args = (cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms)
    eh = float((cuda_permute.phase_head(cfg, Z, Y) - pp.phase_head(cfg, Z, Y)).abs().max())
    out = cuda_permute.permute_rounds(*args)
    ref = pp.permute_rounds(*args)
    R3, _ = cuda_permute.materialize(cfg, Z, Y, codes, sigma, out.tables, G=out.G)
    R3m, M3 = cuda_permute.materialize(cfg, Z, Y, codes, sigma, out.tables, spec, G=out.G)
    R3b, _ = cuda_permute.materialize(cfg, Z, Y, codes, sigma, out.tables, G=out.G)
    R3mb, M3b = cuda_permute.materialize(cfg, Z, Y, codes, sigma, out.tables, spec, G=out.G)
    R_ref, M_ref = pp.materialize(cfg, Z, Y, codes, sigma, out.tables, spec, G=out.G)
    # the plain version forming the distances from Y and Z
    R_yz, _ = pp.materialize(cfg, Z, Y, codes, sigma, out.tables)
    R_twin, _ = pp.materialize(cfg, Z, Y, codes, sigma, ref.tables)
    torch.cuda.synchronize()
    # K3's R is the same bits with and without the moments and in repeats
    d3 = max(float((R3 - R3m).abs().max()), float((R3 - R3b).abs().max()),
             float((R3m - R3mb).abs().max()))
    same3 = bool(torch.equal(R3, R3m) and torch.equal(R3, R3b) and torch.equal(R3m, R3mb)
                 and torch.equal(M3, M3b))
    e_yz = float((R3 - R_yz).abs().max())
    errs2 = {f: rel_err(getattr(out, f), getattr(ref, f))
             for f in ("E", "O", "E_rounds", "O_rounds", "kmeans_error", "entropy")}
    errs2["pen"] = rel_err(out.tables.pen, ref.tables.pen)
    blk_same = bool(torch.equal(out.tables.blk.long(), ref.tables.blk.long()))
    e3 = float((R3 - R_ref).abs().max())
    e3m = float((R3m - R_ref).abs().max())
    r3m = rel_err(M3, M_ref)
    e_all = float((R3 - R_twin).abs().max())
    # K2's own error on the R its tables define: both sets of tables
    # through the plain materialisation
    e2 = float((R_ref - R_twin).abs().max())
    log(f"  K2 N={N} d={d} K={K} B_vec={B_vec}, {rounds} rounds, {cfg.n_blocks} blocks: "
        f"head max|dG|={eh:.3e} (atol {R_ATOL}); " + ", ".join(f"{k} rel {v:.3e}" for k, v in errs2.items()) + f" (rtol {SUM_RTOL}); "
        f"block ids equal: {blk_same}; R of its tables max|dR|={e2:.3e} (atol {R_ATOL})")
    log(f"  K3 same tables: max|dR|={e3:.3e}, with moments max|dR|={e3m:.3e} (atol {R_ATOL}), "
        f"M rel {r3m:.3e} (rtol {SUM_RTOL}; tile {tile}, {nj} joint levels); kernels' phase "
        f"against the plain phase: max|dR|={e_all:.3e}, against the plain version forming "
        f"the distances from Y and Z {e_yz:.3e} (atol {R_ATOL}); R with and without the "
        f"moments and over two launches, and M over two launches, bit-equal: {same3} "
        f"(max|dR| {d3:.1e}, required 0.0)")
    T3 = cuda_permute.materialize_tile(K, d, ncov, True)
    log(f"    K3: {T3} cells a step, {cuda_permute.moment_tiles(K, d)} moment tiles of "
        f"4 x 8 in {cuda_permute.moment_groups(K, d)} cell group(s), "
        f"{cuda_permute.materialize_smem_bytes(K, d, ncov, T3, True)} bytes of shared memory")
    require(eh <= R_ATOL, f"K2's head disagrees: {eh}")
    for k, v in errs2.items():
        require(v <= SUM_RTOL, f"K2 {k} disagrees: {v}")
    require(blk_same, "K2 block ids disagree")
    require(e2 <= R_ATOL, f"K2's tables give another R: {e2}")
    require(max(e3, e3m, e_all, e_yz) <= R_ATOL, f"K3 R disagrees: {e3}, {e3m}, {e_all}, {e_yz}")
    require(same3 and d3 == 0.0, f"K3's R or M is not bit-equal across moments and launches: {d3}")
    require(r3m <= SUM_RTOL, f"K3 moments disagree: {r3m}")
    require(float(R3.sum(0).sub(1).abs().max()) <= 1e-4, "K3 R columns do not sum to 1")
    k2, k3 = {"max_abs_err": max(e2, eh)}, {"max_abs_err": max(e3, e3m)}
    warps, shared = cuda_permute.cell_layout(K, cfg.B, ncov)
    log(f"    K2 cell passes: {warps} warps a CTA, "
        + ("one batch-sum table a CTA" if shared else "a batch-sum table a warp")
        + (", the chain in shared memory (K > 256)" if K > 256 else ""))
    if timed_phase:
        k2["ms_phase"] = time_ms(torch, f"K2 kernel phase of {rounds} rounds, head included",
                                 lambda: cuda_permute.permute_rounds(*args), iters=3)
        k2["ms"] = k2["ms_phase"] / rounds
        log(f"    K2 a round of the phase, its share of the head included: {k2['ms']:.4f} ms")
    if timed:
        one = (cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms[:1])
        k2["ms_one_round"] = time_ms(torch, "K2 kernel phase of one round, head included",
                                     lambda: cuda_permute.permute_rounds(*one), iters=5)
        k2["ms_head"] = time_ms(torch, "K2 head", lambda: cuda_permute.phase_head(cfg, Z, Y))
        dms = device_ms(torch, lambda: cuda_permute.permute_rounds(*args),
                        ("head_kernel", "round_cells_kernel<false", "round_cells_kernel<true",
                         "commit_kernel"))
        # each pass reads G, the permutation and the codes once; the
        # removal also reads and writes the block ids
        g_bytes = 4 * N * K + 8 * N + 4 * ncov * N
        for key, what, nbytes in (("round_cells_kernel<false", "removal", g_bytes + 8 * N),
                                  ("round_cells_kernel<true", "assign", g_bytes)):
            ms = None if dms[key] is None else dms[key] / rounds
            k2[f"device_ms_{what}"] = ms
            log(f"    K2 {what} pass: {fmt_ms(ms)} device time a round, "
                f"{fmt_rate(nbytes, ms)} ({nbytes / 1e6:.1f} MB)")
        k2["device_ms_head"] = dms["head_kernel"]
        commits = dms["commit_kernel"]
        k2["device_ms_commits"] = None if commits is None else commits / rounds
        log(f"    K2 device time: head {fmt_ms(dms['head_kernel'])} a phase, commits "
            f"{fmt_ms(k2['device_ms_commits'])} a round")
        k2["plain_ms"] = time_ms(torch, "K2 plain phase of one round", lambda: pp.permute_rounds(*one),
                                 iters=3)
        k2["library_ms"] = None
        # what ``ms`` times, a round of a ``rounds``-round phase: the phase
        # reads Z and the codes once and each round's permutation, writes
        # the block ids once (E, O, Y and the tables are tiny), and needs
        # the distances once, as Y and Z are fixed within it; a share of
        # that per round. A phase of one round (``ms_one_round``) needs all
        # of it in its one round.
        phase_bytes = 4 * (d * N + ncov * N + N) + 8 * N * rounds
        k2["bound_ms"], k2["bound_by"] = bound(phase_bytes / rounds, 2.0 * K * d * N / rounds)
        k2["bound_ms_one_round"], _ = bound(4 * (d * N + ncov * N + N) + 8 * N,
                                            2.0 * K * d * N)
        tables, G = out.tables, out.G
        k3["ms_no_moments"] = time_ms(
            torch, "K3 kernel", lambda: cuda_permute.materialize(cfg, Z, Y, codes, sigma, tables,
                                                                G=G))
        k3["ms"] = time_ms(torch, "K3 kernel with moments", lambda: cuda_permute.materialize(
            cfg, Z, Y, codes, sigma, tables, spec, G=G))
        k3["plain_ms"] = time_ms(torch, "K3 plain with moments", lambda: pp.materialize(
            cfg, Z, Y, codes, sigma, tables, spec, G=G))
        nt = -(-N // tile)
        pad = nt * tile - N
        R3m_p = torch.nn.functional.pad(R3m, (0, pad)).reshape(K, nt, tile)
        Za3 = torch.nn.functional.pad(torch.cat([Zo, torch.ones(1, N, device=dev)]),
                                      (0, pad)).reshape(d + 1, nt, tile)
        oh = torch.nn.functional.one_hot(torch.as_tensor(spec.tile_joint, device=dev).long(),
                                         nj + 1).float()
        k3["library_ms"] = time_ms(torch, "K3 moments library einsum (K8's, on K3's R)",
                                   lambda: torch.einsum("ktu,tj,dtu->jkd", R3m_p, oh, Za3))
        # does the fusion pay: K3 without moments plus the library call for them
        k3["ms_no_moments_plus_library"] = k3["ms_no_moments"] + k3["library_ms"]
        log(f"    K3 with moments {k3['ms']:.4f} ms against K3 without moments + the library "
            f"einsum {k3['ms_no_moments_plus_library']:.4f} ms")
        # Z, Z_orig, the codes and block ids read once, R and M written once
        k3["bound_ms"], k3["bound_by"] = bound(
            4 * (2 * d * N + ncov * N + N + K * N + (nj + 1) * K * (d + 1)),
            2.0 * K * d * N + 2.0 * K * (d + 1) * N)
        k3["bound_ms_no_moments"], _ = bound(4 * (d * N + ncov * N + N + K * N),
                                             2.0 * K * d * N)
    return k2, k3


def check_ridge(torch, dev, N, d, K, B, seed, timed, kind="random", absent=None):
    """K4 and K5 against their twins at SUM_RTOL, through the per-tile
    batch index the main path builds once a run (``cuda_ridge.cell_index``),
    and twice on the same input: bit-equal. ``kind``: codes drawn at random
    or sorted (a batch-contiguous order); ``absent``: a batch with no cells.
    Timed: kernel, plain and library times, achieved GB/s of the bound's
    bytes, the bound, and the index's build time."""
    from harmony_tpu_torch.ops import cuda_ridge

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    R = torch.softmax(torch.randn(K, N, generator=g, device=dev) * 3, dim=0).contiguous()
    Z = torch.randn(d, N, generator=g, device=dev) * 2
    codes = torch.randint(0, B, (N,), generator=g, device=dev, dtype=torch.int32)
    if absent is not None:
        codes[codes == absent] = (absent + 1) % B
    if kind == "sorted":
        codes = torch.sort(codes).values.contiguous()
    W = torch.randn(K, B, d, generator=g, device=dev) * 0.1
    index = cuda_ridge.cell_index(codes, B, cuda_ridge.index_tile(K, d, B))
    M = cuda_ridge.moments(R, Z, codes, B, index)
    M_ref = cuda_ridge.moments_twin(R, Z, codes, B)
    Zc = cuda_ridge.correction(W, R, Z, codes, index)
    Zc_ref = cuda_ridge.correction_twin(W, R, Z, codes)
    same4 = bool(torch.equal(M, cuda_ridge.moments(R, Z, codes, B, index)))
    same5 = bool(torch.equal(Zc, cuda_ridge.correction(W, R, Z, codes, index)))
    torch.cuda.synchronize()
    e4, e5 = float((M - M_ref).abs().max()), float((Zc - Zc_ref).abs().max())
    r4, r5 = rel_err(M, M_ref), rel_err(Zc, Zc_ref)
    what = (f"N={N} d={d} K={K} B={B} {kind} codes"
            + (f", batch {absent} absent" if absent is not None else "")
            + f", index tiles of {index.tile}")
    log(f"  K4 {what}: max|dM|={e4:.3e} rel {r4:.3e} (rtol {SUM_RTOL}); repeat bit-equal "
        f"{same4}")
    log(f"  K5 {what}: max|dZ|={e5:.3e} rel {r5:.3e} (rtol {SUM_RTOL}); repeat bit-equal "
        f"{same5}")
    require(r4 <= SUM_RTOL, f"K4 disagrees at {what}: {r4}")
    require(r5 <= SUM_RTOL, f"K5 disagrees at {what}: {r5}")
    require(same4 and same5, f"K4/K5 repeats differ at {what}: {same4}, {same5}")
    k4, k5 = {"max_abs_err": e4}, {"max_abs_err": e5}
    if timed:
        oh = torch.nn.functional.one_hot(codes.long(), B).float()
        Za = torch.cat([Z, torch.ones(1, N, device=dev)])
        b4 = 4 * (K * N + d * N + N + K * B * (d + 1))
        b5 = 4 * (K * N + 2 * d * N + N + K * B * d)
        k4["ms"] = time_ms(torch, f"K4 kernel ({kind})",
                           lambda: cuda_ridge.moments(R, Z, codes, B, index))
        k4["plain_ms"] = time_ms(torch, "K4 plain", lambda: cuda_ridge.moments_twin(R, Z, codes, B))
        k4["library_ms"] = time_ms(torch, "K4 library einsum",
                                   lambda: torch.einsum("kn,nb,dn->kbd", R, oh, Za))
        k4["bound_ms"], k4["bound_by"] = bound(b4, 2.0 * K * (d + 1) * N)
        k4["gb_per_s"] = b4 / k4["ms"] / 1e6
        k5["ms"] = time_ms(torch, f"K5 kernel ({kind})",
                           lambda: cuda_ridge.correction(W, R, Z, codes, index))
        k5["plain_ms"] = time_ms(torch, "K5 plain",
                                 lambda: cuda_ridge.correction_twin(W, R, Z, codes))
        k5["library_ms"] = time_ms(torch, "K5 library einsum",
                                   lambda: torch.einsum("kn,nb,kbd->dn", R, oh, W))
        k5["bound_ms"], k5["bound_by"] = bound(b5, 2.0 * K * d * N)
        k5["gb_per_s"] = b5 / k5["ms"] / 1e6
        k4["index_ms"] = time_ms(torch, "the cell index, built once a run",
                                 lambda: cuda_ridge.cell_index(codes, B, index.tile))
        log(f"  K4 {k4['ms']:.4f} ms ({k4['gb_per_s']:.1f} GB/s, bound {k4['bound_ms']:.4f} ms), "
            f"K5 {k5['ms']:.4f} ms ({k5['gb_per_s']:.1f} GB/s, bound {k5['bound_ms']:.4f} ms) "
            f"at {what}")
    return k4, k5


def rotate_problem(torch, N, d, K, B_vec, seed, dev, T=None):
    """Seeded inputs of the rotate kernels at the geometry
    finalize_engine_config gives N cells (from an E-step tile of ``T``
    cells where given): a raw (un-normalised) padded
    embedding, per-covariate codes padded with the sentinel, centroids near
    some cells, sigma 0.1, theta 2, and a generator for the schedule."""
    from harmony_tpu_torch import ops
    from harmony_tpu_torch.config import HarmonyConfig, finalize_engine_config
    from harmony_tpu_torch.ops import rotate

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cfg = finalize_engine_config(HarmonyConfig(
        N=N, d=d, K=K, B=sum(B_vec), B_vec=tuple(B_vec), shuffle_mode="rotate",
        **({"estep_sub_tile": T} if T else {})))
    require(T is None or cfg.estep_sub_tile == T,
            f"rotate_problem: the E-step tile resolved to {cfg.estep_sub_tile}, not {T}")
    Np = cfg.Np
    Z = torch.zeros(d, Np, device=dev)
    Z[:, :N] = 2.0 * torch.randn(d, N, generator=g, device=dev)
    Zn = ops.l2_normalize_columns(Z[:, :N])
    Y = ops.l2_normalize_columns(Zn[:, torch.randperm(N, generator=g, device=dev)[:K]]
                                 + 0.1 * torch.randn(d, K, generator=g, device=dev))
    codes = torch.zeros(len(B_vec), Np, dtype=torch.int32, device=dev)
    for c, b in enumerate(B_vec):
        codes[c, :N] = torch.randint(0, b, (N,), generator=g, device=dev, dtype=torch.int32)
    sizes = torch.cat([torch.bincount(codes[c, :N].long(), minlength=b)
                       for c, b in enumerate(B_vec)]).float()
    sigma = torch.full((K,), 0.1, device=dev)
    theta = torch.full((cfg.B,), 2.0, device=dev)
    return cfg, Z, rotate.make_codes_pad(cfg, codes), Y, sigma, sizes / N, theta, g


def check_rotate(torch, dev, N, d, K, B_vec, seed, timed, variant="fused_vpu"):
    """K6 (its Gram table G included) and K7 (one round with and one
    without writing R, g from K6's G, in the op order ``variant``) against
    their plain versions on the same inputs; K7's R also against the plain
    round that forms g itself."""
    import dataclasses

    from harmony_tpu_torch.ops import cuda_rotate, rotate

    cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g = rotate_problem(
        torch, N, d, K, B_vec, seed, dev)
    cfg = dataclasses.replace(cfg, estep_variant=variant)
    args6 = (cfg, Y, sigma, Pr_b, Z, codes_pad)
    Zn, tO, O, E, G = cuda_rotate.reassign(*args6)
    again = cuda_rotate.reassign(*args6)
    ref6 = rotate.reassign(*args6)
    sched = rotate.draw_schedules(cfg, g, 1)[0]
    layout = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G)
    rs = rotate.RoundState(R=torch.zeros(K, cfg.Np, device=dev), E=ref6[3], O=ref6[2],
                           tile_O=ref6[1], kmeans_error=None, entropy=None)
    args7 = (cfg, Y, rs, Pr_b, sigma, theta, sched, layout)
    out7 = {wr: cuda_rotate.rotate_update_round_v2(*args7, write_r=wr) for wr in (True, False)}
    ref7 = {wr: rotate.rotate_update_round_v2(*args7, write_r=wr) for wr in (True, False)}
    own_g = rotate.rotate_update_round_v2(*args7[:-1], layout._replace(G=None), write_r=True)
    torch.cuda.synchronize()
    e6 = float((Zn - ref6[0]).abs().max())
    eg = float((G - ref6[4]).abs().max())
    errs6 = {"tile_O": rel_err(tO, ref6[1]), "O": rel_err(O, ref6[2]), "E": rel_err(E, ref6[3])}
    same6 = all(bool(torch.equal(a, b)) for a, b in zip((Zn, tO, O, E, G), again))
    splits, smem6 = cuda_rotate.reassign_plan(K, d, cfg.B, len(B_vec))
    log(f"  K6 N={N} (Np={cfg.Np}, T={cfg.estep_sub_tile}) d={d} K={K} B_vec={B_vec}: "
        f"max|dZn|={e6:.3e}, max|dG|={eg:.3e} (atol 1e-6); "
        + ", ".join(f"{k} rel {v:.3e}" for k, v in errs6.items()) + f" (rtol {SUM_RTOL}); "
        f"repeat bit-equal {same6} ({splits} cell splits, {smem6} bytes of shared memory)")
    require(same6, "K6 repeats differ")
    require(e6 <= 1e-6, f"K6 Zn disagrees: {e6}")
    require(eg <= 1e-6, f"K6 G disagrees: {eg}")
    for k, v in errs6.items():
        require(v <= SUM_RTOL, f"K6 {k} disagrees: {v}")
    e7 = float((out7[True].R - ref7[True].R).abs().max())
    e7g = float((out7[True].R - own_g.R).abs().max())
    require(out7[False].R is rs.R, "K7 without write_r must hand back the input R")
    log(f"  K7 ({variant}) schedule rt={int(sched[0])}, order={sched[1:6].tolist()}...: "
        f"max|dR|={e7:.3e}, against the plain round forming g itself {e7g:.3e} "
        f"(atol {R_ATOL})")
    require(max(e7, e7g) <= R_ATOL, f"K7 R disagrees: {e7}, {e7g}")
    for wr in (True, False):
        o, r = out7[wr], ref7[wr]
        errs7 = {"E": rel_err(o.E, r.E), "O": rel_err(o.O, r.O),
                 "tile_O": rel_err(o.tile_O, r.tile_O),
                 "kmeans_error": rel_err(o.kmeans_error, r.kmeans_error),
                 "entropy": rel_err(o.entropy, r.entropy)}
        log(f"  K7 write_r={wr}: " + ", ".join(f"{k} rel {v:.3e}" for k, v in errs7.items())
            + f" (rtol {SUM_RTOL}); kmeans_error {float(o.kmeans_error):.7g} vs "
            f"{float(r.kmeans_error):.7g}, entropy {float(o.entropy):.7g} vs "
            f"{float(r.entropy):.7g}")
        for k, v in errs7.items():
            require(v <= SUM_RTOL, f"K7 write_r={wr} {k} disagrees: {v}")
    k6, k7 = {"max_abs_err": max(e6, eg)}, {"max_abs_err": max(e7, e7g)}
    if timed:
        Np, ncov = cfg.Np, len(B_vec)
        flops = 2.0 * K * d * Np
        k6.update(time_k6(torch, args6, "random codes", ""))
        k6["plain_ms"] = time_ms(torch, "K6 plain", lambda: rotate.reassign(*args6))
        k6["library_ms"] = None
        # Z and the codes read once, Zn and G written once (tile_O, O, E
        # are tiny)
        k6["bound_ms"], k6["bound_by"] = bound(4 * (2 * d * Np + ncov * Np + K * Np), flops)
        k7["ms"] = time_ms(torch, "K7 kernel round", lambda: cuda_rotate.rotate_update_round_v2(
            *args7, write_r=False), iters=5)
        k7["ms_write_r"] = time_ms(
            torch, "K7 kernel round writing R",
            lambda: cuda_rotate.rotate_update_round_v2(*args7, write_r=True), iters=5)
        k7["plain_ms"] = time_ms(torch, "K7 plain round", lambda: rotate.rotate_update_round_v2(
            *args7, write_r=False), iters=3)
        dms = device_ms(torch, lambda: cuda_rotate.rotate_update_round_v2(*args7, write_r=False),
                        ("rot_assign_kernel", "rot_commit_kernel"))
        # the assign launches read G and the codes once a round
        nbytes = 4 * K * Np + 4 * ncov * Np
        k7["device_ms_assign"] = dms["rot_assign_kernel"]
        k7["device_ms_commits"] = dms["rot_commit_kernel"]
        log(f"    K7 assign launches: {fmt_ms(dms['rot_assign_kernel'])} device time a round, "
            f"{fmt_rate(nbytes, dms['rot_assign_kernel'])} ({nbytes / 1e6:.1f} MB); "
            f"commits {fmt_ms(dms['rot_commit_kernel'])}")
        k7["library_ms"] = None
        # one round reads K6's G and the codes once and forms no product
        # (the chain's elementwise operations are not counted); the round
        # that writes R also writes (K, Np) once
        k7["bound_ms"], k7["bound_by"] = bound(4 * (K * Np + ncov * Np), 0.0)
        k7["bound_ms_write_r"], _ = bound(4 * (2 * K * Np + ncov * Np), 0.0)
    return k6, k7


def time_k6(torch, args6, what, sfx):
    """K6's time per call, and its assign and reduce launches' device time
    apart (keys with suffix ``sfx``)."""
    from harmony_tpu_torch.ops import cuda_rotate

    cfg = args6[0]
    part_mb = cfg.Np // 64 * cfg.K * cfg.B * 4 / 1e6
    row = {"ms" + sfx: time_ms(torch, f"K6 kernel, G stored ({what})",
                               lambda: cuda_rotate.reassign(*args6))}
    dms = device_ms(torch, lambda: cuda_rotate.reassign(*args6),
                    ("reassign_assign_kernel", "reassign_reduce_kernel"))
    row["ms_assign" + sfx] = dms["reassign_assign_kernel"]
    row["ms_reduce" + sfx] = dms["reassign_reduce_kernel"]
    log(f"    K6 device time ({what}): assign {fmt_ms(row['ms_assign' + sfx])}, reduce "
        f"{fmt_ms(row['ms_reduce' + sfx])} ({part_mb:.1f} MB of partials, "
        f"{fmt_rate(part_mb * 1e6, row['ms_reduce' + sfx])})")
    return row


def virtual_problem(torch, dev, N, d, K, B_vec, seed, variant, tiles=None):
    """rotate_problem's inputs in the op order ``variant`` with the cells in
    a batch-tiled order (so the layout has pure tiles of 256 cells, 128
    below 100k cells; ``tiles`` (E-step tile, layout tile) sets both) and a
    seeded Z_orig. Returns (cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g,
    tile, layout, Z_orig, n_joint, tile_joint)."""
    import dataclasses

    from harmony_tpu_torch.ops.ridge import full_tile_joint
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order

    cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g = rotate_problem(
        torch, N, d, K, B_vec, seed, dev, T=tiles[0] if tiles else None)
    cfg = dataclasses.replace(cfg, estep_variant=variant)
    tile = tiles[1] if tiles else 256 if N >= 100_000 else 128
    order, layout = build_batch_tiled_order(codes_pad[:, :N].cpu().numpy(), tile, seed)
    order = torch.as_tensor(order, device=dev)
    Z[:, :N] = Z[:, order]
    codes_pad[:, :N] = codes_pad[:, order]
    Zo = torch.zeros(d, cfg.Np, device=dev)
    Zo[:, :N] = 2.0 * torch.randn(d, N, generator=g, device=dev)
    return (cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g, tile, layout, Zo,
            int(layout.joint_codes.shape[1]), full_tile_joint(cfg, layout))


def check_virtual(torch, dev, N, d, K, B_vec, seed, timed, variant="fused_vpu", tiles=None):
    """A phase's last K7 round with the fused moments and the penalty
    tables (writing R and not), K10 and K11 against their plain versions
    on the same inputs, in the op order ``variant``, the cells in a
    batch-tiled order so the layout has pure tiles (``tiles``: the E-step
    and layout tiles, TILE160's layout tiles that are not whole 64-cell
    pieces). K11 from K7's tables
    must give back the R K7 wrote. The correction goes through the route
    the engine takes (K10 where it takes the shape, else K11 then K9), and
    again without G (K11 then K9). Timed under ``legacy``, only K7's last
    round, K10 and K11 (keys ``*_legacy``); with ``tiles``, only K7's last
    round and K10 (keys ``*_tile160``)."""
    from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate, rotate
    from harmony_tpu_torch.ops.ridge import virtual_tile_correction

    (cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g, tile, layout, Zo, nj,
     tj) = virtual_problem(torch, dev, N, d, K, B_vec, seed, variant, tiles)
    Np, ncov = cfg.Np, len(B_vec)
    spec = rotate.MomentsSpec(Z_orig=Zo, tile_joint=tj, n_joint=nj, tile=tile)
    # K6's Zn and G, as the engine hands them to the phase's rounds
    args6 = (cfg, Y, sigma, Pr_b, Z, codes_pad)
    Zn, tO, O, E, G = cuda_rotate.reassign(*args6)
    sched = rotate.draw_schedules(cfg, g, 1)[0]
    lay = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G)
    rs = rotate.RoundState(R=torch.zeros(K, Np, device=dev), E=E, O=O, tile_O=tO,
                           kmeans_error=None, entropy=None)
    args = (cfg, Y, rs, Pr_b, sigma, theta, sched, lay)
    kw = dict(moments=spec, emit_pen=True)
    out = cuda_rotate.rotate_update_round_v2(*args, write_r=True, **kw)
    outv = cuda_rotate.rotate_update_round_v2(*args, write_r=False, **kw)
    ref = rotate.rotate_update_round_v2(*args, write_r=True, **kw)
    vargs = (Y, sigma, out.pen, out.blkmap, Zn, codes_pad)
    R11 = cuda_rotate.materialize_r(cfg, *vargs)
    R11_ref = rotate.materialize_r(cfg, *vargs)
    W = 0.1 * torch.randn(nj + 1, d, K, generator=g, device=dev)
    W[nj] = 0.0
    # K10 reads K6's G, as the engine hands it over from the phase; where
    # K10 does not take K, d and B, the correction runs K11, then K9
    cargs = (cfg, W, tj, tile, *vargs, Zo, G)
    virt = rotate.VirtualR(pen=out.pen, blkmap=out.blkmap, Zn_pad=Zn, codes_pad=codes_pad, Y=Y,
                           Z_orig_pad=Zo, sigma=sigma, G=G)
    counts = (cuda_rotate.virtual_correction, cuda_rotate.materialize_r,
              cuda_ridge.tiled_correction)

    def routed(v):
        before = [f.launches for f in counts]
        z = virtual_tile_correction(cfg, W, tj, tile, v)
        return z, [f.launches - b for f, b in zip(counts, before)]

    k10_takes = cuda_rotate.k10_fits(cfg, d, Np // tile, dev)
    Zc, route = routed(virt)
    same10 = bool(torch.equal(Zc, routed(virt)[0]))
    # a state without G (built from the JAX package's arrays): K11, then K9
    Zc_nog, route_nog = routed(virt._replace(G=None))
    Zc_ref = rotate.virtual_correction(*cargs)
    Zc9 = cuda_ridge.tiled_correction(W, tj, out.R, Zo, tile)
    torch.cuda.synchronize()
    e7 = float((out.R - ref.R).abs().max())
    errs7 = {f: rel_err(getattr(out, f), getattr(ref, f))
             for f in ("M", "pen", "E", "O", "tile_O", "kmeans_error", "entropy")}
    same_map = bool(torch.equal(out.blkmap, ref.blkmap))
    same_v = bool(torch.equal(outv.M, out.M) and torch.equal(outv.pen, out.pen))
    e11 = float((R11 - R11_ref).abs().max())
    e11_7 = float((R11 - out.R).abs().max())
    e10, r10 = float((Zc - Zc_ref).abs().max()), rel_err(Zc, Zc_ref)
    e10_9 = float((Zc - Zc9).abs().max())
    colsum = float(R11[:, :N].sum(0).sub(1).abs().max())
    log(f"  K7 last round ({variant}) N={N} (Np={Np}) d={d} K={K} B_vec={B_vec}, layout tile "
        f"{tile}, {nj} joint levels, moments + emit_pen: max|dR|={e7:.3e} (atol {R_ATOL}); "
        + ", ".join(f"{k} rel {v:.3e}" for k, v in errs7.items()) + f" (rtol {SUM_RTOL}); "
        f"tile -> block map equal: {same_map}; without writing R the same M and pen: {same_v}")
    log(f"  K11 ({k11_form(torch, dev, cfg, d, Np)}) max|dR|={e11:.3e} (atol {R_ATOL}), "
        f"against K7's written R {e11_7:.3e} "
        f"(atol 1e-6; reads 0.0 when K6's G and K11's product and chain agree bit for "
        f"bit: {e11_7 == 0.0}); R column sums within {colsum:.2e} of 1")
    e_nog = float((Zc_nog - Zc).abs().max())
    log(f"  K10 (K10, K11, K9 launches {route}; K10 takes the shape: {k10_takes}) "
        f"max|dZ|={e10:.3e} rel {r10:.3e} (rtol {SUM_RTOL}); against K9 on K7's R "
        f"max|dZ|={e10_9:.3e} (atol 1e-6; 0.0 when both take the same bits of R: "
        f"{e10_9 == 0.0}); repeat bit-equal {same10}; without G (launches {route_nog}) "
        f"max|dZ|={e_nog:.3e} (atol 1e-6)")
    require(e7 <= R_ATOL, f"K7 (last round) R disagrees: {e7}")
    for k, v in errs7.items():
        require(v <= SUM_RTOL, f"K7 (last round) {k} disagrees: {v}")
    require(same_map, "K7 tile -> block map disagrees")
    require(same_v, "K7 without writing R gives other moments or tables")
    require(e11 <= R_ATOL, f"K11 R disagrees: {e11}")
    require(e11_7 <= 1e-6, f"K11 R is not the R K7 wrote: {e11_7}")
    require(colsum <= 1e-4, f"K11 R columns do not sum to 1: {colsum}")
    require(r10 <= SUM_RTOL, f"K10 disagrees: {r10}")
    require(e10_9 <= 1e-6, f"K10 is not K9 on the R K7 wrote: {e10_9}")
    require(same10, "K10 repeats differ")
    require(route == ([1, 0, 0] if k10_takes else [0, 1, 1]),
            f"the correction took launches {route} (K10 takes the shape: {k10_takes})")
    require(route_nog == [0, 1, 1], f"the correction without G took launches {route_nog}")
    require(e_nog <= 1e-6, f"the correction without G disagrees: {e_nog}")
    k7m = {"max_abs_err_moments": max(e7, errs7["M"])}
    k10, k11 = {"max_abs_err": e10}, {"max_abs_err": max(e11, e11_7)}
    k6 = {}
    if timed and tiles:
        nb = out.pen.shape[0]
        k7m = {"ms_moments_tile160": time_ms(
            torch, f"K7 kernel last round, moments + penalty tables, {tile}-cell tiles",
            lambda: cuda_rotate.rotate_update_round_v2(*args, write_r=False, **kw), iters=5),
               "plain_ms_moments_tile160": time_ms(
            torch, f"K7 plain last round, moments + penalty tables, {tile}-cell tiles",
            lambda: rotate.rotate_update_round_v2(*args, write_r=False, **kw), iters=3),
               "max_abs_err_moments_tile160": k7m["max_abs_err_moments"]}
        k7m.update(profile_k7_last(torch, cuda_rotate, lambda: cuda_rotate.rotate_update_round_v2(
            *args, write_r=False, **kw), f"{tile}-cell tiles", "_tile160"))
        k7m["bound_ms_moments_tile160"], _ = bound(*k7_moments_work(K, d, Np, ncov, nj, nb,
                                                                    cfg.B, 4))
        k10 = {"ms_tile160": time_ms(torch, f"K10 kernel, {tile}-cell tiles",
                                     lambda: cuda_rotate.virtual_correction(*cargs)),
               "plain_ms_tile160": time_ms(torch, f"K10 plain, {tile}-cell tiles",
                                           lambda: rotate.virtual_correction(*cargs), iters=3),
               "max_abs_err_tile160": e10}
        k10["bound_ms_tile160"], _ = bound(*k10_work(K, d, Np, ncov, layout.n_pure, 4))
        k11 = {}
    elif timed and variant == "legacy":
        k7m = {"ms_moments_legacy": time_ms(
            torch, "K7 kernel last round (legacy), moments + penalty tables",
            lambda: cuda_rotate.rotate_update_round_v2(*args, write_r=False, **kw), iters=5)}
        k10 = {"ms_legacy": time_ms(torch, "K10 kernel (legacy)",
                                    lambda: cuda_rotate.virtual_correction(*cargs))}
        k11 = {"ms_legacy": time_ms(torch, "K11 kernel (legacy)",
                                    lambda: cuda_rotate.materialize_r(cfg, *vargs))}
    elif timed:
        # K6 on the batch-tiled order the main path gives it
        k6 = time_k6(torch, args6, "batch-tiled order", "_tiled")
        flops = 2.0 * K * d * Np
        k7m["ms_moments"] = time_ms(
            torch, "K7 kernel last round, moments + penalty tables",
            lambda: cuda_rotate.rotate_update_round_v2(*args, write_r=False, **kw), iters=5)
        k7m["plain_ms_moments"] = time_ms(
            torch, "K7 plain last round, moments + penalty tables",
            lambda: rotate.rotate_update_round_v2(*args, write_r=False, **kw), iters=3)
        k7m.update(profile_k7_last(torch, cuda_rotate, lambda: cuda_rotate.rotate_update_round_v2(
            *args, write_r=False, **kw), f"{tile}-cell tiles", ""))
        nt = Np // tile
        oh = torch.nn.functional.one_hot(torch.as_tensor(tj, device=dev).long(), nj + 1).float()
        R3 = out.R.reshape(K, nt, tile)
        Za3 = torch.cat([Zo, torch.ones(1, Np, device=dev)]).reshape(d + 1, nt, tile)
        k7m["library_ms"] = time_ms(torch, "K7 moments library einsum (K8's, on K7's R)",
                                    lambda: torch.einsum("ktu,tj,dtu->jkd", R3, oh, Za3))
        nb = out.pen.shape[0]
        k7m["bound_ms_moments"], _ = bound(*k7_moments_work(K, d, Np, ncov, nj, nb, cfg.B, 4))
        k10["ms"] = time_ms(torch, "K10 kernel", lambda: cuda_rotate.virtual_correction(*cargs))
        k10["plain_ms"] = time_ms(torch, "K10 plain",
                                  lambda: rotate.virtual_correction(*cargs), iters=3)
        # the path K10 fuses: K11 writes R, K9 corrects on it; no single
        # PyTorch call computes K10's function
        k10["unfused_ms"] = time_ms(torch, "K11, then K9 on its R", lambda: (
            cuda_ridge.tiled_correction(W, tj, cuda_rotate.materialize_r(cfg, *vargs), Zo,
                                        tile)))
        k10["library_ms"] = None
        k10["bound_ms"], k10["bound_by"] = bound(*k10_work(K, d, Np, ncov, layout.n_pure, 4))
        k11["ms"] = time_ms(torch, "K11 kernel", lambda: cuda_rotate.materialize_r(cfg, *vargs))
        k11["plain_ms"] = time_ms(torch, "K11 plain",
                                  lambda: rotate.materialize_r(cfg, *vargs), iters=3)
        k11["library_ms"] = None
        # Zn and the codes read once, R written once
        k11["bound_ms"], k11["bound_by"] = bound(4 * (d * Np + ncov * Np + K * Np), flops)
    return k7m, k10, k11, k6


def profile_k7_last(torch, cuda_rotate, fn, what, sfx) -> dict:
    """K7's last round with moments under torch.profiler: the device ms a
    call of its assign launches, its commits and the per-joint sum of the
    moments, and its launches a call."""
    before = cuda_rotate.rotate_update_round_v2.launches
    fn()
    n = cuda_rotate.rotate_update_round_v2.launches - before
    dms = device_ms(torch, fn, ("rot_assign_kernel", "rot_commit_kernel", "sum_chunks_kernel"))
    log(f"    K7 last round with moments, {what}: assign {fmt_ms(dms['rot_assign_kernel'])}, "
        f"commits {fmt_ms(dms['rot_commit_kernel'])}, joint sums "
        f"{fmt_ms(dms['sum_chunks_kernel'])} device time a call; {n} launches a call")
    return {f"device_ms_moments_assign{sfx}": dms["rot_assign_kernel"],
            f"device_ms_moments_commits{sfx}": dms["rot_commit_kernel"],
            f"launches_a_call_moments{sfx}": n}


def probe_k7_tiles(torch, dev) -> dict:
    """K7's last round with moments at one E-step tile (T = 2560) on
    160-cell layout tiles (split pieces) and 256-cell ones (whole pieces),
    at N_TILE160 and N_MAIN cells: what the split moments cost at one
    launch plan, and how the time follows the cells a launch. Profiled
    only (device ms a call, by kernel), logged and returned."""
    from harmony_tpu_torch.ops import cuda_rotate, rotate

    out = {}
    for n in (N_TILE160, N_MAIN):
        for tw in (TILE160[1], 256):
            (cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g, tile, layout, Zo, nj,
             tj) = virtual_problem(torch, dev, n, D_MAIN, K_MAIN, (B_MAIN,), 31, "fused_vpu",
                                   (TILE160[0], tw))
            Zn, tO, O, E, G = cuda_rotate.reassign(cfg, Y, sigma, Pr_b, Z, codes_pad)
            sched = rotate.draw_schedules(cfg, g, 1)[0]
            rs = rotate.RoundState(R=torch.zeros(K_MAIN, cfg.Np, device=dev), E=E, O=O,
                                   tile_O=tO, kmeans_error=None, entropy=None)
            args = (cfg, Y, rs, Pr_b, sigma, theta, sched,
                    rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G))
            spec = rotate.MomentsSpec(Z_orig=Zo, tile_joint=tj, n_joint=nj, tile=tile)
            ctas = cfg.Np // 64 / cfg.n_blocks
            row = profile_k7_last(
                torch, cuda_rotate, lambda: cuda_rotate.rotate_update_round_v2(
                    *args, write_r=False, moments=spec, emit_pen=True),
                f"T={cfg.estep_sub_tile}, {tw}-cell tiles, N={n}, ~{ctas:.0f} CTAs an "
                f"assign launch", "")
            out[f"{n}_{tw}"] = row
            del Z, Zn, G, Zo, rs, args
    return out


def k11_form(torch, dev, cfg, d, Np) -> str:
    """K11's launch plan at a shape, for the log."""
    from harmony_tpu_torch.ops import cuda_rotate

    plan = cuda_rotate.materialize_r_plan(cfg.K, d, cfg.B, cfg.n_covariates, cfg.bf16_products)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chain = f"v_chain, {plan.kj} values a lane" if plan.kj else "assign_chain"
    return (f"{chain}, Y {'staged' if plan.ys_shared else 'read from device memory'}, "
            f"{plan.smem} bytes of shared memory, "
            f"{cuda_rotate.materialize_r_grid(Np // 64, plan.smem, n_sm)} CTAs")


def check_k11(torch, dev, N, d, K, B_vec, seed, variant):
    """K11 alone against its plain version, twice bit-equal, on a layout
    normalised by K6's plain version and seeded penalty tables, at a shape
    K6 does not take (so no phase's Gram table exists to hold it to)."""
    import dataclasses

    from harmony_tpu_torch.ops import cuda_rotate, rotate

    cfg, Z, codes_pad, Y, sigma, Pr_b, _, g = rotate_problem(torch, N, d, K, B_vec, seed, dev)
    cfg = dataclasses.replace(cfg, estep_variant=variant)
    Zn = rotate.reassign(cfg, Y, sigma, Pr_b, Z, codes_pad)[0]
    nb = len(rotate.block_sizes(cfg)[0])
    pen = 0.5 + torch.rand(nb, K, cfg.B, generator=g, device=dev)
    vargs = (Y, sigma, pen, rotate.block_of_tiles(cfg, 5, dev), Zn, codes_pad)
    R = cuda_rotate.materialize_r(cfg, *vargs)
    same = bool(torch.equal(R, cuda_rotate.materialize_r(cfg, *vargs)))
    R_ref = rotate.materialize_r(cfg, *vargs)
    torch.cuda.synchronize()
    err = float((R - R_ref).abs().max())
    colsum = float(R[:, :N].sum(0).sub(1).abs().max())
    log(f"  K11 alone ({variant}) N={N} d={d} K={K} B_vec={B_vec} "
        f"({k11_form(torch, dev, cfg, d, cfg.Np)}): max|dR|={err:.3e} (atol {R_ATOL}); "
        f"repeat bit-equal {same}; "
        f"R column sums within {colsum:.2e} of 1")
    require(err <= R_ATOL, f"K11 alone disagrees: {err}")
    require(same, "K11 repeats differ")
    require(colsum <= 1e-4, f"K11 alone: R columns do not sum to 1: {colsum}")


def storage_ulps(torch, out, ref) -> float:
    """The largest |out - ref| of two tensors of a 2-byte float dtype in
    ulps of ref in that dtype (an ulp at |r| is 2^(floor(log2 |r|) - m),
    m = 7 for bf16 and 10 for float16, the exponent floored at the
    smallest normal's); 0 where they are equal."""
    fi = torch.finfo(ref.dtype)
    m, emin = -math.log2(fi.eps), math.log2(fi.tiny)
    o, r = out.double(), ref.double()
    a = r.abs()
    e = torch.floor(torch.log2(a.clamp_min(fi.tiny))).clamp_min(emin)
    return float(((o - r).abs() / torch.exp2(e - m)).max())


def check_storage_forms(torch, dev, N, d, K, B_vec, seed, timed, dt, variant="fused_vpu",
                        tiles=None):
    """The 2-byte storage forms (``dt``: bf16 or float16), fp32 products, of
    K6 (Z_raw in ``dt``), K7's last round (moments on Z_orig in ``dt``, R
    written in ``dt``), K10 (Z_orig in, Z_corr out) and K11 (R out) on
    check_virtual's inputs stored in ``dt``, in the op order ``variant``
    (``tiles``: the E-step and layout tiles, TILE160's). Required, 0.0:
    K6's and K7's float32 outputs equal the float32 forms' on the upcast
    inputs; K11's R equals K7's float32 R of the same round cast to ``dt``;
    K10's Z_corr equals K9 on K11's float32 R and the upcast Z_orig, cast
    to ``dt``; each kernel's two launches bit-equal. Against the plain
    versions on the same inputs: float32 outputs at the float32 checks'
    bounds, 2-byte outputs within one ulp of ``dt`` past the float32
    difference (atol 1e-5). Timed (``timed``) beside the float32 forms on
    the upcast inputs, with bounds for 2-byte storage."""
    import dataclasses

    from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate, rotate
    from harmony_tpu_torch.ops.ridge import virtual_tile_correction

    eps = torch.finfo(dt).eps
    (cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g, tile, layout, Zo, nj,
     tj) = virtual_problem(torch, dev, N, d, K, B_vec, seed, variant, tiles)
    # the engine dtype with fp32 products: the precision the float32 config
    # resolved ('float32') stays
    cfg = dataclasses.replace(cfg, dtype=str(dt).removeprefix("torch."))
    require(not cfg.bf16_products, "the storage forms' config takes the bf16 product form")
    Np, ncov = cfg.Np, len(B_vec)
    Zb, Zob = Z.to(dt), Zo.to(dt)
    Zu, Zou = Zb.float(), Zob.float()
    spec_b = rotate.MomentsSpec(Z_orig=Zob, tile_joint=tj, n_joint=nj, tile=tile)
    spec_u = spec_b._replace(Z_orig=Zou)
    # K6
    args6 = (cfg, Y, sigma, Pr_b)
    out6 = cuda_rotate.reassign(*args6, Zb, codes_pad)
    again6 = cuda_rotate.reassign(*args6, Zb, codes_pad)
    up6 = cuda_rotate.reassign(*args6, Zu, codes_pad)
    ref6 = rotate.reassign(*args6, Zb, codes_pad)
    Zn, tO, O, E, G = out6
    # K7, a phase's last round on 2-byte state: R, E and O in dt
    sched = rotate.draw_schedules(cfg, g, 1)[0]
    lay = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G)
    rs = rotate.RoundState(R=torch.zeros(K, Np, device=dev, dtype=dt), E=E.to(dt),
                           O=O.to(dt), tile_O=tO, kmeans_error=None, entropy=None)
    args7 = (cfg, Y, rs, Pr_b, sigma, theta, sched, lay)
    kw = dict(write_r=True, emit_pen=True)
    out7 = cuda_rotate.rotate_update_round_v2(*args7, moments=spec_b, **kw)
    again7 = cuda_rotate.rotate_update_round_v2(*args7, moments=spec_b, **kw)
    up7 = cuda_rotate.rotate_update_round_v2(*args7, moments=spec_u, **kw)
    f32_7 = cuda_rotate.rotate_update_round_v2(*args7[:2], rs._replace(R=torch.zeros(
        K, Np, device=dev)), *args7[3:], moments=spec_u, **kw)
    ref7 = rotate.rotate_update_round_v2(*args7, moments=spec_b, **kw)
    # K11 and K10 from that round's tables
    vargs = (Y, sigma, out7.pen, out7.blkmap, Zn, codes_pad)
    R11 = cuda_rotate.materialize_r(cfg, *vargs, out_dtype=dt)
    again11 = cuda_rotate.materialize_r(cfg, *vargs, out_dtype=dt)
    R11f = cuda_rotate.materialize_r(cfg, *vargs)
    ref11 = rotate.materialize_r(cfg, *vargs, out_dtype=dt)
    W = 0.1 * torch.randn(nj + 1, d, K, generator=g, device=dev)
    W[nj] = 0.0
    cargs = (cfg, W, tj, tile, *vargs)
    Zc9 = cuda_ridge.tiled_correction(W, tj, R11f, Zou, tile)
    k10_takes = cuda_rotate.k10_fits(cfg, d, Np // tile, dev)
    if k10_takes:
        Zc = cuda_rotate.virtual_correction(*cargs, Zob, G)
        again10 = cuda_rotate.virtual_correction(*cargs, Zob, G)
        ref10 = rotate.virtual_correction(*cargs, Zob, G)
    else:
        # past K10's limits the correction runs K11, then K9, on float32
        virt = rotate.VirtualR(pen=out7.pen, blkmap=out7.blkmap, Zn_pad=Zn,
                               codes_pad=codes_pad, Y=Y, Z_orig_pad=Zob, sigma=sigma, G=G)
        Zc = virtual_tile_correction(cfg, W, tj, tile, virt)
        again10 = virtual_tile_correction(cfg, W, tj, tile, virt)
        ref10 = Zc9
    torch.cuda.synchronize()
    what = f"{dt} storage"
    require(all(t.dtype == torch.float32 for t in out6), f"K6 ({what}) outputs are not float32")
    require(out7.R.dtype == R11.dtype == dt and Zc.dtype == (dt if k10_takes else torch.float32),
            f"K7, K11 or K10 ({what}) outputs are not {dt}, or the fallback not float32")
    d6 = max(float((a - b).abs().max()) for a, b in zip(out6, up6))
    same6 = all(bool(torch.equal(a, b)) for a, b in zip(out6, again6))
    e6 = max(float((Zn - ref6[0]).abs().max()), float((G - ref6[4]).abs().max()))
    r6 = max(rel_err(a, b) for a, b in zip(out6[1:4], ref6[1:4]))
    names7 = ("M", "pen", "tile_O", "kmeans_error", "entropy")
    d7 = max(float((getattr(out7, f) - getattr(up7, f)).abs().max()) for f in names7)
    d7r = max(float((getattr(out7, f).float() - getattr(up7, f).float()).abs().max())
              for f in ("R", "E", "O"))
    same7 = all(bool(torch.equal(getattr(out7, f), getattr(again7, f)))
                for f in names7 + ("R", "E", "O"))
    r7 = max(rel_err(getattr(out7, f), getattr(ref7, f)) for f in names7)
    u7 = storage_ulps(torch, out7.R, ref7.R)
    r_cast = float((out7.R.float() - f32_7.R.to(dt).float()).abs().max())
    d11 = float((R11.float() - f32_7.R.to(dt).float()).abs().max())
    same11 = bool(torch.equal(R11, again11))
    u11 = storage_ulps(torch, R11, ref11)
    e11 = float((R11.float() - ref11.float()).abs().max())
    d10 = float((Zc.float() - Zc9.to(Zc.dtype).float()).abs().max())
    same10 = bool(torch.equal(Zc, again10))
    e10 = float((Zc.float() - ref10.float()).abs().max())
    u10 = storage_ulps(torch, Zc, ref10) if k10_takes else 0.0
    colsum = float(R11[:, :N].float().sum(0).sub(1).abs().max())
    log(f"  {what} forms ({variant}) N={N} (Np={Np}) d={d} K={K} B_vec={B_vec}, layout tile "
        f"{tile}: K6 against its float32 form on the upcast Z {d6:.1e} (0.0 required), "
        f"repeat bit-equal {same6}, plain max|dZn|,|dG| {e6:.2e} (1e-6), sums rel {r6:.2e}; "
        f"K7 last round against the float32 form on the upcast Z_orig: M, pen, tile_O, "
        f"objective {d7:.1e}, R/E/O {d7r:.1e} (0.0), its {dt} R against the float32 form's "
        f"cast {r_cast:.1e} (0.0), repeat bit-equal {same7}, plain rel {r7:.2e}, R "
        f"{u7:.2f} ulp; K11 against K7's float32 R cast {d11:.1e} (0.0), repeat bit-equal "
        f"{same11}, plain max|dR| {e11:.2e} ({u11:.2f} ulp), R column sums within "
        f"{colsum:.2e} of 1; " + (
            f"K10 against K9 on K11's float32 R, cast {d10:.1e} (0.0), repeat bit-equal "
            f"{same10}, plain max|dZ| {e10:.2e} ({u10:.2f} ulp)" if k10_takes else
            f"past K10's limits K11, then K9 on float32 copies, against K9 on K11's R "
            f"{d10:.1e} (0.0), repeat bit-equal {same10}"))
    require(d6 == 0.0 and same6, f"K6 ({what}): {d6} against the float32 form, repeat {same6}")
    require(e6 <= 1e-6 and r6 <= SUM_RTOL, f"K6 ({what}) disagrees with its plain version: "
            f"{e6}, {r6}")
    require(d7 == 0.0 and d7r == 0.0 and r_cast == 0.0 and same7,
            f"K7 ({what}): {d7}, {d7r}, {r_cast} against the float32 form, repeat {same7}")
    require(r7 <= SUM_RTOL, f"K7 ({what}) disagrees with its plain version: {r7}")
    # 2-byte outputs: the float32 difference (R_ATOL) plus one ulp of dt
    bad7 = (out7.R.float() - ref7.R.float()).abs() > R_ATOL + ref7.R.float().abs() * eps
    require(not bool(bad7.any()), f"K7 ({what}) R disagrees with its plain version")
    require(d11 == 0.0 and same11, f"K11 ({what}): {d11} against K7's R cast, repeat {same11}")
    bad11 = (R11.float() - ref11.float()).abs() > R_ATOL + ref11.float().abs() * eps
    require(not bool(bad11.any()), f"K11 ({what}) disagrees with its plain version: {e11}")
    require(colsum <= 1e-2, f"K11 ({what}) R columns do not sum to 1: {colsum}")
    require(d10 == 0.0 and same10, f"K10 ({what}): {d10} against K9 on K11's R, repeat {same10}")
    bad10 = (Zc.float() - ref10.float()).abs() > SUM_RTOL * float(
        ref10.float().abs().max()) + ref10.float().abs() * eps
    require(not bool(bad10.any()), f"K10 ({what}) disagrees with its plain version: {e10}")
    rows = {k: {"max_abs_err": v} for k, v in
            (("K6", e6), ("K7", r7), ("K10", e10), ("K11", e11))}
    if not timed or not k10_takes:
        return rows
    flops = 2.0 * K * d * Np
    for k, fn, fn32, plain, iters in (
            ("K6", lambda: cuda_rotate.reassign(*args6, Zb, codes_pad),
             lambda: cuda_rotate.reassign(*args6, Zu, codes_pad),
             lambda: rotate.reassign(*args6, Zb, codes_pad), 10),
            ("K7", lambda: cuda_rotate.rotate_update_round_v2(
                *args7, write_r=False, moments=spec_b, emit_pen=True),
             lambda: cuda_rotate.rotate_update_round_v2(
                 *args7, write_r=False, moments=spec_u, emit_pen=True),
             lambda: rotate.rotate_update_round_v2(
                 *args7, write_r=False, moments=spec_b, emit_pen=True), 5),
            ("K10", lambda: cuda_rotate.virtual_correction(*cargs, Zob, G),
             lambda: cuda_rotate.virtual_correction(*cargs, Zou, G),
             lambda: rotate.virtual_correction(*cargs, Zob, G), 10),
            ("K11", lambda: cuda_rotate.materialize_r(cfg, *vargs, out_dtype=dt),
             lambda: cuda_rotate.materialize_r(cfg, *vargs),
             lambda: rotate.materialize_r(cfg, *vargs, out_dtype=dt), 10)):
        rows[k]["ms"] = time_ms(torch, f"{k} kernel, {what}", fn, iters=iters)
        rows[k]["ms_float32_form"] = time_ms(torch, f"{k} kernel, float32 form on the upcast "
                                             "inputs", fn32, iters=iters)
        rows[k]["plain_ms"] = time_ms(torch, f"{k} plain, {what}", plain, iters=3)
        rows[k]["library_ms"] = None
    nb = out7.pen.shape[0]
    # the bytes each function moves with Z_raw, Z_orig, Z_corr and R in 2
    # bytes and Zn, G, the codes and the tables in 4
    rows["K6"]["bound_ms"], rows["K6"]["bound_by"] = bound(
        2 * d * Np + 4 * d * Np + 4 * ncov * Np + 4 * K * Np, flops)
    rows["K7"]["bound_ms"], rows["K7"]["bound_by"] = bound(
        *k7_moments_work(K, d, Np, ncov, nj, nb, cfg.B, 2))
    rows["K10"]["bound_ms"], rows["K10"]["bound_by"] = bound(
        *k10_work(K, d, Np, ncov, layout.n_pure, 2))
    rows["K11"]["bound_ms"], rows["K11"]["bound_by"] = bound(
        4 * d * Np + 4 * ncov * Np + 2 * K * Np, flops)
    # K7's moments: the library einsum of K8's function on the 2-byte round's
    # R and the upcast Z_orig
    nt = Np // tile
    oh = torch.nn.functional.one_hot(torch.as_tensor(tj, device=dev).long(), nj + 1).float()
    R3 = f32_7.R.reshape(K, nt, tile)
    Za3 = torch.cat([Zou, torch.ones(1, Np, device=dev)]).reshape(d + 1, nt, tile)
    rows["K7"]["library_ms"] = time_ms(torch, f"K7 ({what}) moments library einsum",
                                       lambda: torch.einsum("ktu,tj,dtu->jkd", R3, oh, Za3))
    return rows


def check_products(torch, dev, N, d, K, B_vec, seed, timed, dt, variant="fused_vpu",
                   tiles=None):
    """The bf16 product forms of K6, K10 and K11 (a bf16 or float16 engine
    under the resolved 'bfloat16': both operands of g = Y^T Zn and of K10's
    W R rounded to bf16, tensor-core products, fp32 sums) on
    check_virtual's inputs stored in ``dt``, in the op order ``variant``
    (``tiles``: TILE160's layout tiles). Required: K6's G within
    PRODUCT_ATOL of the plain product on its own operands (Y and K6's Zn
    rounded to bf16, an fp32 product), its Zn equal to the fp32-product
    form's (0.0); K11's float32 R equal to the R K7's last round wrote from
    that G, bit for bit, its ``dt`` R that R cast (0.0); K10's Z_corr the
    rounding to ``dt`` of a value within PRODUCT_ATOL of the plain product
    on its operands (the betas and K11's float32 R, which K10's chain
    shares, rounded to bf16; an fp32 product): round(twin - atol) <=
    Z_corr <= round(twin + atol) elementwise, or, past K10's limits, K11
    then K9 (float32) equal to K9 on K11's R; each kernel's two launches
    bit-equal. Against the whole plain versions, which round their own
    float32 Zn and R, within what a neighbouring bf16 operand can move:
    g 2^-7 (unit vectors), R R_ATOL, Z_corr one ulp of ``dt`` plus max|W|
    (2^-8 + K R_ATOL). Timed (``timed``) beside the fp32-product forms of
    the same storage, with bounds at the bf16 tensor-core peak."""
    import dataclasses

    from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate, rotate
    from harmony_tpu_torch.ops.ridge import virtual_tile_correction

    eps = torch.finfo(dt).eps
    (cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g, tile, layout, Zo, nj,
     tj) = virtual_problem(torch, dev, N, d, K, B_vec, seed, variant, tiles)
    cfg = dataclasses.replace(cfg, dtype=str(dt).removeprefix("torch."),
                              matmul_precision="bfloat16")
    cfg32 = dataclasses.replace(cfg, matmul_precision="float32")
    require(cfg.bf16_products and not cfg32.bf16_products,
            f"bf16_products {cfg.bf16_products} under 'bfloat16', {cfg32.bf16_products} under "
            "'float32'")
    Np, ncov = cfg.Np, len(B_vec)
    what = f"bf16 products, {dt} storage"
    bfo = rotate.bf16_operand
    Zs, Zos = Z.to(dt), Zo.to(dt)
    # K6
    args6 = (Y, sigma, Pr_b, Zs, codes_pad)
    out6 = cuda_rotate.reassign(cfg, *args6)
    again6 = cuda_rotate.reassign(cfg, *args6)
    f32p6 = cuda_rotate.reassign(cfg32, *args6)
    ref6 = rotate.reassign(cfg, *args6)
    Zn, tO, O, E, G = out6
    # K7's last round reads that G (its moments on Z_orig in dt), R float32
    sched = rotate.draw_schedules(cfg, g, 1)[0]
    lay = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G)
    rs = rotate.RoundState(R=torch.zeros(K, Np, device=dev), E=E.to(dt), O=O.to(dt),
                           tile_O=tO, kmeans_error=None, entropy=None)
    spec = rotate.MomentsSpec(Z_orig=Zos, tile_joint=tj, n_joint=nj, tile=tile)
    out7 = cuda_rotate.rotate_update_round_v2(cfg, Y, rs, Pr_b, sigma, theta, sched, lay,
                                              write_r=True, moments=spec, emit_pen=True)
    # K11 from its tables, float32 and dt
    vargs = (Y, sigma, out7.pen, out7.blkmap, Zn, codes_pad)
    R11f = cuda_rotate.materialize_r(cfg, *vargs)
    R11 = cuda_rotate.materialize_r(cfg, *vargs, out_dtype=dt)
    again11 = cuda_rotate.materialize_r(cfg, *vargs, out_dtype=dt)
    ref11 = rotate.materialize_r(cfg, *vargs)
    W = 0.1 * torch.randn(nj + 1, d, K, generator=g, device=dev)
    W[nj] = 0.0
    cargs = (cfg, W, tj, tile, *vargs)
    k10_takes = cuda_rotate.k10_fits(cfg, d, Np // tile, dev)
    # the product alone on K10's operands: K11's float32 R is its chain's
    twin10 = cuda_ridge.tiled_correction_twin(bfo(W), tj, bfo(R11f), Zos.float(), tile)
    if k10_takes:
        Zc = cuda_rotate.virtual_correction(*cargs, Zos, G)
        again10 = cuda_rotate.virtual_correction(*cargs, Zos, G)
        ref10 = rotate.virtual_correction(*cargs, Zos, G)
    else:
        virt = rotate.VirtualR(pen=out7.pen, blkmap=out7.blkmap, Zn_pad=Zn, codes_pad=codes_pad,
                               Y=Y, Z_orig_pad=Zos, sigma=sigma, G=G)
        Zc = virtual_tile_correction(cfg, W, tj, tile, virt)
        again10 = virtual_tile_correction(cfg, W, tj, tile, virt)
        ref10 = cuda_ridge.tiled_correction(W, tj, R11f, Zos.float().contiguous(), tile)
    torch.cuda.synchronize()
    # K6: the product on its own operands; the plain K6 rounds its own Zn
    G_twin = (bfo(Y.t()) @ bfo(Zn)).t()
    eg = float((G - G_twin).abs().max())
    eg_plain = float((G - ref6[4]).abs().max())
    e_zn = float((Zn - f32p6[0]).abs().max())
    e_zn_plain = float((Zn - ref6[0]).abs().max())
    r6 = max(rel_err(a, b) for a, b in zip(out6[1:4], ref6[1:4]))
    same6 = all(bool(torch.equal(a, b)) for a, b in zip(out6, again6))
    # K11: K7's R, bit for bit
    d11 = float((R11f - out7.R).abs().max())
    d11c = float((R11.float() - R11f.to(dt).float()).abs().max())
    e11 = float((R11f - ref11).abs().max())
    same11 = bool(torch.equal(R11, again11))
    colsum = float(R11[:, :N].float().sum(0).sub(1).abs().max())
    same10 = bool(torch.equal(Zc, again10))
    if k10_takes:
        zc = Zc.float()
        inside = bool(((zc >= (twin10 - PRODUCT_ATOL).to(dt).float())
                       & (zc <= (twin10 + PRODUCT_ATOL).to(dt).float())).all())
        e10 = float((zc - twin10.to(dt).float()).abs().max())
        e10_plain = float((zc - ref10.float()).abs().max())
        lim10 = (ref10.float().abs() * eps + PRODUCT_ATOL
                 + float(W.abs().max()) * (2.0 ** -8 + K * R_ATOL))
        bad10 = bool(((zc - ref10.float()).abs() > lim10).any())
    else:
        e10 = e10_plain = float((Zc - ref10).abs().max())
        inside, bad10 = e10 == 0.0, False
    log(f"  {what} ({variant}) N={N} (Np={Np}) d={d} K={K} B_vec={B_vec}, layout tile {tile}: "
        f"K6 G against the product on its operands {eg:.2e} (atol {PRODUCT_ATOL}), against the "
        f"plain K6 {eg_plain:.2e} (2^-7), Zn against the fp32-product form {e_zn:.1e} (0.0), "
        f"plain {e_zn_plain:.2e} (1e-6), sums rel {r6:.2e}, repeat bit-equal {same6}; K11's "
        f"float32 R against K7's {d11:.1e} (0.0), its {dt} R against that R cast {d11c:.1e} "
        f"(0.0), plain max|dR| {e11:.2e} (atol {R_ATOL}), repeat bit-equal {same11}, R "
        f"column sums within {colsum:.2e} of 1; " + (
            f"K10 Z_corr against the product on its operands rounded to {dt} {e10:.2e} (0 but "
            f"where a sum sits at a rounding midpoint), the rounding of a value within "
            f"{PRODUCT_ATOL} of it: {inside}; against the plain K10 {e10_plain:.2e}; repeat "
            f"bit-equal {same10}" if k10_takes else
            f"past K10's limits K11 (bf16 products), then K9 on float32, against K9 on K11's "
            f"R {e10:.1e} (0.0), repeat bit-equal {same10}"))
    require(eg <= PRODUCT_ATOL and eg_plain <= 2.0 ** -7,
            f"K6 ({what}) G disagrees: {eg} (product), {eg_plain} (plain)")
    require(e_zn == 0.0 and e_zn_plain <= 1e-6 and r6 <= SUM_RTOL and same6,
            f"K6 ({what}): Zn {e_zn}, {e_zn_plain}, sums {r6}, repeat {same6}")
    require(d11 == 0.0 and d11c == 0.0 and same11,
            f"K11 ({what}): {d11} against K7's R, {d11c} cast, repeat {same11}")
    require(e11 <= R_ATOL and colsum <= 1e-2, f"K11 ({what}) disagrees with its plain "
            f"version: {e11}, column sums {colsum}")
    require(inside and not bad10 and same10,
            f"K10 ({what}): product {e10} (inside {inside}), plain {e10_plain}, repeat {same10}")
    # K10's error in ulps of dt: a sum at a rounding midpoint of dt rounds
    # one ulp from the twin's rounding
    rows = {"K6": {"max_abs_err": eg},
            "K10": {"max_abs_err": e10, "max_ulps": (storage_ulps(torch, Zc, twin10.to(dt))
                                                     if k10_takes else 0.0)},
            "K11": {"max_abs_err": e11}}
    if not timed or not k10_takes:
        return rows
    flops = 2.0 * K * d * Np
    for k, fn, fn32, plain, iters in (
            ("K6", lambda: cuda_rotate.reassign(cfg, *args6),
             lambda: cuda_rotate.reassign(cfg32, *args6),
             lambda: rotate.reassign(cfg, *args6), 10),
            ("K10", lambda: cuda_rotate.virtual_correction(*cargs, Zos, G),
             lambda: cuda_rotate.virtual_correction(cfg32, *cargs[1:], Zos, G),
             lambda: rotate.virtual_correction(*cargs, Zos, G), 10),
            ("K11", lambda: cuda_rotate.materialize_r(cfg, *vargs, out_dtype=dt),
             lambda: cuda_rotate.materialize_r(cfg32, *vargs, out_dtype=dt),
             lambda: rotate.materialize_r(cfg, *vargs, out_dtype=dt), 10)):
        rows[k]["ms"] = time_ms(torch, f"{k} kernel, {what}", fn, iters=iters)
        rows[k]["ms_fp32_products"] = time_ms(torch, f"{k} kernel, fp32 products, {dt} storage",
                                              fn32, iters=iters)
        rows[k]["plain_ms"] = time_ms(torch, f"{k} plain, {what}", plain, iters=3)
        rows[k]["library_ms"] = None
    # the bytes of the storage forms (2-byte Z_raw, Z_orig, Z_corr, R),
    # the products at the bf16 tensor-core peak, the fp32 bound beside
    work = {"K6": (2 * d * Np + 4 * d * Np + 4 * ncov * Np + 4 * K * Np, flops),
            "K10": k10_work(K, d, Np, ncov, layout.n_pure, 2),
            "K11": (4 * d * Np + 4 * ncov * Np + 2 * K * Np, flops)}
    for k, (nbytes, fl) in work.items():
        rows[k]["bound_ms"], rows[k]["bound_by"] = bound(nbytes, fl, BF16_TC_FLOP_PER_S)
        rows[k]["bound_ms_fp32_products"], _ = bound(nbytes, fl)
    return rows


def check_rotate_v1(torch, dev, N, d, K, B_vec, seed, timed):
    """K12 (one rotate round reading the old statistics from R) against
    its plain version on the same inputs: the normalised layout, R from
    the initial softmax (zero on the pads), E/O from R, and the round's row
    of the schedule table on the card (rotation NT - 1, so that the first
    block wraps past the last tile), which both read."""
    from harmony_tpu_torch import ops
    from harmony_tpu_torch.ops import cuda_estep, rotate

    cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g = rotate_problem(
        torch, N, d, K, B_vec, seed, dev)
    Zn = ops.l2_normalize_columns(Z).contiguous()
    R = ops.initial_assignments(ops.compute_distances(Y, Zn), sigma)
    R[:, N:] = 0.0
    codes = codes_pad.clamp_min(0)
    E = ops.compute_E(R, Pr_b)
    O = ops.compute_O(R, codes, cfg.covariate_offsets, cfg.B)
    NT = rotate.n_tiles(cfg)
    order = rotate.schedule_pairs(rotate.draw_schedules(cfg, g, 1))[0][1]
    sched = rotate.schedule_table([(NT - 1, order)], device=dev)[0]
    layout = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad)
    args = (cfg, Y, R.contiguous(), E, O, Pr_b, sigma, theta, sched, None, layout)
    out = cuda_estep.rotate_update_round_v1(*args)
    ref = rotate.rotate_update_round_v1(*args)
    torch.cuda.synchronize()
    err = float((out.R - ref.R).abs().max())
    errs = {f: rel_err(getattr(out, f), getattr(ref, f))
            for f in ("E", "O", "kmeans_error", "entropy")}
    colsum = float(out.R[:, :N].sum(0).sub(1).abs().max())
    pad_max = float(out.R[:, N:].abs().max()) if cfg.Np > N else 0.0
    log(f"  K12 N={N} (Np={cfg.Np}, T={cfg.estep_sub_tile}, {NT} tiles) d={d} K={K} "
        f"B_vec={B_vec}, table row: rotation {NT - 1}, order {order[:5]}...: max|dR|="
        f"{err:.3e} (atol "
        f"{R_ATOL}); " + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items())
        + f" (rtol {SUM_RTOL}); R column sums within {colsum:.2e} of 1, pads {pad_max:.1e}")
    require(err <= R_ATOL, f"K12 R disagrees: {err}")
    for k, v in errs.items():
        require(v <= SUM_RTOL, f"K12 {k} disagrees: {v}")
    require(colsum <= 1e-4, f"K12 R columns do not sum to 1: {colsum}")
    require(pad_max == 0.0, f"K12 pads not zero: {pad_max}")
    row = {"max_abs_err": err}
    if timed:
        Np, ncov = cfg.Np, len(B_vec)
        row["ms"] = time_ms(torch, "K12 kernel round",
                            lambda: cuda_estep.rotate_update_round_v1(*args), iters=5)
        row["plain_ms"] = time_ms(torch, "K12 plain round",
                                  lambda: rotate.rotate_update_round_v1(*args), iters=3)
        row["library_ms"] = None
        # the old R, Z and the codes read once, the new R written once
        row["bound_ms"], row["bound_by"] = bound(4 * (2 * K * Np + d * Np + ncov * Np),
                                                 2.0 * K * d * Np)
    return row


# the largest gap in Y between the Lloyd kernel and its plain round that
# check_lloyd allows: sound runs read 1.2e-7 at 500k (the sums' order) and
# 1.1e-5 at 10M (a few cells change cluster between the two fp32 orders);
# one cell dropped or misassigned moves its cluster's mean by ~5e-5 at 500k
LLOYD_GAP = {N_MAIN: 1e-5, N_10M: 1e-4}


def check_lloyd(torch, dev, N, seed) -> dict:
    """The Lloyd kernel pair against its plain version on ``N`` x 50
    synthetic cells with unit columns (Z_corr as init_cluster reads it),
    K = 100 random cells as the centroids: ms a round and of ten chained
    rounds (kmeans_centers' span), launches a round, the bound (X read
    once; 2 N K d FLOPs), the plain version's ms, the largest gap in Y
    (within LLOYD_GAP)."""
    from harmony_tpu_torch.ops import kmeans

    Z, _ = synthetic(torch, N, D_MAIN, B_MAIN, seed, dev)
    X = torch.nn.functional.normalize(Z.t(), dim=0).contiguous()
    del Z
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    Y = X[:, torch.randperm(N, generator=g, device=dev)[:K_MAIN]].contiguous()
    n0 = kmeans._lloyd_round.launches
    Yk = kmeans._lloyd_round(X, Y, N)
    torch.cuda.synchronize()
    launches = kmeans._lloyd_round.launches - n0
    require(launches == 2, f"lloyd {N}: {launches} launches a round, not 2")
    require(torch.equal(kmeans._lloyd_round(X, Y, N), Yk), f"lloyd {N}: two rounds differ")
    gap = float((Yk.double() - kmeans.lloyd_round_twin(X, Y, N).double()).abs().max())
    log(f"  lloyd {N} x {D_MAIN}, K = {K_MAIN}: largest gap to the plain round in Y {gap:.3e}")
    require(math.isfinite(gap) and gap <= LLOYD_GAP[N],
            f"lloyd {N}: gap to the plain round {gap} over {LLOYD_GAP[N]}")

    def rounds():
        Yr = Y
        for _ in range(MAX_ITER):
            Yr = kmeans._lloyd_round(X, Yr, N)

    ms = time_ms(torch, f"lloyd round {N}", lambda: kmeans._lloyd_round(X, Y, N), iters=20)
    ten = time_ms(torch, f"lloyd 10 rounds {N}", rounds, iters=2)
    plain = time_ms(torch, f"lloyd plain round {N}", lambda: kmeans.lloyd_round_twin(X, Y, N),
                    iters=3)
    b, by = bound(4.0 * D_MAIN * N, 2.0 * N * K_MAIN * D_MAIN)
    log(f"  lloyd {N}: {ms:.4f} ms a round ({b / ms:.1%} of its bound {b:.4f} ms, {by}); "
        f"10 rounds {ten:.3f} ms; plain {plain:.3f} ms")
    return {"cells": N, "ms": ms, "ten_rounds_ms": ten, "launches_a_round": launches,
            "bound_ms": b, "bound_by": by, "plain_ms": plain, "max_abs_err": gap}


def tiled_problem(torch, N, d, K, B_vec, tile, seed, dev):
    """Seeded batch-tiled M-step inputs: a simplex R with zero pad columns,
    Z, the tile -> joint table of a batch-tiled order, joint betas."""
    import numpy as np

    from harmony_tpu_torch.config import HarmonyConfig, finalize_engine_config
    from harmony_tpu_torch.ops.ridge import full_tile_joint
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order

    cfg = finalize_engine_config(HarmonyConfig(
        N=N, d=d, K=K, B=sum(B_vec), B_vec=tuple(B_vec), shuffle_mode="rotate"))
    rng = np.random.default_rng(seed)
    codes = np.stack([rng.integers(0, b, N) for b in B_vec]).astype(np.int32)
    _, layout = build_batch_tiled_order(codes, tile, seed)
    tj = full_tile_joint(cfg, layout)
    nj = layout.joint_codes.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    R = torch.zeros(K, cfg.Np, device=dev)
    R[:, :N] = torch.softmax(3 * torch.randn(K, N, generator=g, device=dev), dim=0)
    Z = torch.zeros(d, cfg.Np, device=dev)
    Z[:, :N] = 2 * torch.randn(d, N, generator=g, device=dev)
    W = 0.1 * torch.randn(nj + 1, d, K, generator=g, device=dev)
    W[nj] = 0.0
    return cfg, R, Z, tj, nj, W, layout


def check_tiled(torch, dev, N, d, K, B_vec, tile, seed, timed):
    """K8 and K9 against their plain versions on the same inputs."""
    from harmony_tpu_torch.ops import cuda_ridge

    cfg, R, Z, tj, nj, W, layout = tiled_problem(torch, N, d, K, B_vec, tile, seed, dev)
    M = cuda_ridge.tile_moments(R, Z, tile, tj, nj)
    M_ref = cuda_ridge.tile_moments_twin(R, Z, tile, tj, nj)
    Zc = cuda_ridge.tiled_correction(W, tj, R, Z, tile)
    same9 = bool(torch.equal(Zc, cuda_ridge.tiled_correction(W, tj, R, Z, tile)))
    Zc_ref = cuda_ridge.tiled_correction_twin(W, tj, R, Z, tile)
    torch.cuda.synchronize()
    e8, e9 = float((M - M_ref).abs().max()), float((Zc - Zc_ref).abs().max())
    r8, r9 = rel_err(M, M_ref), rel_err(Zc, Zc_ref)
    log(f"  K8 N={N} (Np={cfg.Np}) d={d} K={K} B_vec={B_vec} tile={tile}, {nj} joint "
        f"levels, {layout.n_pure} cells in pure tiles: max|dM|={e8:.3e} rel {r8:.3e} "
        f"(rtol {SUM_RTOL})")
    log(f"  K9 same inputs (slices staged, threads, shared memory: "
        f"{cuda_ridge.k9_plan(K, d)}): max|dZ|={e9:.3e} rel {r9:.3e} (rtol {SUM_RTOL}); "
        f"repeat bit-equal {same9}")
    require(same9, "K9 repeats differ")
    if not timed:
        # a cell axis that is not a multiple of 4, the last tile partial: K8
        # and K9 copy 4 bytes at a time, K9 loads and stores Z as scalars
        Ro, Zo = R[:, :-1].contiguous(), Z[:, :-1].contiguous()
        r8o = rel_err(cuda_ridge.tile_moments(Ro, Zo, tile, tj, nj),
                      cuda_ridge.tile_moments_twin(Ro, Zo, tile, tj, nj))
        r9o = rel_err(cuda_ridge.tiled_correction(W, tj, Ro, Zo, tile),
                      cuda_ridge.tiled_correction_twin(W, tj, Ro, Zo, tile))
        log(f"  K8 and K9 at {cfg.Np - 1} cells (unaligned rows): rel {r8o:.3e} and "
            f"{r9o:.3e} (rtol {SUM_RTOL})")
        require(r8o <= SUM_RTOL, f"K8 disagrees on unaligned rows: {r8o}")
        require(r9o <= SUM_RTOL, f"K9 disagrees on unaligned rows: {r9o}")
    require(r8 <= SUM_RTOL, f"K8 disagrees: {r8}")
    require(r9 <= SUM_RTOL, f"K9 disagrees: {r9}")
    k8, k9 = {"max_abs_err": e8}, {"max_abs_err": e9}
    if timed:
        Np = cfg.Np
        nt = Np // tile
        oh = torch.nn.functional.one_hot(torch.as_tensor(tj, device=dev).long(), nj + 1).float()
        R3 = R.reshape(K, nt, tile)
        Za3 = torch.cat([Z, torch.ones(1, Np, device=dev)]).reshape(d + 1, nt, tile)
        k8["ms"] = time_ms(torch, "K8 kernel", lambda: cuda_ridge.tile_moments(R, Z, tile, tj, nj))
        k8["plain_ms"] = time_ms(torch, "K8 plain",
                                 lambda: cuda_ridge.tile_moments_twin(R, Z, tile, tj, nj))
        k8["library_ms"] = time_ms(torch, "K8 library einsum",
                                   lambda: torch.einsum("ktu,tj,dtu->jkd", R3, oh, Za3))
        k8["bound_ms"], k8["bound_by"] = bound(
            4 * (K * Np + d * Np + (nj + 1) * K * (d + 1)), 2.0 * K * (d + 1) * Np)
        k9["ms"] = time_ms(torch, "K9 kernel",
                           lambda: cuda_ridge.tiled_correction(W, tj, R, Z, tile))
        k9["plain_ms"] = time_ms(torch, "K9 plain",
                                 lambda: cuda_ridge.tiled_correction_twin(W, tj, R, Z, tile))
        k9["library_ms"] = time_ms(torch, "K9 library einsum",
                                   lambda: torch.einsum("jdk,tj,ktu->dtu", W, oh, R3))
        k9["bound_ms"], k9["bound_by"] = bound(
            4 * (K * Np + 2 * d * Np + (nj + 1) * d * K), 2.0 * K * d * Np)
    return k8, k9


def profile_round(torch, res, fname, layout, top=12):
    """One more Harmony round of the finished run under torch.profiler:
    device time by kernel, and the device's idle share of the round's wall;
    then the same round without the profiler, whose host cost inflates the
    profiled wall. The device table and the host ops by self CPU time go
    to OUT_DIR/fname."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from harmony_tpu_torch import engine

    cfg = res.config
    # overwrite the trace slots of round 1: the run's traces are reported
    s = dataclasses.replace(res.state, n_kmeans=1, n_harmony=2, n_rounds=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.harmony_round(cfg, s, layout=layout)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.harmony_round(cfg, s, layout=layout)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    rows, host = [], []  # device kernels; host ops (an aten op also reports
    for e in prof.key_averages():  # its kernels' device time)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    with open(os.path.join(OUT_DIR, fname), "w") as fh:
        fh.write(f"wall_ms {wall * 1e3:.3f} device_busy_ms {busy:.3f} "
                 f"unprofiled_wall_ms {plain_wall * 1e3:.3f}\n")
        for ms, n, name in rows:
            fh.write(f"{ms:10.3f} ms {n:6d}x  {name}\n")
        fh.write("host ops by self CPU time (profiled round):\n")
        for ms, n, name in host[:25]:
            fh.write(f"{ms:10.3f} ms {n:6d}x  {name}\n")
    log(f"  profiled round: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}; the same round "
        f"unprofiled: wall {plain_wall * 1e3:.2f} ms")
    for ms, n, name in rows[:top]:
        log(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")


def separation(torch, Z, codes0, B):
    """Mean pairwise distance of batch centroids of the L2-normalised cells
    (Z is (d, N), codes0 (N,), both on the card)."""
    from harmony_tpu_torch.ops import l2_normalize_columns

    Zn = l2_normalize_columns(Z.float())
    oh = torch.nn.functional.one_hot(codes0.long(), B).float()
    cent = (Zn @ oh) / oh.sum(0)
    dist = torch.cdist(cent.t(), cent.t())
    return float(dist.sum() / (B * (B - 1)))


def synthetic(torch, N, d, B, seed, dev, n_types=12, scale=0.8):
    """Cell types plus a batch offset of the given scale plus noise."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    types = torch.randint(0, n_types, (N,), generator=g, device=dev)
    batches = torch.randint(0, B, (N,), generator=g, device=dev)
    tc = torch.randn(n_types, d, generator=g, device=dev) * 3.0
    bo = torch.randn(B, d, generator=g, device=dev) * scale
    Z = tc[types] + bo[batches] + torch.randn(N, d, generator=g, device=dev)
    return Z, batches


def check_traj(torch, dev, mode):
    """A 20k-cell run with injected centroids and randomness (permutations
    or rotate schedules), once through the kernels and once through the
    plain path: the objective traces and Z_corr must agree. ``rotate_cell``
    is 2,000 cells, below n_blocks * 128, so the rotate schedule takes the
    cell-granular round: its kernels are the dense M-step's K4 and K5."""
    import dataclasses

    import numpy as np

    from harmony_tpu_torch import driver, engine, preprocess
    from harmony_tpu_torch.config import finalize_engine_config, harmony_options
    from harmony_tpu_torch.ops import cuda_estep, cuda_ridge, rotate
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order
    from harmony_tpu_torch.state import init_state

    cell = mode == "rotate_cell"
    n, d, B, iters = 2_000 if cell else 20_000, D_MAIN, B_MAIN, 5
    Zs, bs = synthetic(torch, n, d, B, 5, dev)
    Zh, bh = Zs.cpu().numpy().astype(np.float64), bs.cpu().numpy()
    design = preprocess.build_design({"batch": bh.astype(str)}, ["batch"])
    rotate_mode = mode.startswith("rotate")
    two_phase = mode == "rotate_two_phase"
    base = preprocess.resolve_config(
        n_cells=n, d=d, design=design, nclust=None, max_iter=iters,
        early_stop=False, options=harmony_options(), verbose=False,
        lambda_estimation=True, ridge_solver="auto",
        shuffle_mode="rotate" if rotate_mode else "permute",
    )
    hp = preprocess.expand_hyperparams(design, base.K, None, 0.1, None, 0.0)
    rng = np.random.default_rng(6)
    Zt = Zh.T
    Y0 = Zt[:, rng.choice(n, base.K, replace=False)]
    kw, layout = {}, None
    if mode == "permute_fused":
        # the fused phase on a batch-tiled order at tile 128, so the M-step
        # takes K3's moments and runs K9
        base = dataclasses.replace(base, permute_fused=True, mstep_tile=128)
        perm, _ = build_batch_tiled_order(design.codes, 128, 0)
        Zt = Zt[:, perm]
        design = dataclasses.replace(design, codes=design.codes[:, perm])
        layout = engine.mstep_layout(finalize_engine_config(base), design.codes)
        require(layout.tiled is not None, "fused permute trajectory: no batch-tiled layout")
    if mode.startswith("permute"):
        kw["perms"] = np.stack([np.stack([rng.permutation(n) for _ in range(base.max_iter_cluster)])
                                for _ in range(iters)])
    elif cell:
        # the cell-granular round's tables: a rotation in [0, Np), then the
        # order of the n_blocks blocks; its M-step is dense (K4, K5)
        geo = finalize_engine_config(base)
        layout = engine.mstep_layout(geo, design.codes, dev)
        require(layout.tiled is None and layout.cells is not None,
                "cell-granular trajectory: not the dense M-step's layout")
        kw["schedules"] = [rotate.schedule_table([(int(rng.integers(geo.Np)),
                                                   rng.permutation(geo.n_blocks).tolist())
                                                  for _ in range(base.max_iter_cluster)], dev)
                           for _ in range(iters)]
    else:
        # a batch-tiled order at tile 128, so the M-step takes K7's fused
        # moments and runs K9 (K10 under virtual R, K8 and K9 without the
        # stats carry; the mixture gate of run_harmony would keep 20k cells
        # x 10 batches on the plain order)
        base = dataclasses.replace(base, mstep_tile=128, rotate_stats_carry=not two_phase)
        perm, _ = build_batch_tiled_order(design.codes, 128, 0)
        Zt = Zt[:, perm]
        design = dataclasses.replace(design, codes=design.codes[:, perm])
        geo = finalize_engine_config(base)
        layout = engine.mstep_layout(geo, design.codes)
        require(layout.tiled is not None, "rotate trajectory: no batch-tiled layout")
        NT, nb = rotate.n_tiles(geo), len(rotate.block_sizes(geo)[0])
        kw["schedules"] = [rotate.schedule_table([(int(rng.integers(NT)),
                                                   rng.permutation(nb).tolist())
                                                  for _ in range(base.max_iter_cluster)], dev)
                           for _ in range(iters)]
    virtual = mode == "rotate_virtual"
    # (label, impl, virtual_r): the plain path never takes virtual R (its
    # gate is the kernels'), so it is the materialised function
    runs = [("kernel", "kernel", virtual), ("torch", "torch", virtual)]
    if virtual:
        runs.append(("kernel_materialised", "kernel", False))
    out = {}
    for label, impl, vr in runs:
        cfg = finalize_engine_config(dataclasses.replace(
            base, estep_impl=impl, mstep_impl=impl, virtual_r=vr))
        require(cfg.permute_fused == (mode == "permute_fused"),
                f"{mode} trajectory resolved permute_fused={cfg.permute_fused}")
        require(cfg.rotate_route == (None if not rotate_mode else "cell" if cell else
                                     "two_phase" if two_phase else "carry"),
                f"{mode} trajectory resolved rotate_route={cfg.rotate_route!r}")
        st = init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, 0, dev)
        k12 = cuda_estep.rotate_update_round_v1.launches
        k4 = cuda_ridge.moments.launches
        t0 = time.perf_counter()
        st = driver.run(cfg, st, Y0=Y0, layout=layout, **kw)
        torch.cuda.synchronize()
        k12 = cuda_estep.rotate_update_round_v1.launches - k12
        k4 = cuda_ridge.moments.launches - k4
        require((k12 > 0) == (two_phase and impl == "kernel"),
                f"{mode} trajectory {label}: {k12} K12 launches")
        require(not cell or (k4 > 0) == (impl == "kernel"),
                f"{mode} trajectory {label}: {k4} K4 launches")
        require((st.virt_pen is not None) == (label == "kernel" and virtual),
                f"{mode} trajectory {label}: virtual R engaged={st.virt_pen is not None}")
        out[label] = (st.trace_lists(cfg), st.Z_corr.cpu().numpy(), time.perf_counter() - t0)

    def compare(a, b, obj_rtol, z_atol, what):
        (ta, za, sa), (tb, zb, sb) = out[a], out[b]
        obj_rel = float(np.max(np.abs(ta["objective_kmeans"] - tb["objective_kmeans"])
                               / np.abs(tb["objective_kmeans"])))
        z_err = float(np.max(np.abs(za - zb)))
        log(f"trajectory {mode} {n} x {d}, K={base.K}, B={B}, {iters} rounds, {what}: "
            f"objective rel {obj_rel:.3e} (rtol {obj_rtol}), max|dZ_corr|={z_err:.3e} "
            f"(atol {z_atol}); {a} {sa:.2f} s, {b} {sb:.2f} s")
        require(obj_rel <= obj_rtol, f"{mode} trajectory ({what}) objectives disagree: {obj_rel}")
        require(z_err <= z_atol, f"{mode} trajectory ({what}) Z_corr disagrees: {z_err}")
        require(np.array_equal(ta["kmeans_rounds"], tb["kmeans_rounds"]),
                f"{mode} ({what}) kmeans rounds differ")

    compare("kernel", "torch", 1e-4, 1e-4, "kernels against plain")
    if virtual:
        # the JAX package's own bounds between a virtual and a written run
        # (tests/test_tiled.py:294-353)
        compare("kernel", "kernel_materialised", 1e-5, 2e-4, "virtual against materialised")


def check_cell_route(torch, dev, wrappers):
    """run_harmony on 2,000 cells with shuffle_mode="rotate" on the card:
    below n_blocks * 128 cells it takes the cell-granular round, so no
    rotate kernel runs, and the graph route: its iterations are one
    run_rounds call that captures its iteration; R's columns sum to 1 and
    the batches mix."""
    import numpy as np

    from harmony_tpu_torch import engine, run_harmony

    n = 2000
    Zs, bs = synthetic(torch, n, D_MAIN, 4, 21, dev)
    sep0 = separation(torch, Zs.t(), bs, 4)
    caps = engine.run_rounds.captures
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = run_harmony(Zs.cpu().numpy(), {"batch": bs.cpu().numpy()}, ["batch"],
                      max_iter=MAX_ITER, return_object=True, seed=0, shuffle_mode="rotate")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    captured = engine.run_rounds.captures - caps
    ph = res.phase_seconds()
    colsum = float(np.abs(res.R.sum(0) - 1).max())
    sep1 = separation(torch, torch.as_tensor(res.Z_corr, device=dev), bs, 4)
    log(f"cell-granular rotate: run_harmony {n} x {D_MAIN}, K={res.K}, B={res.B}, route "
        f"{res.config.rotate_route!r}, Np={res.config.Np}: {int(res.state.n_rounds)} "
        f"iterations, wall {wall:.2f} s (run_rounds {ph.get('run_rounds', 0.0):.4f} s, "
        f"{captured} capture(s), the last {engine.run_rounds.capture_s:.3f} s); launches "
        f"{launches}; R column sums within {colsum:.2e} of 1; separation {sep0:.4f} -> "
        f"{sep1:.4f}")
    require(res.config.rotate_route == "cell" and res.config.Np == n,
            f"2,000 cells resolved rotate_route={res.config.rotate_route!r}")
    require(res.config.graph_route and "run_rounds" in ph and captured == 1,
            f"cell-granular route: run_harmony did not take run_rounds through a capture "
            f"(graph_route {res.config.graph_route}, scopes {sorted(ph)}, {captured} "
            "captures)")
    for k in ("K4", "K5"):
        require(launches[k] > 0, f"{k} was not launched on the cell-granular route")
    for k in ("K6", "K7", "K12"):
        require(launches[k] == 0, f"{k} was launched on the cell-granular route")
    require(np.isfinite(res.embeddings).all(), "cell-granular route: embeddings not finite")
    require(colsum <= 1e-4, f"cell-granular route: R column sums off by {colsum}")
    require(sep1 < sep0, "cell-granular route: batch-centroid separation did not shrink")


def run_driver(Zh, meta, dev, Y0=None, **change):
    """The cells ``Zh`` (N, d) in ``meta`` through run_harmony's steps with
    the config and the driver (multihost_worker.driver_result), for the
    options run_harmony has no argument for (``change``: the rotate rounds
    without the stats carry, the legacy op order, the forced fused permute
    phase, and any other config field), the rotate schedule unless
    ``change`` names another, MAX_ITER with early stop; ``Y0`` injects the
    initial centroids (d, K)."""
    from harmony_tpu_torch.config import harmony_options
    from harmony_tpu_torch.multihost_worker import driver_result

    return driver_result(Zh, meta, None, None, MAX_ITER, 0, change.pop("shuffle_mode", "rotate"),
                         harmony_options(), device=dev, Y0=Y0, **change)


def run_main_path(torch, dev, wrappers, phase):
    """run_harmony at the main shape through the entry point a user calls:
    the permute schedule (phase 'permute', the fused phase at this size;
    'permute_rounds' with a clustering budget of 6 rounds, the per-round
    kernel), or shuffle_mode left at its default (phase 'main'; 'virtual'
    with virtual_r=True; 'rotate_rounds' with a budget of 6 rounds); or the
    driver-level entry without the stats carry (phase 'rotate_two_phase'),
    or with the legacy op order, writing R ('legacy') and with virtual R
    ('legacy_virtual').
    Launch counts are set to 0 right before the call and read right after
    it.
    Returns (launches, objective trace, Harmony iterations)."""
    import numpy as np

    from harmony_tpu_torch import engine, harmony_options, run_harmony

    Zs, bs = synthetic(torch, N_MAIN, D_MAIN, B_MAIN, 7, dev)
    sep0 = separation(torch, Zs.t(), bs, B_MAIN)
    Zh = Zs.cpu().numpy()
    meta = {"batch": bs.cpu().numpy()}
    del Zs
    kw = {}
    if phase.startswith("permute"):
        kw["shuffle_mode"] = "permute"
    if phase.endswith("_rounds"):
        kw["options"] = harmony_options(max_iter_cluster=6)
    if phase == "virtual":
        kw["virtual_r"] = True
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    if phase == "rotate_two_phase":
        res = run_driver(Zh, meta, dev, rotate_stats_carry=False)
    elif phase.startswith("legacy"):
        res = run_driver(Zh, meta, dev, estep_variant="legacy",
                         virtual_r=phase == "legacy_virtual")
    else:
        res = run_harmony(Zh, meta, ["batch"], max_iter=MAX_ITER, return_object=True, seed=0,
                          **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    mode = res.config.shuffle_mode
    require(mode == ("permute" if phase.startswith("permute") else "rotate"),
            f"{phase} path resolved to shuffle_mode={mode!r}")
    route = {"permute": None, "permute_rounds": None, "rotate_two_phase": "two_phase"}
    require(res.config.rotate_route == route.get(phase, "carry"),
            f"{phase} path resolved rotate_route={res.config.rotate_route!r}")
    require(res.config.permute_fused == (phase == "permute"),
            f"{phase} path resolved permute_fused={res.config.permute_fused}")
    require((res.state.virt_pen is not None) == phase.endswith("virtual"),
            f"{phase} path: virtual R engaged={res.state.virt_pen is not None}")
    require((res.config.estep_variant == "legacy") == phase.startswith("legacy"),
            f"{phase} path: estep_variant={res.config.estep_variant!r}")
    ph = res.phase_seconds()
    n_it = int(res.state.n_rounds)
    per_it = iter_seconds(ph, n_it)
    entry = ("driver.run" if phase == "rotate_two_phase" or phase.startswith("legacy")
             else "run_harmony")
    log(f"{phase} path: {entry} {N_MAIN} x {D_MAIN}, K={res.K}, B={res.B}, {mode}, "
        f"{res.config.estep_variant}"
        f" (fused={res.config.permute_fused}, max_iter_cluster={res.config.max_iter_cluster}, "
        f"T={res.config.estep_sub_tile}, Np={res.config.Np}), max_iter={MAX_ITER}: "
        f"{n_it} iterations, wall {wall:.2f} s")
    log("  phase seconds: " + json.dumps({k: round(v, 4) for k, v in ph.items()}))
    log(f"  seconds per Harmony iteration {per_it:.4f}; "
        f"{N_MAIN / per_it:,.0f} cells/s per iteration; materialize_r "
        f"{ph.get('materialize_r', 0.0):.4f} s")
    # read before profile_round, which overwrites the traces of round 1
    trace = [float(x) for x in res.objective_harmony]
    log(f"  kmeans rounds {res.kmeans_rounds.tolist()}; objective "
        f"{[round(x, 3) for x in trace]}")
    log(f"  launches: {launches}")
    PEAKS[phase] = torch.cuda.max_memory_allocated() / 2**20
    log(f"  peak device memory {PEAKS[phase]:.1f} MiB "
        "(torch.cuda.max_memory_allocated over the call)"
        + (f"; the phase's distances G, held until K3 has run, are "
           f"{N_MAIN * res.K * 4 / 2**20:.1f} MiB of it at most" if phase == "permute" else ""))
    emb = res.embeddings
    require(emb.shape == (N_MAIN, D_MAIN) and np.isfinite(emb).all(),
            "embeddings not finite or of the wrong shape")
    colsum = res.R.sum(0)
    dev_r = float(np.abs(colsum - 1).max())
    require(dev_r <= 1e-4, f"R column sums off by {dev_r}")
    sep1 = separation(torch, torch.as_tensor(res.Z_corr, device=dev),
                      torch.as_tensor(meta["batch"], device=dev), B_MAIN)
    log(f"  R column sums within {dev_r:.2e} of 1; batch-centroid separation "
        f"{sep0:.4f} -> {sep1:.4f}")
    require(sep1 < sep0, "batch-centroid separation did not shrink")
    if phase == "permute_rounds":
        layout = engine.mstep_layout(res.config, res.design.codes, dev)
        cells = layout.cells
        require(cells is not None, "permute_rounds path: no cell index for K4/K5")
        log(f"  K4/K5 cell index: tiles of {cells.tile} cells, "
            f"{(cells.order.numel() + cells.runs.numel()) * 4 / 2**20:.2f} MiB of the peak")
        profile_round(torch, res, "profile_round_permute_rounds.txt", layout)
    else:
        layout = engine.mstep_layout(res.config, res.design.codes, dev)
        tiled = layout.tiled
        require(tiled is not None and res.ingest_inv is not None,
                f"{phase} path: no batch-tiled ingest order")
        log(f"  batch-tiled layout: tile {tiled.tile}, {len(tiled.tile_joint)} pure tiles, "
            f"{res.config.Np - tiled.n_pure} cells in the mixed/pad tail")
        profile = {"permute": "profile_round.txt", "main": "profile_round_rotate.txt",
                   "virtual": "profile_round_virtual.txt",
                   "rotate_two_phase": "profile_round_two_phase.txt"}.get(phase)
        if profile:
            profile_round(torch, res, profile, layout)
    return launches, trace, n_it


def run_tile160_path(torch, dev, wrappers, path):
    """The driver (run_harmony's steps) on N_TILE160 x 50 cells, 10
    batches, K = 100, with a user-set ``mstep_tile=160`` and
    ``estep_sub_tile=2560``: layout tiles that are not whole 64-cell
    pieces. 'virtual_tile160' takes virtual R (K6, K7 with its split
    moments, K10 once an iteration, K11 once; no K8 or K9),
    'written_tile160' writes R (K7's split moments, K9 masking a tile's
    partial slice; no K8), 'written_tile160_k8' is that run with the fused
    moments dropped before each correction, so K8 sums M from the written R:
    the reference the other two are held to, independent of K7's split
    moments. Launch counts are set to 0 right before the call and read
    right after it. Returns (launches, objective trace, iterations)."""
    import dataclasses

    import numpy as np

    from harmony_tpu_torch import engine

    virtual = path == "virtual_tile160"
    correct = engine.correct
    if path == "written_tile160_k8":
        engine.correct = lambda cfg, state, *a: correct(
            cfg, dataclasses.replace(state, tiled_moments=None), *a)
    Zs, bs = synthetic(torch, N_TILE160, D_MAIN, B_MAIN, 7, dev)
    sep0 = separation(torch, Zs.t(), bs, B_MAIN)
    Zh, meta = Zs.cpu().numpy(), {"batch": bs.cpu().numpy()}
    del Zs
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        res = run_driver(Zh, meta, dev, virtual_r=virtual, estep_sub_tile=TILE160[0],
                         mstep_tile=TILE160[1])
        torch.cuda.synchronize()
    finally:
        engine.correct = correct
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    cfg = res.config
    tiled = engine.mstep_layout(cfg, res.design.codes, dev).tiled
    ph = res.phase_seconds()
    n_it = int(res.state.n_rounds)
    per_it = iter_seconds(ph, n_it)
    trace = [float(x) for x in res.objective_harmony]
    log(f"{path} path: driver.run {N_TILE160} x {D_MAIN}, K={res.K}, B={res.B}, "
        f"{cfg.shuffle_mode} (route {cfg.rotate_route!r}, T={cfg.estep_sub_tile}, "
        f"Np={cfg.Np}), layout tile {tiled.tile if tiled else None}, virtual R "
        f"{res.state.virt_pen is not None}: {n_it} iterations, wall {wall:.2f} s")
    log("  phase seconds: " + json.dumps({k: round(v, 4) for k, v in ph.items()}))
    log(f"  seconds per Harmony iteration {per_it:.4f}; objective "
        f"{[round(x, 3) for x in trace]}")
    log(f"  launches: {launches}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    require(cfg.estep_sub_tile == TILE160[0] and tiled is not None
            and tiled.tile == TILE160[1], f"{path}: E-step tile {cfg.estep_sub_tile}, "
            f"layout tile {tiled.tile if tiled else None}")
    require(cfg.rotate_route == "carry", f"{path}: rotate_route={cfg.rotate_route!r}")
    require((res.state.virt_pen is not None) == virtual,
            f"{path}: virtual R engaged={res.state.virt_pen is not None}")
    if virtual:
        require(launches["K10"] == n_it and launches["K11"] == 1,
                f"{path}: K10 {launches['K10']} launches for {n_it} iterations, "
                f"K11 {launches['K11']}")
    emb = res.embeddings
    require(emb.shape == (N_TILE160, D_MAIN) and np.isfinite(emb).all(),
            f"{path}: embeddings not finite or of the wrong shape")
    dev_r = float(np.abs(res.R.sum(0) - 1).max())
    sep1 = separation(torch, torch.as_tensor(res.Z_corr, device=dev),
                      torch.as_tensor(meta["batch"], device=dev), B_MAIN)
    log(f"  R column sums within {dev_r:.2e} of 1; batch-centroid separation "
        f"{sep0:.4f} -> {sep1:.4f}")
    require(dev_r <= 1e-4, f"{path}: R column sums off by {dev_r}")
    require(sep1 < sep0, f"{path}: batch-centroid separation did not shrink")
    return launches, trace, n_it


def harness_env(**extra) -> dict:
    """The environment of a harness subprocess: this checkout on the path,
    no HARMONY_BENCH_* knob from outside, then ``extra``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("HARMONY_BENCH_")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def check_harness(torch, dev):
    """The port's benchmark harnesses on the card (check_harness): python -m
    harmony_tpu_torch.bench at the canonical 500k x 50, K = 100, B = 10 with
    a 60 s budget (one JSON line with the JAX payload's keys, on the gpu);
    a second run on N_SIGTERM cells sent SIGTERM once its warm-up has landed
    (exactly one line); the quality tool's parity sections (the four fixtures against
    their float64 oracle) and converge sections (cell_lines and pbmc_stim
    at the reference's defaults)."""
    import signal

    import numpy as np

    from harmony_tpu_torch.tools import quality_bench

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "harmony_tpu_torch.bench"],
                         env=harness_env(HARMONY_BENCH_BUDGET=str(HARNESS_BUDGET_S)),
                         capture_output=True, text=True, timeout=HARNESS_BUDGET_S + 120)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    log(f"harness: python -m harmony_tpu_torch.bench (500k x 50, K=100, B=10, rotate, budget "
        f"{HARNESS_BUDGET_S} s): rc {out.returncode}, {len(lines)} line(s), wall {wall:.1f} s: "
        + (lines[-1] if lines else out.stderr[-2000:]))
    require(out.returncode == 0 and len(lines) == 1,
            f"the harness printed {len(lines)} lines, rc {out.returncode}")
    payload = json.loads(lines[0])
    # "degraded" (fewer valid pairs than asked) is optional in both payloads
    require(set(payload) - {"degraded"} == set(JAX_PAYLOAD_KEYS)
            and payload["platform"] == "gpu" and payload["value"] > 0,
            f"the harness's payload keys {sorted(payload)} are not the JAX payload's")
    # the SIGTERM after the warm-up, at a small shape (the emit does not
    # depend on it): many timed rounds, so it is still going
    p = subprocess.Popen([sys.executable, "-m", "harmony_tpu_torch.bench"],
                         env=harness_env(HARMONY_BENCH_VERBOSE="1", HARMONY_BENCH_ITERS="400",
                                         HARMONY_BENCH_PAIRS="50",
                                         HARMONY_BENCH_CELLS=str(N_SIGTERM)),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        seen, deadline = "", time.monotonic() + 180
        while "warm-up done" not in seen and time.monotonic() < deadline:
            line = p.stderr.readline()
            if not line and p.poll() is not None:
                break
            seen += line
        require("warm-up done" in seen, f"the second harness run: no warm-up: {seen[-2000:]}")
        p.send_signal(signal.SIGTERM)
        so, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    lines = [ln for ln in so.splitlines() if ln.strip()]
    log(f"  SIGTERM after the warm-up ({N_SIGTERM} cells): rc {p.returncode}, "
        f"{len(lines)} line(s): "
        f"{lines[-1] if lines else ''}")
    require(p.returncode == 0 and len(lines) == 1
            and set(json.loads(lines[0])) <= set(JAX_PAYLOAD_KEYS) | {"degraded"},
            f"SIGTERM after the warm-up: rc {p.returncode}, {len(lines)} lines")
    t0 = time.perf_counter()
    parity = quality_bench.section_parity(dev)
    for name, e in parity.items():
        err = e["max_abs_err_vs_oracle"]
        log(f"  parity {name} ({e['n_cells']} cells): Z_corr max|d| against the float64 oracle "
            f"{err:.3e} (bound {PARITY_ATOL}; within the JAX engine's band "
            f"{JAX_PARITY_BAND}: {err <= JAX_PARITY_BAND}), objective rel "
            f"{e['objective_max_rel_delta_vs_oracle']:.3e} (1e-5)")
        require(err <= PARITY_ATOL and e["objective_max_rel_delta_vs_oracle"] <= 1e-5,
                f"parity {name}: {e}")
    converge = quality_bench.section_converge(dev)
    for name, e in converge.items():
        obj = np.asarray(e["objective_harmony"])
        log(f"  converge {name} ({e['n_cells']} cells, {e['vars_use']}): "
            f"{e['iters_to_converge']} iterations, k-means rounds {e['kmeans_rounds']}, wall "
            f"{e['wall_s_end_to_end']} s, warm {e['wall_s_end_to_end_warm']} s; objective "
            f"{obj.round(3).tolist()}")
        require(np.isfinite(obj).all() and obj[-1] < obj[0] and e["iters_to_converge"] >= 1,
                f"converge {name}: {e}")
    log(f"  quality sections {time.perf_counter() - t0:.1f} s")
    return {"harness": payload, "parity": parity, "converge": converge,
            "checkpoint": check_sharded_checkpoint(torch, dev)}


def check_sharded_checkpoint(torch, dev) -> dict:
    """checkpoint.save_checkpoint_sharded and load_checkpoint_sharded on the
    card, one process: the state of a one-iteration virtual-R run_harmony
    on the main shape's cells, saved and loaded back (every field of the JAX state and
    the generator bit for bit against the state with R materialised, the
    virtual-R context kept), timed; then one more round from the loaded
    state."""
    import shutil

    from harmony_tpu_torch import checkpoint, engine, run_harmony
    from harmony_tpu_torch.state import ARRAY_FIELDS, VIRTUAL_FIELDS

    Zs, bs = synthetic(torch, N_MAIN, D_MAIN, B_MAIN, 7, dev)
    res = run_harmony(Zs.cpu().numpy(), {"batch": bs.cpu().numpy()}, ["batch"], max_iter=1,
                      early_stop=False, return_object=True, seed=0, virtual_r=True)
    del Zs
    cfg, st = res.config, res.state
    require(st.virt_pen is not None, "checkpoint: the run did not take virtual R")
    path = os.path.join(OUT_DIR, "ck_sharded")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    checkpoint.save_checkpoint_sharded(path, cfg, st)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg2, back = checkpoint.load_checkpoint_sharded(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    # room for the round after the load
    cfg3, more = checkpoint.load_checkpoint_sharded(path, extra_rounds=1)
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    want = engine.materialize_r(cfg, st)

    def same(a, b):
        if not isinstance(a, torch.Tensor):
            return a == b
        return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
                and bool(torch.equal(a, b)))

    fields = [f for f in ARRAY_FIELDS if f != "key"]
    bad = [f for f in fields if not same(getattr(back, f), getattr(want, f))]
    bad += [f for f in VIRTUAL_FIELDS if not same(getattr(back, f), getattr(st, f))]
    gen = bool(torch.equal(back.generator.get_state(), st.generator.get_state()))
    log(f"checkpoint: save_checkpoint_sharded of the {N_MAIN} x {D_MAIN} virtual-R state "
        f"{save_s:.3f} s, load {load_s:.3f} s, {size / 2**20:.1f} MiB; config equal "
        f"{cfg2 == cfg}; fields that differ {bad}; generator equal {gen}")
    require(cfg2 == cfg and not bad and gen, f"the sharded checkpoint's round trip: {bad}")
    layout = engine.mstep_layout(cfg3, more.codes.cpu().numpy(), dev)
    nxt = engine.materialize_r(cfg3, engine.harmony_round(cfg3, more, layout=layout))
    require(bool(torch.isfinite(nxt.Z_corr).all()) and nxt.n_rounds == st.n_rounds + 1,
            "checkpoint: the round after the load")
    shutil.rmtree(path, ignore_errors=True)
    return {"save_s": save_s, "load_s": load_s, "bytes": size}


def run_segment_path(torch, dev, wrappers, path, n, schedule):
    """run_harmony on n x 50 cells in 40 batches with shuffle_mode left at
    its default: no batch-tiled layout exists at this N and B, so the
    M-step is the segmented one. Launch counts are set to 0 right before
    the call and read right after it. Returns the launches."""
    import numpy as np

    from harmony_tpu_torch import engine, run_harmony

    Zs, bs = synthetic(torch, n, D_MAIN, B_SEGMENT, 7, dev)
    sep0 = separation(torch, Zs.t(), bs, B_SEGMENT)
    Zh, meta = Zs.cpu().numpy(), {"batch": bs.cpu().numpy()}
    del Zs
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = run_harmony(Zh, meta, ["batch"], max_iter=MAX_ITER, return_object=True, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    cfg = res.config
    layout = engine.mstep_layout(cfg, res.design.codes, dev)
    ph = res.phase_seconds()
    n_it = int(res.state.n_rounds)
    per_it = iter_seconds(ph, n_it)
    log(f"{path} path: run_harmony {n} x {D_MAIN}, K={res.K}, B={res.B}, {cfg.shuffle_mode} "
        f"(route {cfg.rotate_route!r}, fused={cfg.permute_fused}, Np={cfg.Np}), segmented "
        f"M-step: {len(layout.segments or ())} covariate layout(s) of "
        f"{[s.n_tiles for s in layout.segments or ()]} tiles of {cfg.segment_tile} cells; "
        f"{n_it} iterations, wall {wall:.2f} s")
    log("  phase seconds: " + json.dumps({k: round(v, 4) for k, v in ph.items()}))
    log(f"  seconds per Harmony iteration {per_it:.4f}; {n / per_it:,.0f} cells/s per "
        f"iteration; objective {[round(float(x), 3) for x in res.objective_harmony]}")
    log(f"  launches: {launches}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
        "(torch.cuda.max_memory_allocated over the call)")
    require(cfg.shuffle_mode == schedule, f"{path}: resolved shuffle_mode={cfg.shuffle_mode!r}")
    require(not cfg.permute_fused, f"{path}: resolved the fused permute phase")
    require(layout.tiled is None and layout.segments is not None,
            f"{path}: the M-step layout is not the segmented one")
    emb = res.embeddings
    require(emb.shape == (n, D_MAIN) and np.isfinite(emb).all(),
            f"{path}: embeddings not finite or of the wrong shape")
    dev_r = float(np.abs(res.R.sum(0) - 1).max())
    sep1 = separation(torch, torch.as_tensor(res.Z_corr, device=dev),
                      torch.as_tensor(meta["batch"], device=dev), B_SEGMENT)
    log(f"  R column sums within {dev_r:.2e} of 1; batch-centroid separation "
        f"{sep0:.4f} -> {sep1:.4f}")
    require(dev_r <= 1e-4, f"{path}: R column sums off by {dev_r}")
    require(sep1 < sep0, f"{path}: batch-centroid separation did not shrink")
    if path == "segment":
        profile_round(torch, res, "profile_round_segment.txt", layout)
    return launches


def held_to(torch, what, a, b, rtol, obj_rtol=None):
    """Hold result ``a`` (bf16) to ``b`` (float32) of the same data and
    initial centroids: Z_corr's relative Frobenius error at ``rtol``; the
    objective trace from the first correction on, entry by entry, within
    ``rtol`` of the trace's scale (its largest magnitude), and its last
    entry within ``rtol`` of itself (``obj_rtol`` in place of ``rtol`` for
    the objective where given). The entries before the first correction
    (the initial clustering's and the first phase's) are logged, not held:
    they are sums of terms two orders larger that cancel near 0, whose
    distance term carries, in a bf16 engine, the renormalisation of bf16
    vectors (squared norms rounded on bf16's grid near 1; the JAX package's
    bf16 engine gives the same values). Returns (Z_corr rel, the held
    entries' largest difference over the scale, the last entry's rel)."""
    import numpy as np

    obj_rtol = obj_rtol or rtol
    ta, tb = np.asarray(a.objective_harmony, np.float64), np.asarray(b.objective_harmony,
                                                                    np.float64)
    require(len(ta) == len(tb) >= 3, f"{what}: {len(ta)} and {len(tb)} objective entries")
    scale = float(np.abs(tb).max())
    d = np.abs(ta - tb) / scale
    last = float(abs(ta[-1] - tb[-1]) / abs(tb[-1]))
    za = torch.as_tensor(a.Z_corr).double()
    zb = torch.as_tensor(b.Z_corr).double()
    zrel = float(torch.linalg.norm(za - zb) / torch.linalg.norm(zb))
    log(f"  {what}: Z_corr relative Frobenius error {zrel:.3e}; objective entries from the "
        f"first correction on within {float(d[2:].max()):.3e} of the trace's scale "
        f"{scale:.4g}, the last within {last:.3e} of itself (rtol {obj_rtol}; Z_corr "
        f"{rtol}); the two before "
        f"it {float(d[0]):.3e} and {float(d[1]):.3e} of the scale (not held); "
        f"{[round(float(x), 4) for x in ta]} against {[round(float(x), 4) for x in tb]}")
    require(zrel <= rtol, f"{what}: Z_corr rel {zrel}")
    require(float(d[2:].max()) <= obj_rtol and last <= obj_rtol,
            f"{what}: objective entries {float(d[2:].max())} of the scale, last {last}")
    return zrel, float(d[2:].max()), last


def initial_centroids(torch, Zs, K, seed):
    """K centroids by the port's k-means seeding on the L2-normalised cells,
    on the card from a seeded generator: the initial centroids two runs in
    different dtypes share (each dtype's own seeding picks other cells)."""
    from harmony_tpu_torch import ops

    g = torch.Generator(device=Zs.device)
    g.manual_seed(seed)
    X = ops.l2_normalize_columns(Zs.t().contiguous())
    return ops.kmeans_centers(X, K, generator=g).cpu().numpy()


BF16_HELD_RTOL = 2e-2  # Z_corr and objective of a bf16 run against float32 (held_to)
# the cell-granular route's objective: its rounds read the state's Z_corr,
# renormalised in bf16 at each re-entry, and round R, E and O to bf16 every
# round at 2,000 cells, K = 67 (measured 2.9e-2 of the trace's scale)
BF16_CELL_OBJ_RTOL = 5e-2
BF16_HELD_ITERS = 5  # iterations of the held pair (early stop off)


def run_reduced_path(torch, dev, wrappers, phase, n, B, held_f32):
    """run_harmony(..., dtype=) on the canonical synthetic cells (n x 50, B
    batches, seed 7), in bfloat16 (phases 'bf16', 'bf16_10m') or float16
    ('f16'), everything else at its default: rotate, the stats carry,
    virtual R, and the bf16 product form of K6, K10 and K11 (the resolved
    'bfloat16'). Launch counts are set to 0 right before the call and read
    right after it. Required: K6 and K10 once an iteration, K11 once, K7,
    no K8 or K9; storage and R in the engine dtype; R's column sums within
    1e-2 of 1; finite embeddings; the batch-centroid separation shrinks.
    At the main shape (phases 'bf16', 'f16') the run is also held to a
    float32 virtual run: both from the same initial centroids, early stop
    off, BF16_HELD_ITERS iterations, Z_corr and the objective at
    BF16_HELD_RTOL (held_to), made once and kept in ``held_f32`` ({(n, B):
    its objective trace and Z_corr on the host}). Returns (launches,
    objective trace, iterations)."""
    import numpy as np

    from harmony_tpu_torch import engine, run_harmony
    from harmony_tpu_torch.config import default_nclust

    name = "float16" if phase == "f16" else "bfloat16"
    held_phase = phase in ("bf16", "f16")
    Zs, bs = synthetic(torch, n, D_MAIN, B, 7, dev)
    sep0 = separation(torch, Zs.t(), bs, B)
    Y0 = initial_centroids(torch, Zs, default_nclust(n), 5) if held_phase else None
    Zh, meta = Zs.cpu().numpy(), {"batch": bs.cpu().numpy()}
    del Zs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    res = run_harmony(Zh, meta, ["batch"], max_iter=MAX_ITER, return_object=True, seed=0,
                      dtype=name)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    cfg, st = res.config, res.state
    ph = res.phase_seconds()
    n_it = int(st.n_rounds)
    per_it = iter_seconds(ph, n_it)
    log(f"{phase} path: run_harmony {n} x {D_MAIN}, K={res.K}, B={res.B}, dtype "
        f"{cfg.dtype}, matmul_precision {cfg.matmul_precision!r}, {cfg.shuffle_mode} (route "
        f"{cfg.rotate_route!r}, virtual R {st.virt_pen is not None}, T={cfg.estep_sub_tile}, "
        f"Np={cfg.Np}), max_iter={MAX_ITER}: {n_it} iterations, wall {wall:.2f} s")
    log("  phase seconds: " + json.dumps({k: round(v, 4) for k, v in ph.items()}))
    log(f"  ingest (streamed, stream_ingest='auto'): {_ingest_split(ph)}")
    log(f"  seconds per Harmony iteration {per_it:.4f}; {n / per_it:,.0f} cells/s per "
        f"iteration; materialize_r {ph.get('materialize_r', 0.0):.4f} s")
    trace = [float(x) for x in res.objective_harmony]
    log(f"  kmeans rounds {res.kmeans_rounds.tolist()}; objective {[round(x, 3) for x in trace]}")
    log(f"  launches: {launches}")
    beside = (f"; the float32 virtual path's in this run {PEAKS['virtual']:.1f} MiB"
              if "virtual" in PEAKS else "")
    log(f"  peak device memory {peak:.1f} MiB (torch.cuda.max_memory_allocated over the "
        f"call){beside}")
    PEAKS[phase] = peak
    bf = getattr(torch, name)
    require((cfg.shuffle_mode, cfg.rotate_route, cfg.dtype, cfg.matmul_precision,
             cfg.bf16_products) == ("rotate", "carry", name, "bfloat16", True),
            f"{phase}: resolved {cfg.shuffle_mode}, {cfg.rotate_route}, {cfg.dtype}, "
            f"{cfg.matmul_precision}, bf16 products {cfg.bf16_products}")
    require(st.virt_pen is not None, f"{phase}: virtual R did not engage")
    require(st.Z_orig.dtype == st.Z_corr.dtype == st.R.dtype == st.Y.dtype == bf,
            f"{phase}: the state is not stored in {name}")
    require(launches["K6"] == n_it and launches["K10"] == n_it and launches["K11"] == 1,
            f"{phase}: K6 {launches['K6']}, K10 {launches['K10']} launches for {n_it} "
            f"iterations, K11 {launches['K11']}")
    emb = res.embeddings
    require(emb.shape == (n, D_MAIN) and np.isfinite(emb).all(),
            f"{phase}: embeddings not finite or of the wrong shape")
    dev_r = float(np.abs(res.R.astype(np.float64).sum(0) - 1).max())
    sep1 = separation(torch, torch.as_tensor(res.Z_corr, device=dev),
                      torch.as_tensor(meta["batch"], device=dev), B)
    log(f"  R ({name}) column sums within {dev_r:.2e} of 1; batch-centroid separation "
        f"{sep0:.4f} -> {sep1:.4f}")
    require(dev_r <= 1e-2, f"{phase}: R column sums off by {dev_r}")
    require(sep1 < sep0, f"{phase}: batch-centroid separation did not shrink")
    profile_round(torch, res, f"profile_round_{phase}.txt",
                  engine.mstep_layout(cfg, res.design.codes, dev))
    if held_phase:
        held = {}
        for dt in ("float32", name):
            if dt == "float32" and (n, B) in held_f32:
                held[dt] = held_f32[(n, B)]
                continue
            held[dt] = run_harmony(Zh, meta, ["batch"], max_iter=BF16_HELD_ITERS,
                                   early_stop=False, return_object=True, seed=0, dtype=dt,
                                   shuffle_mode="rotate", virtual_r=True, init_Y=Y0)
            require(held[dt].state.virt_pen is not None, f"{phase}: held {dt} run not virtual")
        # the host arrays held_to reads, so no device state outlives the phase
        held_f32[(n, B)] = types.SimpleNamespace(
            objective_harmony=np.asarray(held["float32"].objective_harmony),
            Z_corr=np.asarray(held["float32"].Z_corr))
        held_to(torch, f"{phase} against float32 virtual R, the same initial centroids, "
                f"{BF16_HELD_ITERS} iterations", held[name], held["float32"],
                BF16_HELD_RTOL)
    else:
        # the float32 engine on the same cells, virtual R as the bf16 one,
        # for its iterations, time and memory beside them (nothing held)
        capture_s = engine.run_rounds.capture_s if cfg.graph_route else 0.0
        del res, st  # the first run's state is not in the next runs' peaks
        # the same bf16 call again (the graph route: its capture cached),
        # then through the per-round host loop (verbose: the driver takes
        # it, as the JAX package's does), the captures dropped first: the
        # same bits, and each one's time and peak
        legs = {}
        for leg, kw in (("graph, cached", {}), ("host loop (verbose)", {"verbose": True})):
            if kw:
                engine.clear_graphs()
                torch.cuda.empty_cache()
            _reset_peak(torch)
            caps = engine.run_rounds.captures
            t0 = time.perf_counter()
            rl = run_harmony(Zh, meta, ["batch"], max_iter=MAX_ITER, return_object=True,
                             seed=0, dtype=name, **kw)
            torch.cuda.synchronize()
            wall_l, phl, nl = time.perf_counter() - t0, rl.phase_seconds(), int(rl.state.n_rounds)
            require(("run_rounds" in phl) == (not kw) and engine.run_rounds.captures == caps,
                    f"{phase} ({leg}): the run took the wrong loop, or captured")
            same = (nl == n_it and [float(x) for x in rl.objective_harmony] == trace
                    and np.array_equal(rl.embeddings, emb))
            legs[leg] = iter_seconds(phl, nl)
            log(f"  {leg} beside it: {nl} iterations, wall {wall_l:.2f} s, seconds per Harmony "
                f"iteration {legs[leg]:.4f}, peak {_peak_mib(torch):.1f} MiB; bit-equal to the "
                f"first run: {same}")
            require(same, f"{phase} ({leg}): the run differs from the first run")
            del rl
        log(f"  seconds per Harmony iteration: the graph route's first run {per_it:.4f} (its "
            f"capture {capture_s:.3f} s included; peak {peak:.1f} MiB), cached "
            f"{legs['graph, cached']:.4f}, the host loop {legs['host loop (verbose)']:.4f}")
        del emb
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r32 = run_harmony(Zh, meta, ["batch"], max_iter=MAX_ITER, return_object=True, seed=0,
                          virtual_r=True)
        torch.cuda.synchronize()
        ph32 = r32.phase_seconds()
        n32 = int(r32.state.n_rounds)
        log(f"  float32 beside it, virtual R: {n32} iterations, wall "
            f"{time.perf_counter() - t0:.2f} s, seconds per Harmony iteration "
            f"{iter_seconds(ph32, n32):.4f}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
            f"phase seconds {json.dumps({k: round(v, 4) for k, v in ph32.items()})}; objective "
            f"{[round(float(x), 3) for x in r32.objective_harmony]}")
        # the same bf16 call with the copy finished before the ingest order
        # is built (no overlap), one iteration: the ingest beside the
        # overlapped one above
        del r32
        _reset_peak(torch)
        t0 = time.perf_counter()
        rh = run_harmony(Zh, meta, ["batch"], max_iter=1, return_object=True, seed=0,
                         dtype="bfloat16", stream_ingest=False)
        torch.cuda.synchronize()
        log(f"  bf16 with stream_ingest=False, one iteration: wall "
            f"{time.perf_counter() - t0:.2f} s, peak {_peak_mib(torch):.1f} MiB; ingest "
            f"{_ingest_split(rh.phase_seconds())}")
    return launches, trace, n_it


# the other routes of a bf16 engine: (route, cells, config changes, kernels
# that must run, kernels that must not)
BF16_ROUTES = (
    ("permute", 20_000, {"shuffle_mode": "permute"}, ("K1",), ("K2", "K6", "K7")),
    ("permute_fused", 20_000, {"shuffle_mode": "permute", "permute_fused": True},
     ("K2", "K3"), ("K1", "K6", "K7")),
    ("rotate_written", 20_000, {"virtual_r": False}, ("K6", "K7"), ("K10", "K11", "K12")),
    ("rotate_two_phase", 20_000, {"rotate_stats_carry": False}, ("K12",), ("K6", "K7")),
    ("rotate_cell", 2_000, {}, (), ("K6", "K7", "K12")),
)
BF16_ROUTE_ITERS = 4


# the graph phase's cells: (cell, schedule, config changes, data): the data
# is (cells, the levels of each covariate) of a seeded synthetic set at
# D_MAIN dims (graph_data), or "pbmc", the vendored pbmc_ctrl/pbmc_stim
# counts through datasets.pbmc_dataset (2,000 cells, 20 PCs, one covariate
# of 2 levels; run_harmony's 'auto' schedule there is 'permute')
_MAIN_DATA = (N_MAIN, (B_MAIN,))
GRAPH_CELLS = (("rotate-500k", "rotate", {}, _MAIN_DATA),
               ("rotate-virtual-500k", "rotate", {"virtual_r": True}, _MAIN_DATA),
               ("rotate-virtual-bf16-500k", "rotate", {"dtype": "bfloat16"}, _MAIN_DATA),
               ("rotate-virtual-f16-500k", "rotate", {"dtype": "float16"}, _MAIN_DATA),
               ("permute-500k", "permute", {}, _MAIN_DATA),
               # the per-round routes: the carry route past the default budget,
               # K12, K1 (the default below 100k cells)
               ("permute-rounds-500k", "permute", {"max_iter_cluster": 10}, _MAIN_DATA),
               ("rotate-rounds-500k", "rotate", {"max_iter_cluster": 10}, _MAIN_DATA),
               ("rotate-two-phase-500k", "rotate", {"rotate_stats_carry": False}, _MAIN_DATA),
               ("permute-rounds-50k", "permute", {}, (50_000, (B_MAIN,))),
               ("multicov-50k", "permute", {}, (50_000, (10, 8, 4))),
               ("pbmc-stim", "permute", {}, "pbmc"),
               # the cell-granular rotate round (below n_blocks * 128 cells):
               # its schedule table read on the device, K4/K5 the M-step; at
               # 2,500 cells, the route's full width, its phases reach the
               # guarded rounds
               ("rotate-cell-pbmc-stim", "rotate", {}, "pbmc"),
               ("rotate-cell-2500", "rotate", {"max_iter_cluster": 10, "epsilon_cluster": 1e-3},
                (2_500, (B_MAIN,))),
               ("segment-permute-80k", "permute", {}, (80_000, (B_SEGMENT,))),
               ("rotate-multicov-500k", "rotate", {}, (N_MAIN, (10, 4))))
# the cells whose phases the windowed early stop may end before
# max_iter_cluster rounds: at least one phase across them must stop early
GRAPH_EARLY_STOP = ("permute-rounds-500k", "rotate-rounds-500k", "rotate-cell-2500")
# each route's body kernel, launched in every iteration that runs
_BODY_KERNEL = {"fused": "head_kernel", "k1": "block_stats_kernel",
                "carry": "reassign_assign_kernel", "two_phase": "old_stats_kernel",
                "cell": "moments_kernel"}
# the runtime calls that launch work on the card, counted on the host
_API_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def graph_setup(torch, dev, Zh, meta, shuffle, change):
    """run_harmony's steps up to init_cluster (multihost_worker.driver_result's
    config, ingest order, M-step layout and state) on the card: (cfg,
    layout, the initialised state)."""
    import dataclasses

    from harmony_tpu_torch import engine
    from harmony_tpu_torch.api import apply_ingest_order, ingest_perm
    from harmony_tpu_torch.config import finalize_engine_config, harmony_options
    from harmony_tpu_torch.preprocess import (build_design, expand_hyperparams,
                                              orient_embedding, resolve_config)
    from harmony_tpu_torch.runtime import AsyncIngest
    from harmony_tpu_torch.state import init_state

    change = dict(change)
    design = build_design(meta, list(meta))
    n = design.n_cells
    Zt = orient_embedding(Zh, n)
    options = harmony_options()
    cfg = resolve_config(
        n_cells=n, d=Zt.shape[0], design=design, nclust=None, max_iter=MAX_ITER,
        early_stop=True, options=options, verbose=False, lambda_estimation=True,
        ridge_solver="auto", shuffle_mode=shuffle, dtype=change.pop("dtype", "float32"))
    cfg = finalize_engine_config(dataclasses.replace(cfg, **change))
    perm, _ = ingest_perm(cfg, design, 0)
    _, design, _ = apply_ingest_order(design, perm)
    layout = engine.mstep_layout(cfg, design.codes, dev)
    hp = expand_hyperparams(design, cfg.K, None, 0.1, None, options.tau)
    state = init_state(cfg, AsyncIngest(Zt, cfg, dev).result(perm), design, hp.sigma,
                       hp.theta, hp.lamb, 0, dev)
    return cfg, layout, engine.init_cluster(cfg, state)


def graph_data(torch, dev, data, seed=7):
    """A graph cell's (Z (N, d) host array, metadata): ``data`` is "pbmc"
    or (cells, levels of each covariate): synthetic() for the first
    covariate (named as BASELINE's multi-covariate design: dataset, donor,
    batch_id), each further one a seeded code with an offset of its own."""
    import numpy as np

    if data == "pbmc":
        from harmony_tpu_torch.datasets import pbmc_dataset

        ds = pbmc_dataset()
        return np.asarray(ds.scaled_pcs, np.float32), dict(ds.meta_data)
    n, levels = data
    Zs, bs = synthetic(torch, n, D_MAIN, levels[0], seed, dev)
    meta = {"dataset": bs.cpu().numpy()}
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    for name, b in zip(("donor", "batch_id"), levels[1:]):
        codes = torch.randint(0, b, (n,), generator=g, device=dev)
        Zs += (torch.randn(b, D_MAIN, generator=g, device=dev) * 0.5)[codes]
        meta[name] = codes.cpu().numpy()
    return Zs.cpu().numpy(), meta


def host_reads(torch, fn):
    """``fn()``'s result and the synchronising CUDA calls it made (the host
    reads), counted with torch.cuda's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's first use also warns that it is a prototype)
    return out, sum(str(w.message).startswith("called a synchronizing") for w in caught)


def fork(torch, state):
    """A copy of the state with its own tensors and a generator at the same
    state: each leg starts from the same bits and the same draws."""
    import dataclasses

    g = torch.Generator(device=state.device)
    g.set_state(state.generator.get_state())
    kw = {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
          if isinstance(getattr(state, f.name), torch.Tensor)}
    return dataclasses.replace(state, **kw, generator=g)


def host_loop(cfg, state, layout, n=MAX_ITER):
    """The per-round host loop (driver.harmonize's loop): up to ``n``
    iterations of harmony_round, then one read of the convergence flag."""
    from harmony_tpu_torch import engine

    for _ in range(n):
        state = engine.harmony_round(cfg, state, layout=layout)
        if engine.harmony_converged(cfg, state):
            break
    return state


def profile_run(torch, fn, n_it, kernel):
    """One call of ``fn`` under torch.profiler: the runtime launch calls a
    Harmony iteration (``n_it`` iterations), the device's idle share of the
    call's wall, and the launches of the kernel ``kernel`` (the body's, one
    an iteration) and of the IF node's predicate kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    api, busy, body, pred = 0, 0.0, 0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key in _API_LAUNCHES:
                api += e.count
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        busy += dt / 1e3
        if kernel in e.key:
            body += e.count
        if "set_if_kernel" in e.key:
            pred += e.count
    return {"api_launches_per_iter": api / n_it, "busy_ms_per_iter": busy / n_it,
            "wall_ms_per_iter": wall * 1e3 / n_it,
            "idle_share": max(0.0, 1 - busy / (wall * 1e3)), "body_launches": body,
            "predicate_launches": pred}


def check_graph(torch, dev, wrappers):
    """The one-dispatch run (engine.run_rounds: one captured iteration in IF
    nodes, its guarded regions (the re-entry, the rounds the windowed early
    stop may skip) in IF nodes of their own on device flags, replayed an
    iteration) at full width, in each of GRAPH_CELLS, from one initial
    state and generator state: (a) the eager host loop, (b)
    driver.harmonize taking run_rounds, (c) the same with an abort flag
    never set and abort_poll_rounds=1. The three are held equal bit for bit
    (Z_corr, R after materialize_r, Y, the traces, kmeans_rounds, the
    iterations). Per cell: seconds an iteration of (a) and of (b) (a second
    run, the graph cached) by CUDA events, the capture's seconds, the
    iterations each call of (b) ran eagerly (the capture's warm-up only:
    none on a cached call) and the host reads of a cached call (one), the
    runtime launch calls an iteration and each leg's idle share under
    torch.profiler, the peak memory of (a) and of (b)'s first run (its
    capture and static buffers) and second, that the second run captures
    nothing, that the replays after convergence launch no body kernel, and
    that the wrappers count the same launches in (a) and (b). Across
    GRAPH_EARLY_STOP's cells a phase must stop before max_iter_cluster
    rounds. Returns {cell: launches of (b)'s second run}."""
    import dataclasses

    import numpy as np

    from harmony_tpu_torch import driver, engine
    from harmony_tpu_torch.runtime import AbortFlag

    out, report, data_of, early = {}, {}, {}, []

    def events_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        r = fn()
        b.record()
        torch.cuda.synchronize()
        return r, a.elapsed_time(b)

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    for cell, shuffle, change, data in GRAPH_CELLS:
        if data not in data_of:
            data_of.clear()  # one set at a time: the cells are grouped by set
            data_of[data] = graph_data(torch, dev, data)
        Zh, meta = data_of[data]
        cfg, layout, s0 = graph_setup(torch, dev, Zh, meta, shuffle, change)
        require(cfg.graph_route, f"graph {cell}: the config is off the graph route")
        route = ("fused" if cfg.permute_fused else "k1" if shuffle == "permute"
                 else cfg.rotate_route)
        kernel = _BODY_KERNEL[route]
        n0 = s0.n_rounds
        # (a) the eager host loop, once to warm up, then timed
        host_loop(cfg, fork(torch, s0), layout)
        _reset_peak(torch)
        zero()
        sa = fork(torch, s0)
        a_state, a_ms = events_ms(lambda: host_loop(cfg, sa, layout))
        a_launches, a_peak = counts(), _peak_mib(torch)
        n_it = a_state.n_rounds - n0
        ref = engine.materialize_r(cfg, a_state)
        # (b) driver.harmonize through run_rounds: the first run captures
        _reset_peak(torch)
        caps = engine.run_rounds.captures
        t0 = time.perf_counter()
        b = driver.harmonize(cfg, fork(torch, s0), layout=layout)
        torch.cuda.synchronize()
        b_first_s = time.perf_counter() - t0
        b_peak_first = _peak_mib(torch)
        captured = engine.run_rounds.captures - caps
        capture_s = engine.run_rounds.capture_s
        eager_first = engine.run_rounds.eager
        # (b) again at the same shape: a cache hit, timed (the loop alone)
        _reset_peak(torch)
        zero()
        caps = engine.run_rounds.captures
        sb = fork(torch, s0)
        b2, b_ms = events_ms(lambda: engine.run_rounds(cfg, sb, MAX_ITER, layout))
        b_launches, b_peak = counts(), _peak_mib(torch)
        eager_cached = engine.run_rounds.eager
        require(engine.run_rounds.captures == caps,
                f"graph {cell}: a second run at the same shape captured again")
        require(eager_cached == 0, f"graph {cell}: a cached call ran {eager_cached} "
                "iteration(s) eagerly")
        sr = fork(torch, s0)
        torch.cuda.synchronize()
        reads = host_reads(torch, lambda: engine.run_rounds(cfg, sr, MAX_ITER, layout))[1]
        require(reads == 1, f"graph {cell}: a cached call made {reads} host reads, not one")
        rounds = [int(x) for x in b2.kmeans_rounds[:b2.n_rounds].tolist()]
        if cell in GRAPH_EARLY_STOP:
            early += [r for r in rounds if r < cfg.max_iter_cluster]

        def least_ms(n_budget, calls=3):
            # the least of a few calls' event times: a call is host-bound,
            # and one that the host stalls reads milliseconds more
            best = []
            for _ in range(calls):
                st = fork(torch, s0)
                best.append(events_ms(lambda: engine.run_rounds(cfg, st, n_budget, layout))[1])
            return min(best)

        # the call with the budget the run needs against the full budget:
        # the difference is the cost of the replays after convergence
        b_ms = min(b_ms, least_ms(MAX_ITER))
        b_exact_ms = least_ms(n_it)
        # steady state, without the early stop: two calls of 2 and 8
        # iterations in each leg, the difference over 6 (a call's fixed
        # costs, the copies in and out and the last read, cancel)
        cfg_ne = dataclasses.replace(cfg, epsilon_harmony=-np.inf)
        steady = {}
        for leg, fn in (("eager", lambda k, st: host_loop(cfg_ne, st, layout, k)),
                        ("graph", lambda k, st: engine.run_rounds(cfg_ne, st, k, layout))):
            fn(2, fork(torch, s0))  # warm (the graph leg captures here)
            t = {}
            for k in (2, 8):
                st = fork(torch, s0)
                t[k] = events_ms(lambda: fn(k, st))[1]
            steady[leg] = (t[8] - t[2]) / 6
        # (c) an abort flag never set, polled before every iteration
        c = driver.harmonize(cfg, fork(torch, s0), layout=layout, abort=AbortFlag(),
                             abort_poll_rounds=1)
        for name, st in (("b", b), ("c", c), ("b2", engine.materialize_r(cfg, b2))):
            require(st.n_rounds == ref.n_rounds and st.n_harmony == ref.n_harmony,
                    f"graph {cell} ({name}): {st.n_rounds - n0} iterations, the host loop "
                    f"{n_it}")
            for f in ("Z_corr", "R", "Y", "objective_kmeans", "objective_harmony",
                      "kmeans_rounds"):
                x, y = getattr(st, f), getattr(ref, f)
                err = float((x.float() - y.float()).abs().max())
                require(err == 0.0, f"graph {cell} ({name}): {f} differs from the host loop "
                        f"by {err}")
        require(a_launches == b_launches,
                f"graph {cell}: the replays count other launches than the host loop: "
                f"{b_launches} against {a_launches}")
        # the cell-granular round issues ~5,000 launches an iteration
        # eagerly, and the profiler's cost grows with its events: its eager
        # leg is profiled over one iteration
        n_prof = 1 if route == "cell" else n_it
        pa = profile_run(torch, lambda: host_loop(cfg, fork(torch, s0), layout, n_prof),
                         n_prof, kernel)
        pb = profile_run(torch, lambda: engine.run_rounds(cfg, fork(torch, s0), MAX_ITER, layout),
                         n_it, kernel)
        # the replays after convergence launch no body: the device busy time
        # of a call with the budget the run needs is the same but for their
        # predicate kernels and the replay prologue's fills (the profiler's
        # count of a graph's kernels by name is not reliable: it has read
        # 0 and twice the launches)
        px = profile_run(torch, lambda: engine.run_rounds(cfg, fork(torch, s0), n_it, layout),
                         n_it, kernel)
        idle_replay_busy = float("nan")  # a run that takes its whole budget has none
        if n_it < MAX_ITER:
            idle_replay_busy = ((pb["busy_ms_per_iter"] - px["busy_ms_per_iter"]) * n_it
                                / (MAX_ITER - n_it))
            # (a body would keep it busy an iteration's busy time; the
            # prologue's fills and the predicate kernels take ~0.1 ms)
            require(idle_replay_busy < 0.25 * px["busy_ms_per_iter"],
                    f"graph {cell}: a replay after convergence keeps the device busy "
                    f"{idle_replay_busy:.4f} ms of an iteration's "
                    f"{px['busy_ms_per_iter']:.3f}: it ran the body")
        inactive_ms = ((b_ms - b_exact_ms) / (MAX_ITER - n_it) if n_it < MAX_ITER
                       else float("nan"))
        row = {"route": route, "N": cfg.N, "B_vec": list(cfg.B_vec), "K": cfg.K,
               "max_iter_cluster": cfg.max_iter_cluster, "kmeans_rounds": rounds,
               "eager_iterations_first_call": eager_first,
               "eager_iterations_cached_call": eager_cached, "host_reads_cached_call": reads,
               "iterations": n_it, "replays": MAX_ITER, "eager_ms_per_iter": a_ms / n_it,
               "graph_ms_per_iter": b_ms / n_it, "graph_exact_budget_ms": b_exact_ms,
               "inactive_replay_ms": inactive_ms,
               "steady_eager_ms_per_iter": steady["eager"],
               "steady_graph_ms_per_iter": steady["graph"], "capture_s": capture_s,
               "first_run_s": b_first_s, "captures_first_run": captured,
               "captures_second_run": 0, "peak_mib_eager": a_peak,
               "peak_mib_graph_first": b_peak_first, "peak_mib_graph": b_peak,
               "eager_profile": pa, "graph_profile": pb, "graph_profile_exact_budget": px,
               "busy_ms_a_replay_after_convergence": idle_replay_busy,
               "objective_harmony": [float(x) for x in
                                     ref.objective_harmony[:ref.n_harmony].tolist()]}
        report[cell] = row
        log(f"graph {cell} ({route}, N={cfg.N}, B_vec={cfg.B_vec}, K={cfg.K}, "
            f"max_iter_cluster={cfg.max_iter_cluster}): {n_it} iterations of {MAX_ITER} (three "
            f"legs bit-equal), kmeans_rounds {rounds}; eager iterations {eager_first} in the "
            f"first call (the capture's warm-up), {eager_cached} in a cached call, which makes "
            f"{reads} host read(s); "
            f"eager {a_ms / n_it:.3f} ms an iteration, graph {b_ms / n_it:.3f} ms "
            f"({MAX_ITER} replays, the loop alone, the least of 4 calls; {b_exact_ms / n_it:.3f} "
            f"with a budget of "
            f"{n_it}, {inactive_ms:.4f} ms a replay after "
            f"convergence); steady state (no early stop, (T8 - T2) / 6) eager "
            f"{steady['eager']:.3f}, graph {steady['graph']:.3f} ms an iteration; "
            f"capture {capture_s:.3f} s, first run "
            f"{b_first_s:.3f} s wall, {captured} capture(s), none on the second run; "
            f"runtime launches an iteration {pa['api_launches_per_iter']:.1f} eager, "
            f"{pb['api_launches_per_iter']:.1f} graph; idle share {pa['idle_share']:.3f} "
            f"eager, {pb['idle_share']:.3f} graph (profiled: busy "
            f"{pa['busy_ms_per_iter']:.3f} / {pb['busy_ms_per_iter']:.3f} ms, wall "
            f"{pa['wall_ms_per_iter']:.3f} / {pb['wall_ms_per_iter']:.3f} ms an iteration); "
            f"device busy {idle_replay_busy:.4f} ms a replay after convergence (profiler "
            f"counts {kernel} {pb['body_launches']}x, set_if_kernel "
            f"{pb['predicate_launches']}x); "
            f"peak {a_peak:.1f} MiB eager, {b_peak_first:.1f} MiB graph's first run, "
            f"{b_peak:.1f} MiB cached")
        out[cell] = b_launches
        if cell == "rotate-500k":
            check_stamps(torch, dev, wrappers, (cfg, layout, s0))
        del s0, sa, sb, sr, st, a_state, ref, b, b2, c
        engine.clear_graphs()
        torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, "graph.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    if any(c in report for c in GRAPH_EARLY_STOP):
        log(f"graph: phases of {', '.join(GRAPH_EARLY_STOP)} that the window test stopped "
            f"before max_iter_cluster: {early}")
        require(early, "graph: no phase of the early-stop cells stopped before "
                "max_iter_cluster rounds")
    return out


def check_stamps(torch, dev, wrappers, setup=None):
    """The captured iteration's device stamps (engine.harmony_round: before
    cluster, between cluster and correct, after correct; stamp_kernel of
    csrc/graph.cu) on the rotate-500k graph route, in one cached
    run_rounds call under torch.profiler (``setup``: the graph phase's
    (cfg, layout, initial state) of the cell, its capture cached; None:
    made here): for each iteration run, the
    stamped cluster + correct against the device interval from the
    iteration's first to its last operation in the profiler's trace
    (within 2% or 20 us); the stamps monotone within each replay and from
    one to the next; K9's launches as graphs.count counted them in the
    replays (one an iteration) against the trace's instances; and the
    global timer's granularity, the greatest common divisor of the
    differences of 2,000 back-to-back stamps."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from harmony_tpu_torch import engine, graphs

    t_start = time.perf_counter()
    if setup is None:
        Zh, meta = graph_data(torch, dev, _MAIN_DATA)
        setup = graph_setup(torch, dev, Zh, meta, "rotate", {})
    cfg, layout, s0 = setup
    engine.run_rounds(cfg, fork(torch, s0), MAX_ITER, layout)  # captured, or cached
    entry = next(reversed(engine._graphs.values()))
    st, k9 = fork(torch, s0), wrappers["K9"]
    before = k9.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = engine.run_rounds(cfg, st, MAX_ITER, layout)
        torch.cuda.synchronize()
    n_run = out.n_harmony - s0.n_harmony
    stamps = entry.stamps[: 3 * n_run].tolist()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    ops = sorted(((e.get("name", ""), float(e["ts"]), float(e["dur"])) for e in events
                  if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda x: x[1])
    marks = [o for o in ops if "stamp_kernel" in o[0]]
    require(len(marks) == 3 * n_run, f"stamps: the trace holds {len(marks)} stamp kernels "
            f"for {n_run} iterations")
    k9_traced = sum("tiled_correction_kernel" in o[0] for o in ops)
    k9_counted = k9.launches - before
    require(k9_counted == k9_traced == n_run,
            f"stamps: K9 counted {k9_counted} in the replays, the trace {k9_traced}, "
            f"for {n_run} iterations")
    rows = []
    for i in range(n_run):
        s = stamps[3 * i:3 * i + 3]
        require(s[0] <= s[1] <= s[2] and (i == 0 or stamps[3 * i - 1] <= s[0]),
                f"stamps: iteration {i}'s stamps are not monotone: {s}")
        a, c = marks[3 * i], marks[3 * i + 2]
        inner = [o for o in ops if o[1] >= a[1] + a[2] and o[1] + o[2] <= c[1]
                 and "stamp_kernel" not in o[0]]
        traced_us = max(o[1] + o[2] for o in inner) - min(o[1] for o in inner)
        stamped_us = (s[2] - s[0]) * 1e-3
        rows.append({"cluster_us": (s[1] - s[0]) * 1e-3, "correct_us": (s[2] - s[1]) * 1e-3,
                     "stamped_us": stamped_us, "traced_us": traced_us,
                     "operations": len(inner)})
        require(abs(stamped_us - traced_us) <= max(0.02 * traced_us, 20.0),
                f"stamps: iteration {i} stamped {stamped_us:.1f} us, traced {traced_us:.1f} us")
    buf = torch.zeros(2000, dtype=torch.int64, device=dev)
    for i in range(buf.numel()):
        graphs.stamp(buf, i)
    steps = np.diff(np.asarray(buf.tolist(), dtype=np.int64))
    require((steps >= 0).all(), "stamps: back-to-back stamps went back in time")
    grain = int(np.gcd.reduce(steps[steps > 0])) if (steps > 0).any() else 0
    report = {"iterations": rows, "global_timer_gcd_ns": grain,
              "back_to_back_ns_min_median": [int(steps.min()), float(np.median(steps))],
              "k9_launches_counted": k9_counted, "k9_launches_traced": k9_traced,
              "seconds": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "stamps.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(f"stamps (rotate-500k, {n_run} iterations): stamped cluster + correct against the "
        f"trace's interval, us: " + ", ".join(f"{r['stamped_us']:.1f}/{r['traced_us']:.1f}"
                                            for r in rows)
        + f"; cluster us {[round(r['cluster_us'], 1) for r in rows]}, correct us "
        f"{[round(r['correct_us'], 1) for r in rows]}; K9 {k9_counted} counted, {k9_traced} "
        f"traced; global timer steps a multiple of {grain} ns (back to back min "
        f"{int(steps.min())} ns, median {float(np.median(steps)):.0f} ns); "
        f"{report['seconds']:.1f} s")
    del s0, st, out


def check_bf16_routes(torch, dev, wrappers):
    """Each other route of a bf16 engine once, through the config and the
    driver (run_harmony's ingest and solver), from the same initial
    centroids as its float32 run, early stop off: it must finish with
    finite output and a falling objective, launch its kernels (the float32
    ones, on float32 copies made at their wrappers), and be held to the
    float32 run at BF16_HELD_RTOL."""
    import numpy as np

    from harmony_tpu_torch.config import default_nclust

    for route, n, change, need, never in BF16_ROUTES:
        Zs, bs = synthetic(torch, n, D_MAIN, B_MAIN, 31, dev)
        Y0 = initial_centroids(torch, Zs, default_nclust(n), 6)
        Zh, meta = Zs.cpu().numpy(), {"batch": bs.cpu().numpy()}
        del Zs
        out = {}
        for dt in ("float32", "bfloat16"):
            for w in wrappers.values():
                w.launches = 0
            res = run_driver(Zh, meta, dev, Y0=Y0, dtype=dt, max_iter_harmony=BF16_ROUTE_ITERS,
                             epsilon_harmony=-np.inf, **change)
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrappers.items()}
            out[dt] = res
            cfg = res.config
            obj = [float(x) for x in res.objective_harmony]
            log(f"bf16 route {route}: {dt}, {n} x {D_MAIN}, K={cfg.K}, {cfg.shuffle_mode} "
                f"(route {cfg.rotate_route!r}, fused {cfg.permute_fused}, virtual R "
                f"{res.state.virt_pen is not None}): launches {launches}; objective "
                f"{[round(x, 3) for x in obj]}")
            require(np.isfinite(res.embeddings).all(), f"bf16 route {route} ({dt}): "
                    "embeddings not finite")
            require(obj[-1] < obj[0], f"bf16 route {route} ({dt}): the objective did not fall")
            require(res.state.virt_pen is None, f"bf16 route {route} ({dt}): virtual R")
            for k in need:
                require(launches[k] > 0, f"bf16 route {route} ({dt}): {k} not launched")
            for k in never:
                require(launches[k] == 0, f"bf16 route {route} ({dt}): {k} launched")
        require(out["bfloat16"].state.R.dtype == torch.bfloat16,
                f"bf16 route {route}: R is not bf16")
        held_to(torch, f"bf16 route {route} against float32", out["bfloat16"], out["float32"],
                BF16_HELD_RTOL, BF16_CELL_OBJ_RTOL if route == "rotate_cell" else None)


def _peak_mib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**20 if torch.cuda.is_available() else 0.0


def _reset_peak(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _ingest_split(ph: dict) -> str:
    """The ingest scopes of a run's phase seconds and their total: orient,
    order and stream beside ``ingest``, which encloses normalize."""
    keys = [k for k in ph if k.startswith("ingest")]
    total = sum(ph.get(k, 0.0) for k in ("ingest_orient", "ingest_order", "ingest_stream",
                                         "ingest"))
    return ", ".join(f"{k} {ph[k]:.4f}" for k in keys) + f"; total {total:.4f} s"


def check_host(torch, dev, wrappers, n=N_MAIN, d=D_MAIN, B=B_MAIN):
    """The host modules around the engine, on the main shape's cells (seed
    7, n x d, B batches, K = 100 by default): the harmony-torch CLI on .npy
    and .csv files (a run against run_harmony with the same arguments; a
    checkpointed two-round run resumed for one round against three rounds
    without early stop, 5e-4), the streamed copy overlapped and not
    (Z_orig bit-equal and equal to the caller's cells, Z_corr equal, the
    ingest's parts timed; the bf16 cast of the stream against the card's),
    an abort from a thread after
    round 1 of a checkpointing run (KeyboardInterrupt, then the checkpoint
    resumes), a trace of one round (the cluster and correct spans),
    run_bench at rotate, permute and rotate-virtual-bf16, and the bundled
    cell_lines dataset through run_harmony. Returns the CLI's launches."""
    import csv
    import dataclasses
    import glob
    import tempfile
    import threading

    import numpy as np

    from harmony_tpu_torch import (AbortFlag, bench, cli, datasets, engine, harmony_options,
                                   run_harmony)
    from harmony_tpu_torch.config import finalize_engine_config
    from harmony_tpu_torch.runtime import AsyncIngest, engine_cast, trace

    t_phase = time.perf_counter()
    Zs, bs = synthetic(torch, n, d, B, 7, dev)
    Zh = Zs.cpu().numpy()
    del Zs
    batches = np.array([f"b{x}" for x in bs.cpu().numpy()])
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = tmp_ctx.name
    emb, meta_csv = os.path.join(tmp, "emb.npy"), os.path.join(tmp, "meta.csv")
    np.save(emb, Zh)
    with open(meta_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["batch"])
        w.writerows([[b] for b in batches])
    meta = cli._load_meta(meta_csv)
    log(f"host: {n} x {d} cells (seed 7, {B} batches) written as .npy and .csv in "
        f"{time.perf_counter() - t_phase:.2f} s")

    def cli_run(out, *extra):
        return cli.main(["run", "--embeddings", emb, "--meta", meta_csv, "--vars", "batch",
                         "--out", os.path.join(tmp, out), *extra])

    # -- the CLI: a run, a checkpointed run and its resume --------------------
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    require(cli_run("full.npy", "--max-iter", "3") == 0, "harmony-torch run failed")
    ck = os.path.join(tmp, "ck.npz")
    require(cli_run("part.npy", "--max-iter", "2", "--checkpoint", ck) == 0,
            "harmony-torch run --checkpoint failed")
    with np.load(ck) as z:
        rounds_at_save = int(z["n_rounds"])
    require(cli_run("resumed.npy", "--max-iter", "1", "--checkpoint", ck) == 0,
            "harmony-torch resume failed")
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"  CLI: run (3 rounds), run with --checkpoint (2 rounds), resume (1 round): "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    for k in ("K6", "K7", "K9"):
        require(launches[k] > 0, f"host: {k} was not launched by the CLI runs")
    require(launches["LL"] == 2 * LL_RUN, f"host: {launches['LL']} Lloyd launches by the CLI "
            f"runs, not {2 * LL_RUN} (two k-means inits; the resume runs none)")
    require(rounds_at_save == 2, f"host: the checkpoint holds {rounds_at_save} rounds, not 2")
    lib = run_harmony(Zh, meta, ["batch"], max_iter=3, seed=0, options=harmony_options())
    cli_out = np.load(os.path.join(tmp, "full.npy"))
    diff = float(np.abs(cli_out - lib).max())
    log(f"  CLI against run_harmony with the same arguments: max |diff| {diff:.3e} (<= 1e-6)")
    require(diff <= 1e-6, f"host: CLI output differs from run_harmony by {diff}")
    straight = run_harmony(Zh, meta, ["batch"], max_iter=3, seed=0, early_stop=False,
                           return_object=True)
    resumed = np.load(os.path.join(tmp, "resumed.npy"))
    diff = float(np.abs(resumed - straight.embeddings).max())
    log(f"  resumed (2 + 1 rounds) against 3 rounds without early stop: max |diff| "
        f"{diff:.3e} (<= 5e-4); the uninterrupted CLI run against it "
        f"{float(np.abs(cli_out - straight.embeddings).max()):.3e}")
    require(diff <= 5e-4, f"host: resumed output differs from the uninterrupted run by {diff}")
    require(np.isfinite(resumed).all() and resumed.shape == (n, d), "host: resumed output")

    # -- the copy overlapped (True) and not (False), against the host path -------
    seen = {}
    for mode in (False, True, False, True):
        _reset_peak(torch)
        t0 = time.perf_counter()
        res = run_harmony(Zh, meta, ["batch"], max_iter=3, seed=0, return_object=True,
                          stream_ingest=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ph = res.phase_seconds()
        log(f"  stream_ingest={mode}: wall {wall:.3f} s, peak {_peak_mib(torch):.1f} MiB; "
            f"ingest {_ingest_split(ph)}")
        seen[mode] = (res.state.Z_orig.cpu(), res.Z_corr)
        # the plain host path: the caller's cells, in their order, unpadded
        require(np.array_equal(res.Z_orig, Zh.T) and not res.state.Z_orig[:, n:].any(),
                f"host: stream_ingest={mode}: Z_orig is not the caller's cells")
        del res  # the next run's peak is its own
    (z_host, c_host), (z_streamed, c_streamed) = seen[False], seen[True]
    require(torch.equal(z_host, z_streamed),
            "host: overlapped Z_orig is not bit-equal to the unoverlapped one")
    zc = float(np.abs(c_streamed - c_host).max())
    log(f"  overlapped against not: Z_orig bit-equal, and equal to the caller's cells "
        f"undone from the ingest order; Z_corr max |diff| {zc:.3e} (0 required)")
    require(zc == 0.0, f"host: overlapped Z_corr differs by {zc}")
    del seen, z_host, z_streamed, c_host, c_streamed
    # the bf16 cast on the host (stream) against the one on the card, float64
    # and float32 inputs
    cfg = finalize_engine_config(dataclasses.replace(straight.config, dtype="bfloat16"))
    for src in (Zh.T.astype(np.float64), Zh.T):
        st = AsyncIngest(np.ascontiguousarray(src), cfg, dev, chunk_bytes=16 << 20)
        out = st.result()[:, :n]
        on_card = engine_cast(torch.as_tensor(src, device=dev), torch.bfloat16)
        require(torch.equal(out.view(torch.int16), on_card.view(torch.int16)),
                f"host: the streamed bf16 cast of {src.dtype} differs from the card's")
        log(f"  bf16 from {src.dtype}: streamed ({st.n_chunks} chunks) bit-equal to the "
            "card's cast")
    del straight

    # -- abort from a thread after round 1 of a checkpointing run -----------------
    flag, round_done = AbortFlag(), threading.Event()
    setter = threading.Thread(target=lambda: (round_done.wait(60), flag.set()))
    setter.start()
    correct = engine.correct

    def signalling(cfg, state, layout=None, mesh=None):
        out = correct(cfg, state, layout, mesh)
        if out.n_rounds == 1:
            round_done.set()
            setter.join(60)
        return out

    ck_abort = os.path.join(tmp, "abort.npz")
    engine.correct = signalling
    try:
        run_harmony(Zh, meta, ["batch"], max_iter=MAX_ITER, seed=0, early_stop=False,
                    abort=flag, checkpoint_path=ck_abort)
        aborted = False
    except KeyboardInterrupt:
        aborted = True
    finally:
        engine.correct = correct
    require(aborted and not setter.is_alive(), "host: the abort flag did not stop the run")
    with np.load(ck_abort) as z:
        at = int(z["n_rounds"])
    require(cli.main(["run", "--embeddings", emb, "--meta", meta_csv, "--vars", "batch",
                      "--out", os.path.join(tmp, "after_abort.npy"), "--max-iter", "1",
                      "--checkpoint", ck_abort]) == 0, "host: resume after the abort failed")
    after = np.load(os.path.join(tmp, "after_abort.npy"))
    require(np.isfinite(after).all(), "host: the resume after the abort is not finite")
    log(f"  abort: KeyboardInterrupt after round {at}; the checkpoint resumed for one round "
        "(finite)")

    # -- a trace of one round -------------------------------------------------------
    tdir = os.path.join(OUT_DIR, "trace_host")
    for f in glob.glob(os.path.join(tdir, "*.json")):
        os.remove(f)
    with trace(tdir):
        run_harmony(Zh, meta, ["batch"], max_iter=1, seed=0)
    files = glob.glob(os.path.join(tdir, "*.json"))
    require(len(files) == 1, f"host: {len(files)} trace files")
    text = open(files[0]).read()
    # the graph route's run is one run_rounds span (run_rounds replays a
    # captured iteration; the JAX package's fused path has one scope too)
    for name in ("run_rounds", "materialize_r"):
        require(f'"name": "{name}"' in text, f"host: the trace has no {name} span")
    log(f"  trace of one rotate round: {files[0]} ({os.path.getsize(files[0]) / 2**20:.1f} MiB) "
        "holds the run_rounds and materialize_r spans")
    del Zh
    tmp_ctx.cleanup()

    # -- run_bench at the three cells ---------------------------------------------
    for mode, dtype in (("rotate", None), ("permute", None), ("rotate", "bfloat16")):
        _reset_peak(torch)
        payload = bench.run_bench(n_cells=n, d=d, n_batches=B, nclust=100, max_iter=4,
                                  shuffle_mode=mode, dtype=dtype, device=dev)
        log(f"  bench {mode} {dtype or 'float32'}: {json.dumps(payload)}; peak "
            f"{_peak_mib(torch):.1f} MiB")
        require(payload["platform"] == ("gpu" if dev.type == "cuda" else dev.type)
                and payload["value"] > 0, f"host: bench payload {payload}")

    # -- a bundled dataset -----------------------------------------------------------
    ds = datasets.cell_lines()
    res = run_harmony(ds.scaled_pcs, ds.meta_data, ["dataset"], seed=0, return_object=True,
                      device=dev)
    codes = np.unique(ds.meta_data["dataset"], return_inverse=True)[1]

    def centroid_distances(Z):
        """(mean, max) pairwise distance of the datasets' centroids of the
        L2-normalised cells (N, d); the max is the verify skill's figure."""
        Z = Z / np.linalg.norm(Z, axis=1, keepdims=True)
        c = np.stack([Z[codes == b].mean(0) for b in range(codes.max() + 1)])
        D = np.linalg.norm(c[:, None] - c[None], axis=-1)
        return D.sum() / (len(c) * (len(c) - 1)), D.max()

    (m0, x0), (m1, x1) = centroid_distances(ds.scaled_pcs), centroid_distances(res.embeddings)
    log(f"  cell_lines ({ds.n_cells} cells, {codes.max() + 1} datasets): "
        f"{int(res.state.n_rounds)} iterations; dataset-centroid distance mean {m0:.4f} -> "
        f"{m1:.4f}, max {x0:.4f} -> {x1:.4f}")
    require(np.isfinite(res.embeddings).all() and m1 < m0 and x1 < x0,
            "host: cell_lines separation did not shrink")
    log(f"host phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def mesh_ranks(n, extra, what):
    """``n`` ranks of ``python -m harmony_tpu_torch.multihost_worker`` with
    the arguments ``extra``, each within MESH_RANK_TIMEOUT (all killed on
    expiry); any rank that fails fails the phase. Returns each rank's JSON
    line."""
    from harmony_tpu_torch.multihost_worker import json_line, spawn

    t0 = time.perf_counter()
    res = spawn(n, list(extra), MESH_RANK_TIMEOUT, cwd=os.getcwd())
    for r, (rc, so, se) in enumerate(res):
        if rc != 0:
            log(f"  {what} rank {r} stderr tail:\n{se[-4000:]}")
        require(rc == 0, f"{what}: rank {r} of {n} exited with {rc}")
    lines = [json_line(so) for _, so, _ in res]
    log(f"  {what}: {n} rank(s) done in {time.perf_counter() - t0:.1f} s wall")
    return lines


# the injected modes on the mesh (multihost_worker --inject): the kernels
# each launches on every rank, those it must not, and its M-step layout
_NOT_E = ("K1", "K2", "K3", "K6", "K7", "K8", "K9", "K10", "K11", "K12")
MESH_INJECT = {
    "rotate": (("K6", "K7", "K9"), ("K8", "K10", "K11", "K12"), "tiled"),
    "virtual": (("K6", "K7", "K10", "K11"), ("K8", "K9", "K12"), "tiled"),
    "rotate_rounds": (("K6", "K7", "K8", "K9"), ("K10", "K11", "K12"), "tiled"),
    "permute": (("K8", "K9"), ("K1", "K2", "K3", "K6", "K7", "K10", "K11", "K12"), "tiled"),
    "permute_rounds": (("K4", "K5"), _NOT_E, "dense"),
    "rotate_cell": (("K4", "K5"), _NOT_E, "dense"),
    "segment": (("K6", "K7"), ("K1", "K2", "K3", "K4", "K5", "K8", "K9", "K10", "K11", "K12"),
                "segment"),
    "virtual_bf16": (REDUCED_FORMS, ("K1", "K2", "K3", "K4", "K5", "K8", "K9", "K12"), "tiled"),
}


def check_inject(lines, Zc, mode, size):
    """The injected runs of one mode on the ranks (multihost_worker
    --inject): the kernel route launched the mode's kernels and none of
    those it must not on every rank (MESH_INJECT), the plain route no
    kernel, both took the mode's M-step layout, and the kernel route held
    to the plain one (and virtual R to its materialised run) at the traj
    bounds, a bf16 run at check_bf16_routes' (Z_corr relative Frobenius
    and the objective at BF16_HELD_RTOL); the ranks' traces equal."""
    import numpy as np

    need, never, lay = MESH_INJECT[mode]
    for r, ln in enumerate(lines):
        kl = ln[f"{mode}/kernel"]["launches"]
        require(all(kl[k] > 0 for k in need) and all(kl[k] == 0 for k in never),
                f"mesh {mode} {size} kernel route, rank {r}: launches {kl}")
        require(not any(ln[f"{mode}/torch"]["launches"].values()),
                f"mesh {mode} {size} plain route launched kernels on rank {r}")
        for v in ("kernel", "torch"):
            got = ln[f"{mode}/{v}"]
            kind = "tiled" if got["tiled"] else "segment" if got["segments"] else "dense"
            require(kind == lay, f"mesh {mode} {size} {v}: the {kind} M-step, not {lay}")
        require(ln[f"{mode}/kernel"]["virtual"] == mode.startswith("virtual"),
                f"mesh {mode} {size}: virtual R engaged={ln[f'{mode}/kernel']['virtual']}")
    bf16 = mode.endswith("bf16")
    pairs = [("kernel", "torch", BF16_HELD_RTOL if bf16 else 1e-4,
              BF16_HELD_RTOL if bf16 else 1e-4)]
    if mode == "virtual" and f"{mode}/materialised" in lines[0]:
        pairs.append(("kernel", "materialised", 1e-5, 2e-4))
    for a, b, obj_rtol, z_tol in pairs:
        ta = np.asarray(lines[0][f"{mode}/{a}"]["objective_kmeans"])
        tb = np.asarray(lines[0][f"{mode}/{b}"]["objective_kmeans"])
        obj_rel = float(np.max(np.abs(ta - tb) / np.abs(tb)))
        za, zb = Zc[f"{mode}__{a}"].astype(np.float64), Zc[f"{mode}__{b}"].astype(np.float64)
        z_err = float(np.linalg.norm(za - zb) / np.linalg.norm(zb) if bf16
                      else np.max(np.abs(za - zb)))
        log(f"  mesh {mode} {size}, {a} against {b}: objective rel {obj_rel:.3e} (rtol "
            f"{obj_rtol}), Z_corr {'relative Frobenius' if bf16 else 'max abs'} error "
            f"{z_err:.3e} (bound {z_tol}); rank-0 launches "
            f"{ {k: v for k, v in lines[0][f'{mode}/{a}']['launches'].items() if v} }; "
            f"{lines[0][f'{mode}/{a}']['seconds']:.2f} s and "
            f"{lines[0][f'{mode}/{b}']['seconds']:.2f} s; all-reduces "
            f"{lines[0][f'{mode}/{a}']['collectives']['all_reduce']}")
        require(obj_rel <= obj_rtol,
                f"mesh {mode} {size}: {a} and {b} objectives differ: {obj_rel}")
        require(z_err <= z_tol, f"mesh {mode} {size}: {a} and {b} Z_corr differ: {z_err}")
        require(lines[0][f"{mode}/{a}"]["kmeans_rounds"]
                == lines[0][f"{mode}/{b}"]["kmeans_rounds"],
                f"mesh {mode} {size}: kmeans rounds differ")
    for ln in lines[1:]:
        require(ln[f"{mode}/kernel"]["objective_kmeans"]
                == lines[0][f"{mode}/kernel"]["objective_kmeans"],
                f"mesh {mode} {size}: the ranks' traces differ")


def mesh_worker_args(p: dict, bench: bool = True) -> list:
    """multihost_worker's arguments for the MESH_PATHS entry ``p`` (2 gloo
    ranks unless the caller adds another backend)."""
    args = ["--cells", str(p["cells"]), "--dims", str(D_MAIN), "--batches", str(p["batches"]),
            "--nclust", str(K_MAIN), "--max-iter", str(MAX_ITER), "--shuffle", p["shuffle"],
            "--dtype", p["dtype"]]
    if p["mic"]:
        args += ["--max-iter-cluster", str(p["mic"])]
    if not p["carry"]:
        args.append("--no-stats-carry")
    if p["virtual"]:
        args.append("--virtual")
    if bench and p["bench"]:
        args += ["--bench-pairs", str(MESH_BENCH_PAIRS)]
    return args


def one_device_run(torch, dev, p: dict, Z, batches):
    """The MESH_PATHS entry ``p`` on one card, on the cells ``Z`` in
    ``batches``, as the worker runs it on the ranks: run_harmony, or for
    rotate_stats_carry=False the worker's driver_result with the mesh's
    config (n_shards = MESH_RANKS: the cell-granular round on the plain
    random ingest order; on its own config one card takes the written-R
    rounds, K12, a tile schedule on the batch-tiled order, another
    trajectory). Returns (trace, iterations, seconds an iteration from the
    phase timers, peak MiB, the phase seconds)."""
    from harmony_tpu_torch import harmony_options, run_harmony
    from harmony_tpu_torch.multihost_worker import driver_result

    opts = harmony_options(max_iter_cluster=p["mic"] or 4)
    _reset_peak(torch)
    meta = {"dataset": batches.astype(str)}
    if p["carry"]:
        res = run_harmony(Z, meta, ["dataset"], nclust=K_MAIN, max_iter=MAX_ITER, seed=0,
                          shuffle_mode=p["shuffle"], options=opts, virtual_r=p["virtual"] or None,
                          dtype=p["dtype"], return_object=True)
    else:
        res = driver_result(Z, meta, None, K_MAIN, MAX_ITER, 0, p["shuffle"], opts,
                            device=dev, rotate_stats_carry=False, dtype=p["dtype"],
                            n_shards=MESH_RANKS)
    torch.cuda.synchronize()
    ph, n_it = res.phase_seconds(), int(res.state.n_rounds)
    out = (res.objective_harmony.tolist(), n_it,
           iter_seconds(ph, n_it), _peak_mib(torch), ph)
    del res
    torch.cuda.empty_cache()
    return out


def held_mesh_path(phase, p, lines, ref, sep0):
    """Hold a full-width mesh run (each rank's JSON line) to its one-device
    run ``ref`` (one_device_run's, with its ``bench`` seconds where run_bench
    takes the path): the ranks' traces equal, the final objective within
    5%, finite embeddings of the right shape, separation shrinking from
    ``sep0``, R's columns within 1e-4 of 1 (1e-2 stored in bf16), the route,
    fused permute phase, virtual R and M-step layout resolved as ``p``
    names; logs seconds an iteration, all-reduces and their bytes, and each
    rank's peak memory. Returns the launches summed over the ranks."""
    first = lines[0]
    for ln in lines[1:]:
        require(ln["objective_harmony"] == first["objective_harmony"],
                f"{phase}: the ranks' objective traces differ")
    launches = {k: sum(ln["launches"][k] for ln in lines) for k in first["launches"]}
    trace, n1, per_it1, peak1, _ = ref["run"]
    obj, obj1 = first["objective_harmony"][-1], trace[-1]
    rel = abs(obj - obj1) / abs(obj1)
    n_it, coll, cfg = first["n_iter"], first["collectives"], first["config"]
    log(f"{phase}: {p['cells']} x {D_MAIN}, K={cfg['K']}, B={p['batches']}, {cfg['dtype']} on "
        f"{len(lines)} gloo ranks (T={cfg['T']}, Np={cfg['Np']}, route {cfg['route']}, fused "
        f"permute {cfg['permute_fused']}, virtual R {cfg['virtual']}, M-step {cfg['mstep']}): "
        f"{n_it} iterations; final objective {obj:.4f} against one device's {obj1:.4f} "
        f"({n1} iterations), rel {rel:.3e} (bound 0.05)")
    bench = ""
    if "bench" in first:
        bench = (f"run_bench (CUDA events, median of {MESH_BENCH_PAIRS} pairs): "
                 f"{first['bench']['seconds_per_iter']:.4f} (rank 0; rank 1 "
                 f"{lines[1]['bench']['seconds_per_iter']:.4f}) against one device's "
                 f"{ref['bench']:.4f}; ")
    log(f"  seconds per iteration, {bench}the run's phase timers "
        f"{first['seconds_per_iter']:.4f} against {per_it1:.4f} (warm-up included); "
        f"all-reduces an iteration {coll['all_reduce'] / n_it:.1f}, "
        f"{coll['all_reduce_bytes'] / n_it / 1e3:.1f} kB a rank (one all-reduce of 16 kB: "
        f"{first['allreduce_16k_ms']:.3f} ms); all-gathers over the run {coll['all_gather']} "
        f"({coll['all_gather_bytes'] / 2**20:.1f} MiB a rank), broadcasts {coll['broadcast']}")
    log(f"  peak device memory by rank {[round(ln['peak_mib'], 1) for ln in lines]} MiB "
        f"(one device: {peak1:.1f} MiB); separation {sep0:.4f} -> "
        f"{first['separation_out']:.4f}; R column sums within {first['r_colsum_err']:.2e} "
        f"of 1; launches (summed over ranks) { {k: v for k, v in launches.items() if v} }")
    log(f"  phase seconds (rank 0): "
        + json.dumps({k: round(v, 4) for k, v in first["phase_seconds"].items()}))
    colsum = 1e-2 if p["dtype"] in ("bfloat16", "float16") else 1e-4
    require(first["finite"] and first["shape"] == [p["cells"], D_MAIN],
            f"{phase}: embeddings not finite or of the wrong shape")
    require(rel <= 0.05, f"{phase}: final objective {obj} is not within 5% of {obj1}")
    require(first["separation_out"] < sep0, f"{phase}: separation did not shrink")
    require(first["r_colsum_err"] <= colsum,
            f"{phase}: R column sums off by {first['r_colsum_err']} (bound {colsum})")
    got = (str(cfg["route"]), cfg["permute_fused"], cfg["virtual"], cfg["mstep"])
    require(got == p["want"] and cfg["dtype"] == p["dtype"],
            f"{phase}: resolved {cfg}, not {p['want']}")
    return launches


def check_mesh(torch, dev):
    """The mesh phase: cells sharded over torch.distributed ranks, one
    process a rank (harmony_tpu_torch.multihost_worker), the kernels built
    by the parent before (phase 2), so the ranks load them.

    1. The kernels on shards against their plain versions: 20,000 x 50
       cells, K = 100, B = 10, on 2 gloo ranks, injected centroids and each
       shard's schedules (or the global permutations and cell-granular
       schedules), the kernel route against the plain route on the same
       shards (MESH_INJECT): the rotate route with R written (K6, K7, K9),
       with virtual R (K6, K7, K10, K11; also against its materialised run
       at the JAX package's 1e-5), the unfused M-step (max_iter_cluster =
       6: K8, K9), the permute phase (the plain sharded phase, K8, K9), the
       per-round permute schedule (max_iter_cluster = 6, plain rounds, K4,
       K5), the cell-granular round (rotate_stats_carry=False, K4, K5), and
       bf16 virtual R (the bf16 forms of K6, K7, K10, K11); objective rtol
       1e-4, Z_corr atol 1e-4 (bf16: both 2e-2, Z_corr relative
       Frobenius); then the segmented M-step at B = 40 (K6, K7). Then at
       500,000 cells (250,000 a shard, 3 iterations) for the rotate route,
       virtual R and the permute phase, kernel against plain.
    2. The full width (MESH_PATHS), nothing cut: the bench generator (seed
       0), K = 100, run_harmony(mesh=) on 2 gloo ranks on the one card
       (through the worker's driver_result for rotate_stats_carry=False):
       mesh_main (rotate), mesh_virtual, mesh_permute, mesh_permute_rounds,
       mesh_rotate_cell, mesh_virtual_bf16, mesh_virtual_f16 at 500,000 x
       50, B = 10, and
       mesh_segment at 200,000 x 50, B = 40; each held to one device's run
       on the same cells (held_mesh_path), with seconds an iteration (the
       runs' phase timers, and bench.run_bench on both where it takes the
       path: CUDA events, median of MESH_BENCH_PAIRS pairs, warm-up
       excluded), the all-reduces an iteration and their bytes, each
       rank's peak memory.
    3. mesh_main on a 1-rank NCCL group against the one-device run, the
       objective trace at rtol 1e-5 (the delta merge O + (O' - O) rounds
       otherwise than O').
    Returns {path: launches summed over the ranks}."""
    import tempfile

    import numpy as np

    from harmony_tpu_torch.bench import make_synthetic_cells, run_bench
    from harmony_tpu_torch.multihost_worker import separation

    log(f"mesh: {MESH_RANKS} gloo ranks on {torch.cuda.get_device_name(0)} (one process a "
        "rank, each its own CUDA context); the kernels were built by this process")
    # 1. the kernels on shards against their plain versions: every mode at
    # 20k cells (the segmented M-step's at 40 batches), then three mesh
    # paths' routes at the full width, where each shard holds 250k cells
    # (the injected runs' Z_corr pass through a temporary directory)
    for cells, batches, modes, variants, iters in (
            (20_000, B_MAIN, ("rotate", "virtual", "rotate_rounds", "permute", "permute_rounds",
                              "rotate_cell", "virtual_bf16"), "kernel,torch,materialised", 5),
            (20_000, B_SEGMENT, ("segment",), "kernel,torch", 5),
            (N_MAIN, B_MAIN, ("rotate", "virtual", "permute"), "kernel,torch", 3)):
        size = f"{cells // 1000}k, B={batches}"
        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "mesh_inject.npz")
            lines = mesh_ranks(MESH_RANKS, [
                "--backend", "gloo", "--cells", str(cells), "--dims", str(D_MAIN), "--batches",
                str(batches), "--nclust", str(K_MAIN), "--max-iter", str(iters), "--inject",
                ",".join(modes), "--variants", variants, "--out", npz],
                f"the kernels on shards, {size}")
            with np.load(npz) as z:
                Zc = {k: z[k] for k in z.files}
        for mode in modes:
            check_inject(lines, Zc, mode, size)
        del Zc

    # 2. the full width against one device on the same cells
    launches, cells = {}, {}
    for phase, p in MESH_PATHS.items():
        key = (p["cells"], p["batches"])
        if key not in cells:
            cells = {key: make_synthetic_cells(p["cells"], D_MAIN, p["batches"], seed=0)}
        Z, batches = cells[key]
        ref = {"run": one_device_run(torch, dev, p, Z, batches)}
        if p["bench"]:
            os.environ["HARMONY_BENCH_PAIRS"] = str(MESH_BENCH_PAIRS)
            ref["bench"] = run_bench(
                n_cells=p["cells"], d=D_MAIN, n_batches=p["batches"], nclust=K_MAIN, seed=0,
                shuffle_mode=p["shuffle"], virtual_r=p["virtual"] or None,
                dtype=p["dtype"])["seconds_per_iter"]
            torch.cuda.empty_cache()
        lines = mesh_ranks(MESH_RANKS, ["--backend", "gloo", *mesh_worker_args(p)], phase)
        launches[phase] = held_mesh_path(phase, p, lines, ref, separation(Z, batches))
        if phase == "mesh_main":
            main_trace = ref["run"][0]

    # 3. one NCCL rank against one device
    (ln,) = mesh_ranks(1, ["--backend", "nccl", *mesh_worker_args(MESH_PATHS["mesh_main"],
                                                                  bench=False)],
                       "mesh_main, 1 NCCL rank")
    a, b = np.asarray(ln["objective_harmony"]), np.asarray(main_trace)
    require(len(a) == len(b), f"1-rank NCCL run took {len(a) - 1} iterations, one device "
            f"{len(b) - 1}")
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    log(f"mesh_main on 1 NCCL rank against one device: objective rel {rel:.3e} (rtol 1e-5) "
        f"over {len(a)} entries; {ln['seconds_per_iter']:.4f} s an iteration, all-reduces "
        f"{ln['collectives']['all_reduce'] / ln['n_iter']:.1f} an iteration (one all-reduce of "
        f"16 kB: {ln['allreduce_16k_ms']:.3f} ms)")
    require(rel <= 1e-5, f"1-rank NCCL run differs from one device: {rel}")
    return launches


def check_mesh_bf16_10m(torch, dev):
    """The opt-in phase mesh_bf16_10m: BASELINE's fifth configuration
    (10,000,000 x 50 cells, B = 100, K = 100, bf16; the bench generator,
    seed 0) through run_harmony(mesh=) on 2 gloo ranks of the one card,
    held to run_harmony on one device on the same cells as the mesh phase
    holds its paths (held_mesh_path), each rank's init seconds and peak
    memory logged. Returns {"mesh_bf16_10m": launches summed over the
    ranks}."""
    from harmony_tpu_torch.bench import make_synthetic_cells
    from harmony_tpu_torch.multihost_worker import separation, spawn

    p = {**MESH_PATHS["mesh_virtual_bf16"], "cells": N_10M, "batches": B_10M, "bench": False}
    t0 = time.perf_counter()
    Z, batches = make_synthetic_cells(N_10M, D_MAIN, B_10M, seed=0)
    log(f"mesh_bf16_10m: {N_10M} x {D_MAIN} cells, {B_10M} batches made in "
        f"{time.perf_counter() - t0:.1f} s")
    ref = {"run": one_device_run(torch, dev, p, Z, batches)}
    log(f"  one device: {len(ref['run'][0]) - 1} iterations, phase seconds "
        + json.dumps({k: round(v, 3) for k, v in ref["run"][4].items()}))
    sep0 = separation(Z, batches)
    del Z, batches
    t0 = time.perf_counter()
    res = spawn(MESH_RANKS, ["--backend", "gloo", *mesh_worker_args(p)], MESH_10M_TIMEOUT,
                cwd=os.getcwd())
    for r, (rc, so, se) in enumerate(res):
        if rc != 0:
            log(f"  mesh_bf16_10m rank {r} stderr tail:\n{se[-4000:]}")
        require(rc == 0, f"mesh_bf16_10m: rank {r} of {MESH_RANKS} exited with {rc}")
    from harmony_tpu_torch.multihost_worker import json_line

    lines = [json_line(so) for _, so, _ in res]
    log(f"  {MESH_RANKS} ranks done in {time.perf_counter() - t0:.1f} s wall; init_cluster "
        f"by rank {[round(ln['phase_seconds'].get('init_cluster', 0.0), 3) for ln in lines]} s, "
        f"wall by rank {[round(ln['wall_s'], 1) for ln in lines]} s")
    return {"mesh_bf16_10m": held_mesh_path("mesh_bf16_10m", p, lines, ref, sep0)}


def record_path(kernels, paths, phase, launches, runs=1) -> None:
    """A path's launches into the kernels line's rows (``launches_by_path``,
    ``launches`` their sum), holding it to the kernels it must launch and
    those it must not (``paths``); a path that runs the k-means init
    ``runs`` times launches LL_RUN Lloyd kernels each time."""
    need, never = paths[phase]
    for k in need:
        row = kernels[form_row(k, phase)]
        by_path = row.setdefault("launches_by_path", {})
        by_path[phase] = launches[k]
        row["launches"] = sum(by_path.values())
        require(launches[k] > 0, f"{k} was not launched on the {phase} path")
    for k in never:
        require(launches[k] == 0, f"{k} was launched on the {phase} path")
    if "LL" in need:
        require(launches["LL"] == LL_RUN * runs, f"{phase} path: {launches['LL']} Lloyd "
                f"launches, not {LL_RUN} a k-means init x {runs}")


def form_row(k: str, phase: str) -> str:
    """The kernels line's row of kernel ``k`` on a path: its bf16 or float16
    engine's form on those engines' paths (phases and mesh paths named so),
    else its own."""
    if k in REDUCED_FORMS and "bf16" in phase:
        return k + "_bf16"
    if k in REDUCED_FORMS and "f16" in phase:
        return k + "_f16"
    return k


# the storage check's keys, and the keys they take in the row of a kernel
# whose engine form is the bf16 product form (K6, K10, K11)
_FP32_PRODUCT_KEYS = {"ms": "ms_fp32_products", "plain_ms": "plain_ms_fp32_products",
                      "bound_ms": "bound_ms_fp32_products",
                      "bound_by": "bound_by_fp32_products",
                      "max_abs_err": "max_abs_err_fp32_products"}


def merge_forms(kernels, sfx, storage_rows, product_rows=None):
    """Into the kernels line's rows of the reduced-precision forms (``sfx``
    '_bf16' or '_f16'): K7's row is its storage form's; K6's, K10's and
    K11's the bf16 product form's (``product_rows``), which the engines'
    paths launch, with the storage form's fp32-product numbers beside it
    (_FP32_PRODUCT_KEYS)."""
    for k, row in storage_rows.items():
        if k in PRODUCT_FORMS:
            row = {_FP32_PRODUCT_KEYS.get(key, key): v for key, v in row.items()}
        kernels[k + sfx].update(row)
    for k, row in (product_rows or {}).items():
        kernels[k + sfx].update(row)


def check_reduced_forms(torch, dev, kernels):
    """The f16 phase's kernel checks: the float16 storage forms with fp32
    products (check_storage_forms) at the main shape (timed), in both op
    orders, on 160-cell layout tiles and at a ragged, a wide, a one-group
    and a past-K10 shape; then the bf16 product forms (check_products) for
    bf16 and float16 storage at the main shape (timed), in both op orders,
    on 160-cell tiles and at the shapes above and VIRTUAL_WIDE's."""
    log("the float16 storage forms and the bf16 product forms on the card:")
    f16, bf = torch.float16, torch.bfloat16
    storage = check_storage_forms(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17, True, f16)
    check_storage_forms(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17, False, f16, "legacy")
    check_storage_forms(torch, dev, N_TILE160, D_MAIN, K_MAIN, (B_MAIN,), 31, False, f16,
                        tiles=TILE160)
    for shape in ((30_011, 13, 7, (3, 4), 18), (20_000, 100, 100, (B_MAIN,), 19),
                  (20_000, D_MAIN, K_MAIN, (100,), 20), (20_000, D_MAIN, 300, (B_MAIN,), 21)):
        check_storage_forms(torch, dev, *shape, False, f16)
    merge_forms(kernels, "_f16", storage)
    for dt, sfx in ((bf, "_bf16"), (f16, "_f16")):
        products = check_products(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17, True, dt)
        merge_forms(kernels, sfx, {}, products)
        check_products(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17, False, dt, "legacy")
        for variant in ("fused_vpu", "legacy"):
            check_products(torch, dev, N_TILE160, D_MAIN, K_MAIN, (B_MAIN,), 31, False, dt,
                           variant, tiles=TILE160)
        for shape in ((30_011, 13, 7, (3, 4), 18), (20_000, 100, 100, (B_MAIN,), 19),
                      (20_000, D_MAIN, K_MAIN, (100,), 20), (20_000, D_MAIN, 300, (B_MAIN,), 21),
                      *VIRTUAL_WIDE):
            check_products(torch, dev, *shape, False, dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated; opt-in: {','.join(OPT_IN_PHASES)}")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        import harmony_tpu_torch  # noqa: F401
        from harmony_tpu_torch import _build
        from harmony_tpu_torch.ops import cuda_estep, cuda_permute, cuda_ridge, cuda_rotate, kmeans
    except ImportError as e:
        print(f"chip_smoke: harmony_tpu_torch not importable ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    _LOG_COPY.append(open(os.path.join(OUT_DIR, "chip_smoke.log"), "w"))
    dev = torch.device("cuda")
    kernels = {
        "K1": {"name": "K1 estep_round", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/estep_round.cu",
               "replaces": "harmony_tpu/ops/pallas_estep.py:43"},
        "K2": {"name": "K2 permute_round", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/permute_phase.cu",
               "replaces": "harmony_tpu/ops/pallas_estep.py:303"},
        "K3": {"name": "K3 permute_materialize", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/permute_phase.cu",
               "replaces": "harmony_tpu/ops/pallas_estep.py:487"},
        "K4": {"name": "K4 moments", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/ridge.cu",
               "replaces": "harmony_tpu/ops/pallas_ridge.py:41"},
        "K5": {"name": "K5 correction", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/ridge.cu",
               "replaces": "harmony_tpu/ops/pallas_ridge.py:382"},
        "K6": {"name": "K6 reassign", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/rotate.cu",
               "replaces": "harmony_tpu/ops/pallas_rotate.py:1261"},
        "K7": {"name": "K7 rotate_round", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/rotate.cu",
               "replaces": "harmony_tpu/ops/pallas_rotate.py:594"},
        "K8": {"name": "K8 tile_moments", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/tiled.cu",
               "replaces": "harmony_tpu/ops/pallas_ridge.py:109"},
        "K9": {"name": "K9 tiled_correction", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/tiled.cu",
               "replaces": "harmony_tpu/ops/pallas_ridge.py:254"},
        "K10": {"name": "K10 virtual_correction", "route": "cuda",
                "source": "harmony_tpu_torch/csrc/rotate.cu",
                "replaces": "harmony_tpu/ops/pallas_rotate.py:1451"},
        "K11": {"name": "K11 materialize_r", "route": "cuda",
                "source": "harmony_tpu_torch/csrc/rotate.cu",
                "replaces": "harmony_tpu/ops/pallas_rotate.py:1621"},
        "K12": {"name": "K12 rotate_round_v1", "route": "cuda",
                "source": "harmony_tpu_torch/csrc/estep_round.cu",
                "replaces": "harmony_tpu/ops/pallas_rotate.py:223"},
        "LL": {"name": "LL Lloyd round (k-means init)", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/kmeans.cu",
               "replaces": "none (harmony_tpu/ops/kmeans.py _lloyd_round: jnp.dot + "
                           "segment_sum)"},
    }
    # the reduced-precision engines' forms of K6, K7, K10 and K11 (their
    # virtual route): 2-byte storage, and for K6, K10 and K11 the bf16
    # product form; their launches are the bf16 and f16 phases' (form_row)
    for sfx, what in (("_bf16", "bf16"), ("_f16", "float16")):
        for k in REDUCED_FORMS:
            form = f"{what} storage" + (", bf16 products" if k in PRODUCT_FORMS else "")
            kernels[k + sfx] = {**kernels[k], "name": f"{kernels[k]['name']} ({form})"}
    wrappers = {"K1": cuda_estep.block_update_round, "K2": cuda_permute.permute_rounds,
                "K3": cuda_permute.materialize, "K4": cuda_ridge.moments,
                "K5": cuda_ridge.correction, "K6": cuda_rotate.reassign,
                "K7": cuda_rotate.rotate_update_round_v2, "K8": cuda_ridge.tile_moments,
                "K9": cuda_ridge.tiled_correction, "K10": cuda_rotate.virtual_correction,
                "K11": cuda_rotate.materialize_r, "K12": cuda_estep.rotate_update_round_v1,
                "LL": kmeans._lloyd_round}
    # the kernels each path must launch, and those it must not
    paths = {"permute": (("K2", "K3", "K9"), ("K1", "K8")),
             "permute_rounds": (("K1", "K4", "K5"), ("K2", "K3")),
             "main": (("K6", "K7", "K9"), ("K8", "K10", "K11", "K12")),
             "virtual": (("K6", "K7", "K10", "K11"), ("K8", "K9")),
             # 160-cell layout tiles: K7's split moments, K10 cutting its
             # steps, K9 masking a tile's partial slice
             "written_tile160": (("K6", "K7", "K9"), ("K8", "K10", "K11", "K12")),
             "written_tile160_k8": (("K6", "K7", "K8", "K9"), ("K10", "K11", "K12")),
             "virtual_tile160": (("K6", "K7", "K10", "K11"), ("K8", "K9", "K12")),
             "rotate_rounds": (("K6", "K7", "K8", "K9"), ("K10", "K11", "K12")),
             "rotate_two_phase": (("K12", "K8", "K9"), ("K6", "K7", "K10", "K11")),
             "legacy": (("K6", "K7", "K9"), ("K8", "K10", "K11", "K12")),
             "legacy_virtual": (("K6", "K7", "K10", "K11"), ("K8", "K9", "K12")),
             "segment": (("K6", "K7"), ("K4", "K5", "K8", "K9", "K10", "K11")),
             "segment_permute": (("K1",), ("K2", "K3", "K4", "K5", "K8", "K9")),
             "bf16": (REDUCED_FORMS, ("K1", "K2", "K3", "K8", "K9", "K12")),
             "bf16_10m": (REDUCED_FORMS, ("K1", "K2", "K3", "K8", "K9", "K12")),
             "f16": (REDUCED_FORMS, ("K1", "K2", "K3", "K8", "K9", "K12")),
             # the mesh paths, launches summed over the ranks
             "mesh_main": (("K6", "K7", "K9"),
                           ("K1", "K2", "K3", "K4", "K5", "K8", "K10", "K11", "K12")),
             "mesh_virtual": (("K6", "K7", "K10", "K11"),
                              ("K1", "K2", "K3", "K4", "K5", "K8", "K9", "K12")),
             "mesh_permute": (("K8", "K9"), ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K10",
                                              "K11", "K12")),
             "mesh_permute_rounds": (("K4", "K5"), _NOT_E),
             "mesh_rotate_cell": (("K4", "K5"), _NOT_E),
             "mesh_virtual_bf16": MESH_INJECT["virtual_bf16"][:2],
             "mesh_virtual_f16": MESH_INJECT["virtual_bf16"][:2],
             "mesh_segment": MESH_INJECT["segment"][:2],
             "mesh_bf16_10m": MESH_INJECT["virtual_bf16"][:2],
             # the graph phase's cells (the replays of run_rounds)
             "graph_rotate-500k": (("K6", "K7", "K9"), ("K8", "K10", "K11", "K12")),
             "graph_rotate-virtual-500k": (("K6", "K7", "K10"), ("K8", "K9", "K11")),
             "graph_rotate-virtual-bf16-500k": (("K6", "K7", "K10"), ("K8", "K9", "K11")),
             "graph_rotate-virtual-f16-500k": (("K6", "K7", "K10"), ("K8", "K9", "K11")),
             "graph_permute-500k": (("K2", "K3", "K9"), ("K1", "K8")),
             "graph_permute-rounds-500k": (("K1", "K4", "K5"), ("K2", "K3", "K8", "K9")),
             "graph_rotate-rounds-500k": (("K6", "K7", "K8", "K9"), ("K10", "K11", "K12")),
             "graph_rotate-two-phase-500k": (("K12", "K8", "K9"),
                                             ("K6", "K7", "K10", "K11")),
             "graph_permute-rounds-50k": (("K1", "K4", "K5"), ("K2", "K3", "K8", "K9")),
             # three covariates: the dense M-step in PyTorch, Cholesky's solve
             "graph_multicov-50k": (("K1",), ("K2", "K3", "K4", "K5", "K8", "K9")),
             "graph_pbmc-stim": (("K1", "K4", "K5"), ("K2", "K3", "K8", "K9")),
             "graph_rotate-cell-pbmc-stim": (("K4", "K5"), _NOT_E),
             "graph_rotate-cell-2500": (("K4", "K5"), _NOT_E),
             "graph_segment-permute-80k": (("K1",), ("K2", "K3", "K4", "K5", "K8", "K9")),
             "graph_rotate-multicov-500k": (("K6", "K7"), ("K1", "K2", "K3", "K12"))}
    # every path runs the k-means init (LL) but the graph cells, whose
    # counts start after it: the rounds never run a Lloyd round
    paths = {p: (need, (*never, "LL")) if p.startswith("graph_") else ((*need, "LL"), never)
             for p, (need, never) in paths.items()}
    t_start = time.perf_counter()

    # ---- 1. env ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False (fp32 products are IEEE fp32)")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items()) or 'cached'})")
    logs = _build.build_logs()
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
        fh.write("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    # per library: its kernels' most registers and the spills ptxas reports
    # (every line in ptxas.log)
    for k, v in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", v)]
        spills = [ln.strip() for ln in v.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        log(f"  ptxas {k}: {len(regs)} kernels, at most {max(regs, default=0)} registers; "
            f"{len(spills)} with spills" + (f", e.g. {spills[0]}" if spills else ""))

    # ---- 3. kernels against their plain versions ------------------------
    if "kernels" in phases:
        log("kernels against plain PyTorch on the card:")
        kernels["K1"].update(check_k1(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 1, True))
        check_k1(torch, dev, 1003, 13, 7, (3, 4), 2, False)
        # segment-permute-80k's shape: at 40 batches the old statistics
        # split the clusters over two CTAs
        check_k1(torch, dev, 80_000, D_MAIN, K_MAIN, (B_SEGMENT,), 5, False)
        k2, k3 = check_permute(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 15, True)
        kernels["K2"].update(k2)
        kernels["K3"].update(k3)
        # ragged: two covariates, blocks and tiles that do not divide N
        check_permute(torch, dev, 30_011, 13, 7, (3, 4), 16, False)
        # 40 batches, as on the segment paths: K2's warps share one (40 x K)
        # table of batch sums a CTA; its phase timed
        kernels["K2"]["ms_b40"] = check_permute(torch, dev, 200_000, D_MAIN, K_MAIN,
                                                (B_SEGMENT,), 7, False, timed_phase=True)[0]["ms"]
        # 400 batches: one table a CTA near the most shared memory holds;
        # K = 300: the chain in shared memory (past a lane's 8 registers)
        check_permute(torch, dev, 100_000, D_MAIN, K_MAIN, (400,), 9, False)
        check_permute(torch, dev, 30_011, 13, 300, (3, 4), 10, False)
        k4, k5 = check_ridge(torch, dev, N_MAIN, D_MAIN, K_MAIN, B_MAIN, 3, True)
        kernels["K4"].update(k4)
        kernels["K5"].update(k5)
        # a batch-contiguous order (a concatenated dataset's): one run a tile
        k4s, k5s = check_ridge(torch, dev, N_MAIN, D_MAIN, K_MAIN, B_MAIN, 3, True, "sorted")
        # the default path below 100k cells
        k4d, k5d = check_ridge(torch, dev, 60_000, D_MAIN, K_MAIN, B_MAIN, 4, True)
        for row, a, b in ((kernels["K4"], k4s, k4d), (kernels["K5"], k5s, k5d)):
            row.update(ms_sorted=a["ms"], gb_per_s_sorted=a["gb_per_s"], ms_60k=b["ms"],
                       bound_ms_60k=b["bound_ms"], gb_per_s_60k=b["gb_per_s"])
        # large B under the segment gate: K4's accumulators in device memory
        check_ridge(torch, dev, 60_000, D_MAIN, K_MAIN, 300, 5, False)
        # ragged, a batch with no cells; K = 300: K5 with one stage
        check_ridge(torch, dev, 30_011, 13, 7, 4, 4, False, absent=1)
        check_ridge(torch, dev, 30_011, D_MAIN, 300, B_MAIN, 6, False)
        # wide d: index tiles of 64, 32 and 16 cells (the last with K4's
        # accumulators in device memory)
        check_ridge(torch, dev, 5_003, 300, 100, B_MAIN, 7, False)
        check_ridge(torch, dev, 5_003, 500, 50, 3, 8, False)
        check_ridge(torch, dev, 5_003, 800, 50, B_MAIN, 9, False)
        # the cell-granular rotate round's dense M-step at the shapes its
        # graph cells give it: pbmc-stim (2,000 x 20, K = 67, 2 batches) and
        # 2,500 cells, the route's full width (K = 83)
        check_ridge(torch, dev, 2_000, 20, 67, 2, 10, False)
        check_ridge(torch, dev, 2_500, D_MAIN, 83, B_MAIN, 11, False)
        k6, k7 = check_rotate(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 11, True)
        kernels["K6"].update(k6)
        kernels["K7"].update(k7)
        # ragged: two covariates, N not a multiple of the tile, pad cells
        check_rotate(torch, dev, 30_011, 13, 7, (3, 4), 12, False)
        # segment-200k's shape: 40 batches
        check_rotate(torch, dev, 200_000, D_MAIN, K_MAIN, (B_SEGMENT,), 6, False)
        k7m, k10, k11, k6t = check_virtual(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17,
                                           True)
        kernels["K6"].update(k6t)
        kernels["K7"].update(k7m)
        kernels["K10"].update(k10)
        kernels["K11"].update(k11)
        check_virtual(torch, dev, 30_011, 13, 7, (3, 4), 18, False)
        # wide: more 4x4 tiles of the (K, d+1) table than a CTA has threads
        check_virtual(torch, dev, 20_000, 100, 100, (B_MAIN,), 19, False)
        check_virtual(torch, dev, 200_000, D_MAIN, K_MAIN, (B_SEGMENT,), 8, False)
        # layout tiles of 160 cells (T = 2560): K7's moments split a piece
        # at a tile boundary, K10 cuts its steps at tile edges; timed at
        # the virtual phase's shape ("160-cell tile" form), then ragged,
        # wide and in the legacy op order
        k7t, k10t = check_virtual(torch, dev, N_TILE160, D_MAIN, K_MAIN, (B_MAIN,), 31, True,
                                  tiles=TILE160)[:2]
        kernels["K7"].update(k7t)
        kernels["K10"].update(k10t)
        kernels["K7"]["tile_probe"] = probe_k7_tiles(torch, dev)
        check_virtual(torch, dev, 90_011, 13, 7, (3, 4), 32, False, tiles=TILE160)
        check_virtual(torch, dev, 90_000, 100, 100, (B_MAIN,), 33, False, tiles=TILE160)
        check_virtual(torch, dev, N_TILE160, D_MAIN, K_MAIN, (B_MAIN,), 31, False, "legacy",
                      tiles=TILE160)
        # K10 with one correction group where two do not fit (B = 100); past
        # its 256 clusters the correction runs K11, then K9
        check_virtual(torch, dev, 20_000, D_MAIN, K_MAIN, (100,), 20, False)
        check_virtual(torch, dev, 20_000, D_MAIN, 300, (B_MAIN,), 21, False)
        for shape in VIRTUAL_WIDE:
            check_virtual(torch, dev, *shape, False)
        # K11 reading the centroids where they lie (past K6's shared memory:
        # a state crossed from the JAX package), against its plain version
        for variant in ("fused_vpu", "legacy"):
            check_k11(torch, dev, 20_000, 300, 100, (20,), 27, variant)
        # the legacy op order: K7's rounds, its last round, K10 and K11 at
        # the main shape (timed) and at every shape above but 200k x 40
        check_rotate(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 11, False, "legacy")
        check_rotate(torch, dev, 30_011, 13, 7, (3, 4), 12, False, "legacy")
        for row, extra in zip(("K7", "K10", "K11"), check_virtual(
                torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17, True, "legacy")):
            kernels[row].update(extra)
        for shape in ((30_011, 13, 7, (3, 4), 18), (20_000, 100, 100, (B_MAIN,), 19),
                      (20_000, D_MAIN, K_MAIN, (100,), 20), (20_000, D_MAIN, 300, (B_MAIN,), 21),
                      *VIRTUAL_WIDE):
            check_virtual(torch, dev, *shape, False, "legacy")
        # the bf16 storage forms (fp32 products): at the main shape (timed)
        # in both op orders, and at the shapes the float32 forms are checked
        # at above
        bf = torch.bfloat16
        merge_forms(kernels, "_bf16", check_storage_forms(torch, dev, N_MAIN, D_MAIN, K_MAIN,
                                                          (B_MAIN,), 17, True, bf))
        check_storage_forms(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 17, False, bf, "legacy")
        for shape in ((30_011, 13, 7, (3, 4), 18), (20_000, 100, 100, (B_MAIN,), 19),
                      (200_000, D_MAIN, K_MAIN, (B_SEGMENT,), 8),
                      (20_000, D_MAIN, K_MAIN, (100,), 20), (20_000, D_MAIN, 300, (B_MAIN,), 21),
                      *VIRTUAL_WIDE):
            for variant in ("fused_vpu", "legacy"):
                check_storage_forms(torch, dev, *shape, False, bf, variant)
        k8, k9 = check_tiled(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 256, 13, True)
        kernels["K8"].update(k8)
        kernels["K9"].update(k9)
        # ragged: two covariates, a mixed tail after the pure tiles, pads
        check_tiled(torch, dev, 30_011, 13, 7, (3, 4), 128, 14, False)
        # K9 with one slice of R where two do not fit beside the betas, and
        # past 256 dims (a thread takes its 4-dim tiles in turn)
        check_tiled(torch, dev, 20_000, D_MAIN, 400, (B_MAIN,), 256, 24, False)
        check_tiled(torch, dev, 20_000, 300, 50, (B_MAIN,), 256, 25, False)
        kernels["K12"].update(check_rotate_v1(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 22,
                                              True))
        # ragged: two covariates, N not a multiple of the tile, pad cells
        check_rotate_v1(torch, dev, 30_011, 13, 7, (3, 4), 23, False)
        for k, row in kernels.items():
            log(f"  {k}: {row.get('ms', float('nan')):.3f} ms, plain "
                f"{row.get('plain_ms', float('nan')):.3f} ms, library "
                f"{row.get('library_ms')}, bound {row.get('bound_ms', float('nan')):.4f} ms "
                f"({row.get('bound_by')})")

    # ---- 3b. the k-means init's Lloyd round ------------------------------
    if "lloyd" in phases:
        log("the Lloyd round against plain PyTorch on the card:")
        rows = [check_lloyd(torch, dev, n, 31) for n in (N_MAIN, N_10M)]
        kernels["LL"].update(rows[0], at_10m=rows[1])

    # ---- 4. trajectories: kernels vs plain path -------------------------
    if "traj" in phases:
        check_traj(torch, dev, "permute")
        check_traj(torch, dev, "permute_fused")
        check_traj(torch, dev, "rotate")
        check_traj(torch, dev, "rotate_virtual")
        check_traj(torch, dev, "rotate_two_phase")
        check_traj(torch, dev, "rotate_cell")
        check_cell_route(torch, dev, wrappers)

    # ---- 5.-9. the main paths ---------------------------------------------
    traces = {}
    runs = [(p, lambda p=p: run_main_path(torch, dev, wrappers, p)) for p in MAIN_PATHS
            if p in phases]
    if "virtual" in phases:
        # the K8 reference first: the other two are held to it
        runs += [(p, lambda p=p: run_tile160_path(torch, dev, wrappers, p))
                 for p in ("written_tile160_k8", "written_tile160", "virtual_tile160")]
    if "legacy" in phases:
        runs += [(p, lambda p=p: run_main_path(torch, dev, wrappers, p)) for p in LEGACY_PATHS]
    if "segment" in phases:
        runs += [(p, lambda p=p, n=n, sch=sch: (run_segment_path(torch, dev, wrappers, p, n,
                                                                 sch), None, None))
                 for p, n, sch in SEGMENT_PATHS]
    held_f32 = {}  # the float32 run the bf16 and f16 paths are held to
    if "bf16" in phases:
        runs.append(("bf16", lambda: run_reduced_path(torch, dev, wrappers, "bf16", N_MAIN,
                                                      B_MAIN, held_f32)))
    if "f16" in phases:
        runs.append(("f16", lambda: (check_reduced_forms(torch, dev, kernels),
                                     run_reduced_path(torch, dev, wrappers, "f16", N_MAIN,
                                                      B_MAIN, held_f32))[1]))
    if "bf16_10m" in phases:
        runs.append(("bf16_10m", lambda: run_reduced_path(torch, dev, wrappers, "bf16_10m", N_10M,
                                                          B_10M, held_f32)))
    from harmony_tpu_torch import engine as _engine

    for phase, run in runs:
        # each path's peak memory holds its own captures only
        _engine.clear_graphs()
        torch.cuda.empty_cache()
        launches, trace, n_it = run()
        if trace is not None:
            traces[phase] = trace
        record_path(kernels, paths, phase, launches)
        if phase.endswith("virtual"):
            # one correction per iteration, R rebuilt once per run
            require(launches["K10"] == n_it and launches["K11"] == 1,
                    f"{phase} path: K10 {launches['K10']} launches for {n_it} iterations, "
                    f"K11 {launches['K11']}")
        # the paths each path's objective trace is held to: a virtual run
        # to the written one at the JAX package's bound; the legacy op order
        # to fused_vpu on the same route, one function in another op order
        held = {"virtual": (("main", 1e-5),), "legacy": (("main", 1e-4),),
                "written_tile160": (("written_tile160_k8", 1e-4),),
                "virtual_tile160": (("written_tile160_k8", 1e-4), ("written_tile160", 1e-4)),
                "legacy_virtual": (("virtual", 1e-4), ("legacy", 1e-5))}
        for other, rtol in held.get(phase, ()):
            if other not in traces:
                continue
            a, b = traces[phase], traces[other]
            obj_rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            log(f"  {phase} against {other}: objective rel {obj_rel:.3e} (rtol {rtol}; "
                f"{len(a)} and {len(b)} entries); {phase} {a}, {other} {b}")
            require(obj_rel <= rtol, f"{phase} objectives disagree with {other}: {obj_rel}")
        if phase == "rotate_two_phase" and "main" in traces:
            # the rounds that re-read R against the stats carry: the same
            # function in another summation order
            a, b = traces["rotate_two_phase"], traces["main"]
            obj_rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            log(f"  rotate_two_phase against main: objective rel {obj_rel:.3e} (rtol 1e-4; "
                f"{len(a)} and {len(b)} entries); two_phase {a}, main {b}")
            require(obj_rel <= 1e-4, f"rotate_two_phase objectives disagree: {obj_rel}")

    # ---- the one-dispatch run: a captured iteration replayed -----------
    if "graph" in phases:
        for cell, launches in check_graph(torch, dev, wrappers).items():
            record_path(kernels, paths, f"graph_{cell}", launches)

    if "stamps" in phases and "graph" not in phases:  # the graph phase checks them too
        check_stamps(torch, dev, wrappers)
        _engine.clear_graphs()

    if "bf16" in phases:
        _engine.clear_graphs()
        check_bf16_routes(torch, dev, wrappers)

    # ---- 15. the host modules: CLI, checkpoint, stream, abort, trace, bench -
    if "host" in phases:
        _engine.clear_graphs()
        launches = check_host(torch, dev, wrappers)
        for k in ("K6", "K7", "K9", "LL"):
            by_path = kernels[k].setdefault("launches_by_path", {})
            by_path["host_cli"] = launches[k]
            kernels[k]["launches"] = sum(by_path.values())

    # ---- 16.-17. the mesh: cells sharded over torch.distributed ranks ----
    mesh_launches = {}
    if "mesh" in phases:
        _engine.clear_graphs()
        mesh_launches.update(check_mesh(torch, dev))
    if "mesh_bf16_10m" in phases:
        mesh_launches.update(check_mesh_bf16_10m(torch, dev))
    for phase, launches in mesh_launches.items():
        # every rank runs the k-means init on the gathered cells
        record_path(kernels, paths, phase, launches, runs=MESH_RANKS)

    # ---- 18. the port's benchmark harnesses ------------------------------
    if "harness" in phases:
        _engine.clear_graphs()
        with open(os.path.join(OUT_DIR, "harness.json"), "w") as fh:
            json.dump(check_harness(torch, dev), fh, indent=1)

    for k in kernels.values():
        for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms"):
            k.setdefault(key, None)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
