#!/usr/bin/env python3
"""On-card smoke test of harmony_tpu_torch.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # every phase, one card

Phases (``--phases`` picks a subset, comma-separated):

1. env       the card's name and power limit, torch/CUDA versions; TF32 off.
2. build     nvcc builds every kernel from harmony_tpu_torch/csrc.
3. kernels   K1, K4, K5 against their plain PyTorch versions on the card, at
             the main path's shapes and at one ragged shape; kernel, plain and
             library-call times and the least time the card could take.
4. traj      a 20k-cell run with injected centroids and permutations, once
             through the kernels and once through the plain path.
5. main      run_harmony on 500,000 x 50 cells, 10 batches, K = 100, the
             permute schedule; every kernel must be launched.

It prints a JSON line of the kernels' numbers, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero, and so does
a machine without a GPU or a directory without the package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASES = ("env", "build", "kernels", "traj", "main")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores. The bound of a function is the larger of its bytes over the
# first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# main-path shape: the repo's canonical 500k x 50, K = 100, B = 10
N_MAIN, D_MAIN, K_MAIN, B_MAIN = 500_000, 50, 100, 10
MAX_ITER = 10  # run_harmony's default; early stop is on
R_ATOL = 1e-5  # assignments: fp32 with another summation order
SUM_RTOL = 1e-4  # sums: max |kernel - plain| <= SUM_RTOL * max |plain|
# logs too long for the console (profile, ptxas report); a path setting
OUT_DIR = os.environ.get("CHIP_SMOKE_OUT", "chip_smoke_out")


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


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


def check_k1(torch, dev, N, d, K, B_vec, seed, timed):
    from harmony_tpu_torch.ops import cuda_estep, estep

    args = problem(torch, N, d, K, B_vec, seed, dev)
    out = cuda_estep.block_update_round(*args)
    ref = estep.block_update_round(*args)
    torch.cuda.synchronize()
    err = float((out.R - ref.R).abs().max())
    errs = {
        "R": err,
        "E": rel_err(out.E, ref.E),
        "O": rel_err(out.O, ref.O),
        "kmeans_error": rel_err(out.kmeans_error, ref.kmeans_error),
        "entropy": rel_err(out.entropy, ref.entropy),
    }
    log(f"  K1 N={N} d={d} K={K} B_vec={B_vec}: max|dR|={err:.3e} (atol {R_ATOL}); "
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
        row["ms"] = time_ms(torch, "K1 kernel round", lambda: cuda_estep.block_update_round(*args),
                            iters=5)
        row["plain_ms"] = time_ms(torch, "K1 plain round", lambda: estep.block_update_round(*args),
                                  iters=3)
        # one round reads Z, the old R, the codes and the permutation and
        # writes the new R (E/O/Y are tiny); g = Y^T Z is 2*K*d*N flops
        nbytes = 4 * (d * N + 2 * K * N + len(B_vec) * N) + 8 * N
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * K * d * N)
        row["library_ms"] = None
    return row


def check_ridge(torch, dev, N, d, K, B, seed, timed):
    from harmony_tpu_torch.ops import cuda_ridge

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    R = torch.softmax(torch.randn(K, N, generator=g, device=dev) * 3, dim=0).contiguous()
    Z = torch.randn(d, N, generator=g, device=dev) * 2
    codes = torch.randint(0, B, (N,), generator=g, device=dev, dtype=torch.int32)
    W = torch.randn(K, B, d, generator=g, device=dev) * 0.1
    M = cuda_ridge.moments(R, Z, codes, B)
    M_ref = cuda_ridge.moments_twin(R, Z, codes, B)
    Zc = cuda_ridge.correction(W, R, Z, codes)
    Zc_ref = cuda_ridge.correction_twin(W, R, Z, codes)
    torch.cuda.synchronize()
    e4, e5 = float((M - M_ref).abs().max()), float((Zc - Zc_ref).abs().max())
    r4, r5 = rel_err(M, M_ref), rel_err(Zc, Zc_ref)
    log(f"  K4 N={N} d={d} K={K} B={B}: max|dM|={e4:.3e} rel {r4:.3e} (rtol {SUM_RTOL})")
    log(f"  K5 N={N} d={d} K={K} B={B}: max|dZ|={e5:.3e} rel {r5:.3e} (rtol {SUM_RTOL})")
    require(r4 <= SUM_RTOL, f"K4 disagrees: {r4}")
    require(r5 <= SUM_RTOL, f"K5 disagrees: {r5}")
    k4, k5 = {"max_abs_err": e4}, {"max_abs_err": e5}
    if timed:
        oh = torch.nn.functional.one_hot(codes.long(), B).float()
        Za = torch.cat([Z, torch.ones(1, N, device=dev)])
        k4["ms"] = time_ms(torch, "K4 kernel", lambda: cuda_ridge.moments(R, Z, codes, B))
        k4["plain_ms"] = time_ms(torch, "K4 plain", lambda: cuda_ridge.moments_twin(R, Z, codes, B))
        k4["library_ms"] = time_ms(torch, "K4 library einsum",
                                   lambda: torch.einsum("kn,nb,dn->kbd", R, oh, Za))
        k4["bound_ms"], k4["bound_by"] = bound(
            4 * (K * N + d * N + N + K * B * (d + 1)), 2.0 * K * (d + 1) * N)
        k5["ms"] = time_ms(torch, "K5 kernel", lambda: cuda_ridge.correction(W, R, Z, codes))
        k5["plain_ms"] = time_ms(torch, "K5 plain",
                                 lambda: cuda_ridge.correction_twin(W, R, Z, codes))
        k5["library_ms"] = time_ms(torch, "K5 library einsum",
                                   lambda: torch.einsum("kn,nb,kbd->dn", R, oh, W))
        k5["bound_ms"], k5["bound_by"] = bound(
            4 * (K * N + 2 * d * N + N + K * B * d), 2.0 * K * d * N)
    return k4, k5


def profile_round(torch, res, top=12):
    """One more Harmony round of the finished run under torch.profiler:
    device time by kernel, and the device's idle share of the round's wall.
    The full table goes to OUT_DIR/profile_round.txt."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from harmony_tpu_torch import engine

    cfg = res.config
    # overwrite the trace slots of round 1: the run's traces are reported
    s = dataclasses.replace(res.state, n_kmeans=1, n_harmony=2, n_rounds=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.harmony_round(cfg, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device kernels only: an aten op also reports its kernels' time
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    with open(os.path.join(OUT_DIR, "profile_round.txt"), "w") as fh:
        fh.write(f"wall_ms {wall * 1e3:.3f} device_busy_ms {busy:.3f}\n")
        for ms, n, name in rows:
            fh.write(f"{ms:10.3f} ms {n:6d}x  {name}\n")
    log(f"  profiled round: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for ms, n, name in rows[:top]:
        log(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")


def separation(torch, Z, codes0, B):
    """Mean pairwise distance of batch centroids of the L2-normalised cells
    (Z is (d, N))."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        import harmony_tpu_torch  # noqa: F401
        from harmony_tpu_torch import _build
        from harmony_tpu_torch.ops import cuda_estep, cuda_ridge
    except ImportError as e:
        print(f"chip_smoke: harmony_tpu_torch not importable ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    kernels = {
        "K1": {"name": "K1 estep_round", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/estep_round.cu",
               "replaces": "harmony_tpu/ops/pallas_estep.py:43"},
        "K4": {"name": "K4 moments", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/ridge.cu",
               "replaces": "harmony_tpu/ops/pallas_ridge.py:41"},
        "K5": {"name": "K5 correction", "route": "cuda",
               "source": "harmony_tpu_torch/csrc/ridge.cu",
               "replaces": "harmony_tpu/ops/pallas_ridge.py:382"},
    }
    wrappers = {"K1": cuda_estep.block_update_round, "K4": cuda_ridge.moments,
                "K5": cuda_ridge.correction}
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
    for k, v in logs.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")

    # ---- 3. kernels against their plain versions ------------------------
    if "kernels" in phases:
        log("kernels against plain PyTorch on the card:")
        kernels["K1"].update(check_k1(torch, dev, N_MAIN, D_MAIN, K_MAIN, (B_MAIN,), 1, True))
        check_k1(torch, dev, 1003, 13, 7, (3, 4), 2, False)
        k4, k5 = check_ridge(torch, dev, N_MAIN, D_MAIN, K_MAIN, B_MAIN, 3, True)
        kernels["K4"].update(k4)
        kernels["K5"].update(k5)
        check_ridge(torch, dev, 1003, 13, 7, 3, 4, False)
        for k, row in kernels.items():
            log(f"  {k}: {row.get('ms', float('nan')):.3f} ms, plain "
                f"{row.get('plain_ms', float('nan')):.3f} ms, library "
                f"{row.get('library_ms')}, bound {row.get('bound_ms', float('nan')):.4f} ms "
                f"({row.get('bound_by')})")

    # ---- 4. trajectory: kernels vs plain path ---------------------------
    if "traj" in phases:
        import dataclasses
        import numpy as np

        from harmony_tpu_torch import driver, preprocess
        from harmony_tpu_torch.config import finalize_engine_config, harmony_options
        from harmony_tpu_torch.state import init_state

        n, d, B, iters = 20_000, D_MAIN, B_MAIN, 5
        Zs, bs = synthetic(torch, n, d, B, 5, dev)
        Zh, bh = Zs.cpu().numpy().astype(np.float64), bs.cpu().numpy()
        design = preprocess.build_design({"batch": bh.astype(str)}, ["batch"])
        base = preprocess.resolve_config(
            n_cells=n, d=d, design=design, nclust=None, max_iter=iters,
            early_stop=False, options=harmony_options(), verbose=False,
            lambda_estimation=True, ridge_solver="auto",
        )
        hp = preprocess.expand_hyperparams(design, base.K, None, 0.1, None, 0.0)
        rng = np.random.default_rng(6)
        Zt = Zh.T
        Y0 = Zt[:, rng.choice(n, base.K, replace=False)]
        perms = np.stack([np.stack([rng.permutation(n) for _ in range(base.max_iter_cluster)])
                          for _ in range(iters)])
        out = {}
        for impl in ("kernel", "torch"):
            cfg = finalize_engine_config(dataclasses.replace(base, estep_impl=impl, mstep_impl=impl))
            st = init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, 0, dev)
            t0 = time.perf_counter()
            st = driver.run(cfg, st, Y0=Y0, perms=perms)
            torch.cuda.synchronize()
            out[impl] = (st.trace_lists(cfg), st.Z_corr.cpu().numpy(), time.perf_counter() - t0)
        (tk, zk, sk), (tt, zt, st_) = out["kernel"], out["torch"]
        obj_rel = float(np.max(np.abs(tk["objective_kmeans"] - tt["objective_kmeans"])
                               / np.abs(tt["objective_kmeans"])))
        z_err = float(np.max(np.abs(zk - zt)))
        log(f"trajectory 20k x {d}, K={base.K}, B={B}, {iters} rounds: objective rel "
            f"{obj_rel:.3e} (rtol 1e-4), max|dZ_corr|={z_err:.3e} (atol 1e-4); "
            f"kernels {sk:.2f} s, plain {st_:.2f} s")
        require(obj_rel <= 1e-4, f"trajectory objectives disagree: {obj_rel}")
        require(z_err <= 1e-4, f"trajectory Z_corr disagrees: {z_err}")
        require(np.array_equal(tk["kmeans_rounds"], tt["kmeans_rounds"]), "kmeans rounds differ")

    # ---- 5. main path -----------------------------------------------------
    if "main" in phases:
        import numpy as np

        from harmony_tpu_torch import run_harmony

        Zs, bs = synthetic(torch, N_MAIN, D_MAIN, B_MAIN, 7, dev)
        sep0 = separation(torch, Zs.t(), bs, B_MAIN)
        Zh = Zs.cpu().numpy()
        meta = {"batch": bs.cpu().numpy()}
        del Zs
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = run_harmony(Zh, meta, ["batch"], shuffle_mode="permute",
                          max_iter=MAX_ITER, return_object=True, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        ph = res.phase_seconds()
        n_it = int(res.state.n_rounds)
        per_it = (ph.get("cluster", 0.0) + ph.get("correct", 0.0)) / max(n_it, 1)
        log(f"main path: run_harmony {N_MAIN} x {D_MAIN}, K={res.K}, B={res.B}, "
            f"permute, max_iter={MAX_ITER}: {n_it} iterations, wall {wall:.2f} s")
        log("  phase seconds: " + json.dumps({k: round(v, 4) for k, v in ph.items()}))
        log(f"  seconds per Harmony iteration {per_it:.4f}; "
            f"{N_MAIN / per_it:,.0f} cells/s per iteration")
        log(f"  kmeans rounds {res.kmeans_rounds.tolist()}; objective "
            f"{[round(float(x), 3) for x in res.objective_harmony]}")
        log(f"  launches: {launches}")
        for k, v in launches.items():
            kernels[k]["launches"] = v
            require(v > 0, f"{k} was not launched on the main path")
        emb = res.embeddings
        require(emb.shape == (N_MAIN, D_MAIN) and np.isfinite(emb).all(),
                "embeddings not finite or of the wrong shape")
        colsum = res.state.R.sum(0)
        dev_r = float((colsum - 1).abs().max())
        require(dev_r <= 1e-4, f"R column sums off by {dev_r}")
        sep1 = separation(torch, res.state.Z_corr, res.state.codes[0], B_MAIN)
        log(f"  R column sums within {dev_r:.2e} of 1; batch-centroid separation "
            f"{sep0:.4f} -> {sep1:.4f}")
        require(sep1 < sep0, "batch-centroid separation did not shrink")
        profile_round(torch, res)

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
