#!/usr/bin/env python3
"""A/B of harmony_tpu_torch's round kernels between checkouts, on the card.

    python3 tools/ab_torch_k1.py [--paths permute_rounds,main,...] [--entries K4,K5,...] \
        PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout of this repo. In turn, each runs
in a fresh process from its own root (so it builds and loads its own
kernels), at the main shapes of ``chip_smoke.py`` (500,000 x 50, K = 100,
B = 10). The entries, each timed by CUDA events around the wrapper (host
work included) and, under ``torch.profiler``, by the device time of each
of its kernels (five calls, per call):

* ``K1``: one K1 round (``cuda_estep.block_update_round``, seed 1, with R
  carried in block order where the checkout's wrapper takes it).
* ``K1_phase``: a K1 phase as the engine runs it, four rounds from R in
  the cells' order to R back in the cells' order (a wrapper that carries R
  returns it in block order, so the phase ends with one scatter; one that
  does not scatters every round).
* ``K2_phase``: a K2 phase of four rounds (``cuda_permute.permute_rounds``,
  seed 15, the cells in a batch-tiled order as in ``chip_smoke.py``), its
  head included where the checkout has one; ``ms_round`` is a quarter.
* ``K2_phase_b40``: the same at segment-200k's shape, 200,000 x 50, K =
  100, 40 batches (seed 7).
* ``K6``: one K6 call (``cuda_rotate.reassign``, seed 17, the cells in a
  batch-tiled order), with its Gram table where the checkout stores one;
  ``K6_random``: the same at ``chip_smoke.check_rotate``'s inputs (seed 11,
  codes drawn at random).
* ``K3``, ``K3_moments``: one K3 call (``cuda_permute.materialize``)
  without and with the fused moments at ``chip_smoke.check_permute``'s
  inputs (seed 15, the cells in a batch-tiled order, the tables of a
  four-round K2 phase), reading the phase's distances where the
  checkout's K3 takes them.
* ``K7``, ``K7_write_r``, ``K7_last``: one K7 round on K6's outputs (g
  from K6's Gram table where the checkout has one) without writing R,
  writing R, and a phase's last round fusing the M-step's moments and
  storing the penalty tables, without writing R.
* ``K10``, ``K11``: one K10 call (``cuda_rotate.virtual_correction``)
  and one K11 call (``cuda_rotate.materialize_r``) from that last round's
  penalty tables, at ``chip_smoke.check_virtual``'s inputs (seed 17, the
  same joint betas), K10 given K6's Gram table where the checkout's K10
  takes it; ``K10_unfused``: K11, then K9 on its R, the path K10 fuses.
* ``K6_bf16``, ``K7_bf16``, ``K10_bf16``, ``K11_bf16``: the bf16 storage
  forms of K6, K7's last round, K10 and K11 (the bf16 engine's virtual
  route) on the same inputs stored in bf16: K6 reading a bf16 Z, K7's
  last round fusing the moments of a bf16 Z_orig on a bf16 R, E and O,
  K10 reading a bf16 Z_orig and writing a bf16 Z_corr, K11 writing a
  bf16 R. A checkout whose wrappers refuse bf16 reports the entry as
  unsupported.
* ``K12``: one K12 round (``cuda_estep.rotate_update_round_v1`` on the
  padded rotate layout, seed 22).
* ``K8``, ``K9``: one K8 call (``cuda_ridge.tile_moments``) and one K9
  call (``cuda_ridge.tiled_correction``) at ``chip_smoke.check_tiled``'s
  inputs (tile 256, seed 13).
* ``K4``, ``K5``: one K4 call (``cuda_ridge.moments``) and one K5 call
  (``cuda_ridge.correction``) at ``chip_smoke.check_ridge``'s inputs (seed
  3), codes drawn at random; where the checkout's wrappers take the
  per-tile batch index, it is built once beforehand, as the main path
  builds it once a run, and passed in.
* ``K4_sorted``, ``K5_sorted``: the same with the codes sorted (a
  batch-contiguous order).

``--entries`` picks a subset of the entries (all by default).

With ``--paths``, each checkout then runs those paths of its own
``chip_smoke.py`` (``run_main_path``; ``segment``: ``run_segment_path`` at
200,000 cells in 40 batches; ``bf16``: ``run_bf16_path``, the bf16 engine
at the main shape, where the checkout has it) in the same process, twice: the first run
warms up the libraries a cold process loads on first use (cuBLAS,
cuSOLVER), and the lines of the second's end-to-end numbers are printed,
with its peak device memory (``torch.cuda.max_memory_allocated``) and the
memory the process held before it.
Give the checkouts in turns (parent, change, change, parent) to see the
spread beside the difference.
"""

import argparse
import subprocess
import sys

_ONE = r'''
import gc, inspect, json, os, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from harmony_tpu_torch import ops
from harmony_tpu_torch.ops import cuda_estep, cuda_permute, cuda_ridge, cuda_rotate, rotate
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
PATHS = [p for p in sys.argv[1].split(",") if p]
ENTRIES = [e for e in sys.argv[2].split(",") if e]
WRAPPERS = {"K1": cuda_estep.block_update_round, "K2": cuda_permute.permute_rounds,
            "K3": cuda_permute.materialize, "K4": cuda_ridge.moments,
            "K5": cuda_ridge.correction, "K6": cuda_rotate.reassign,
            "K7": cuda_rotate.rotate_update_round_v2, "K8": cuda_ridge.tile_moments,
            "K9": cuda_ridge.tiled_correction, "K10": cuda_rotate.virtual_correction,
            "K11": cuda_rotate.materialize_r, "K12": cuda_estep.rotate_update_round_v1}


def _pairs(drawn):
    """(rotation, block order) pairs of draw_schedules' result: a schedule
    table, or in an older checkout the pairs themselves."""
    return ([(r[0], r[1:]) for r in drawn.tolist()] if isinstance(drawn, torch.Tensor)
            else drawn)


def k12_args():
    cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g = cs.rotate_problem(
        torch, 500_000, 50, 100, (10,), 22, dev)
    Zn = ops.l2_normalize_columns(Z).contiguous()
    R = ops.initial_assignments(ops.compute_distances(Y, Zn), sigma)
    R[:, 500_000:] = 0.0
    E = ops.compute_E(R, Pr_b)
    O = ops.compute_O(R, codes_pad.clamp_min(0), cfg.covariate_offsets, cfg.B)
    NT = rotate.n_tiles(cfg)
    order = _pairs(rotate.draw_schedules(cfg, g, 1))[0][1]
    layout = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad)
    return (cfg, Y, R.contiguous(), E, O, Pr_b, sigma, theta, NT - 1, order, layout)


def k2_phase(N=500_000, B=10, seed=15):
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order
    cfg, Z, Y, _, E, O, codes, Pr_b, sigma, theta, _ = cs.problem(
        torch, N, 50, 100, (B,), seed, dev)
    order, _ = build_batch_tiled_order(codes.cpu().numpy(), 256, seed)
    order = torch.as_tensor(order, device=dev)
    Z, codes = Z[:, order].contiguous(), codes[:, order].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    perms = torch.stack([torch.randperm(N, generator=g, device=dev) for _ in range(4)])
    return lambda: cuda_permute.permute_rounds(cfg, Z, Y, E, O, codes, Pr_b, sigma, theta,
                                               perms)


def rotate_calls():
    """K6, K7's three forms on K6's outputs, and K10 and K11 from the last
    round's tables, as check_virtual sets them up."""
    from harmony_tpu_torch.ops.ridge import full_tile_joint
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order
    cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g = cs.rotate_problem(
        torch, 500_000, 50, 100, (10,), 17, dev)
    N, Np = 500_000, cfg.Np
    order, layout = build_batch_tiled_order(codes_pad[:, :N].cpu().numpy(), 256, 17)
    order = torch.as_tensor(order, device=dev)
    Z[:, :N] = Z[:, order]
    codes_pad[:, :N] = codes_pad[:, order]
    Zo = torch.zeros(50, Np, device=dev)
    Zo[:, :N] = 2.0 * torch.randn(50, N, generator=g, device=dev)
    spec = rotate.MomentsSpec(Z_orig=Zo, tile_joint=full_tile_joint(cfg, layout),
                              n_joint=int(layout.joint_codes.shape[1]), tile=256)
    args6 = (cfg, Y, sigma, Pr_b, Z, codes_pad)
    out6 = cuda_rotate.reassign(*args6)
    Zn, tO, O, E = out6[:4]
    extra = {"G": out6[4]} if len(out6) > 4 else {}  # a checkout whose K6 stores G
    lay = rotate.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, **extra)
    drawn = rotate.draw_schedules(cfg, g, 1)
    rs = rotate.RoundState(R=torch.zeros(100, Np, device=dev), E=E, O=O, tile_O=tO,
                           kmeans_error=None, entropy=None)
    k7 = cuda_rotate.rotate_update_round_v2
    # a checkout whose K7 reads the schedule table's row, or (rt, order)
    sched = ((drawn[0],) if "sched" in inspect.signature(k7).parameters
             else tuple(_pairs(drawn)[0]))
    a7 = (cfg, Y, rs, Pr_b, sigma, theta, *sched, lay)
    nj, tj = spec.n_joint, spec.tile_joint
    W = 0.1 * torch.randn(nj + 1, 50, 100, generator=g, device=dev)
    W[nj] = 0.0
    last = k7(*a7, write_r=False, moments=spec, emit_pen=True)
    vargs = (Y, sigma, last.pen, last.blkmap, Zn, codes_pad)
    k10 = cuda_rotate.virtual_correction
    kw10 = extra if "G" in inspect.signature(k10).parameters else {}
    k11 = lambda: cuda_rotate.materialize_r(cfg, *vargs)
    # the bf16 storage forms on the same values stored in bf16
    bf = torch.bfloat16
    Zb, Zob = Z.to(bf), Zo.to(bf)
    spec_b = spec._replace(Z_orig=Zob)
    rs_b = rs._replace(R=rs.R.to(bf), E=E.to(bf), O=O.to(bf))
    a7b = (cfg, Y, rs_b, Pr_b, sigma, theta, *sched, lay)
    return {"K6": lambda: cuda_rotate.reassign(*args6),
            "K6_bf16": lambda: cuda_rotate.reassign(cfg, Y, sigma, Pr_b, Zb, codes_pad),
            "K7_bf16": lambda: k7(*a7b, write_r=False, moments=spec_b, emit_pen=True),
            "K10_bf16": lambda: k10(cfg, W, tj, 256, *vargs, Zob, **kw10),
            "K11_bf16": lambda: cuda_rotate.materialize_r(cfg, *vargs, out_dtype=bf),
            "K7": lambda: k7(*a7, write_r=False),
            "K7_write_r": lambda: k7(*a7, write_r=True),
            "K7_last": lambda: k7(*a7, write_r=False, moments=spec, emit_pen=True),
            "K10": lambda: k10(cfg, W, tj, 256, *vargs, Zo, **kw10),
            "K10_unfused": lambda: cuda_ridge.tiled_correction(W, tj, k11(), Zo, 256),
            "K11": k11}


def k3_calls():
    """K3 without and with the moments, as check_permute sets them up."""
    from harmony_tpu_torch.ops import permute_phase as pp
    from harmony_tpu_torch.ops.ridge import full_tile_joint
    from harmony_tpu_torch.ops.tiled import build_batch_tiled_order
    N = 500_000
    cfg, Z, Y, _, E, O, codes, Pr_b, sigma, theta, _ = cs.problem(
        torch, N, 50, 100, (10,), 15, dev)
    order, layout = build_batch_tiled_order(codes.cpu().numpy(), 256, 15)
    order = torch.as_tensor(order, device=dev)
    Z, codes = Z[:, order].contiguous(), codes[:, order].contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    perms = torch.stack([torch.randperm(N, generator=g, device=dev) for _ in range(4)])
    Zo = 2.0 * torch.randn(50, N, generator=g, device=dev)
    spec = pp.MomentsSpec(Z_orig=Zo, tile_joint=full_tile_joint(cfg, layout),
                          n_joint=int(layout.joint_codes.shape[1]), tile=256)
    out = cuda_permute.permute_rounds(cfg, Z, Y, E, O, codes, Pr_b, sigma, theta, perms)
    kw = {"G": out.G} if getattr(out, "G", None) is not None else {}
    m = cuda_permute.materialize
    return {"K3": lambda: m(cfg, Z, Y, codes, sigma, out.tables, **kw),
            "K3_moments": lambda: m(cfg, Z, Y, codes, sigma, out.tables, spec, **kw)}


def k6_random():
    cfg, Z, codes_pad, Y, sigma, Pr_b, theta, g = cs.rotate_problem(
        torch, 500_000, 50, 100, (10,), 11, dev)
    return lambda: cuda_rotate.reassign(cfg, Y, sigma, Pr_b, Z, codes_pad)


def tiled_calls():
    cfg, R, Z, tj, nj, W, layout = cs.tiled_problem(torch, 500_000, 50, 100, (10,), 256, 13,
                                                    dev)
    return {"K8": lambda: cuda_ridge.tile_moments(R, Z, 256, tj, nj),
            "K9": lambda: cuda_ridge.tiled_correction(W, tj, R, Z, 256)}


def ridge_calls(kind):
    """K4 and K5 at check_ridge's inputs; the index prebuilt where taken."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    N, d, K, B = 500_000, 50, 100, 10
    R = torch.softmax(torch.randn(K, N, generator=g, device=dev) * 3, dim=0).contiguous()
    Z = torch.randn(d, N, generator=g, device=dev) * 2
    codes = torch.randint(0, B, (N,), generator=g, device=dev, dtype=torch.int32)
    if kind == "sorted":
        codes = torch.sort(codes).values.contiguous()
    W = torch.randn(K, B, d, generator=g, device=dev) * 0.1
    extra = ()
    if "index" in inspect.signature(cuda_ridge.moments).parameters:
        extra = (cuda_ridge.cell_index(codes, B, cuda_ridge.index_tile(K, d, B)),)
    sfx = "" if kind == "random" else "_" + kind
    return {"K4" + sfx: lambda: cuda_ridge.moments(R, Z, codes, B, *extra),
            "K5" + sfx: lambda: cuda_ridge.correction(W, R, Z, codes, *extra)}


CARRIES = "order" in inspect.signature(cuda_estep.block_update_round).parameters
KW = {"carry": True} if "carry" in inspect.signature(
    cuda_estep.block_update_round).parameters else {}
K1_ARGS = list(cs.problem(torch, 500_000, 50, 100, (10,), 1, dev))


def k1_call():
    args = list(K1_ARGS)
    if not CARRIES:
        return lambda: cuda_estep.block_update_round(*args)
    # the round as the main path runs it: R carried in block order
    g = torch.Generator(device=dev)
    g.manual_seed(101)
    order = torch.randperm(500_000, generator=g, device=dev)
    args[3] = args[3][:, order].contiguous()
    return lambda: cuda_estep.block_update_round(*args, order=order, **KW)


def k1_phase():
    a = K1_ARGS
    g = torch.Generator(device=dev)
    g.manual_seed(102)
    perms = [a[10]] + [torch.randperm(500_000, generator=g, device=dev) for _ in range(3)]

    def phase():
        R, E, O, prev = a[3], a[4], a[5], None
        for p in perms:
            kw = {"order": prev, **KW} if CARRIES else {}
            o = cuda_estep.block_update_round(*a[:3], R, E, O, *a[6:10], p, **kw)
            R, E, O, prev = o.R, o.E, o.O, p
        return torch.empty_like(R).index_copy_(1, prev, R) if CARRIES else R
    return phase


out = {}
makers = [("K1", k1_call), ("K1_phase", k1_phase), ("K2_phase", k2_phase),
          ("K2_phase_b40", lambda: k2_phase(200_000, 40, 7)),
          (("K3", "K3_moments"), k3_calls),
          (("K6", "K7", "K7_write_r", "K7_last", "K10", "K10_unfused", "K11", "K6_bf16",
            "K7_bf16", "K10_bf16", "K11_bf16"), rotate_calls),
          ("K6_random", k6_random),
          ("K12", lambda: (lambda a: lambda: cuda_estep.rotate_update_round_v1(*a))(k12_args())),
          (("K8", "K9"), tiled_calls),
          (("K4", "K5"), lambda: ridge_calls("random")),
          (("K4_sorted", "K5_sorted"), lambda: ridge_calls("sorted"))]
calls = []
for names, make in makers:
    group = names if isinstance(names, tuple) else (names,)
    if ENTRIES and not set(group) & set(ENTRIES):
        continue
    made = make()
    calls += [(n, c) for n, c in (made.items() if isinstance(made, dict) else [(names, made)])
              if not ENTRIES or n in ENTRIES]
for name, call in calls:
    if name.endswith("_bf16"):
        try:
            call()
        except (TypeError, ValueError, RuntimeError) as e:
            out[name] = {"unsupported": str(e)[:200]}
            continue
    ms = cs.time_ms(torch, name, call,
                    iters={"K8": 10, "K9": 10, "K10": 10, "K10_unfused": 10, "K11": 10,
                           "K6": 10, "K6_random": 10, "K3": 10, "K3_moments": 10,
                           "K6_bf16": 10, "K10_bf16": 10, "K11_bf16": 10,
                           "K1_phase": 2, "K2_phase": 2,
                           "K2_phase_b40": 2}.get(name, 5))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            dev_ms[e.key[:60]] = round(t / 1e3 / 5, 4)
    out[name] = {"ms": ms, "device_ms_per_call": dev_ms}
    if name.startswith("K2_phase"):
        out[name]["ms_round"] = ms / 4
print("RESULT " + json.dumps(out), flush=True)
# free the entries' inputs before the paths: one checkout's entry may hold
# a tensor (K10's G) that the other's does not, and the paths report the
# memory allocated before them
calls.clear()
call = made = None
gc.collect()
os.makedirs(cs.OUT_DIR, exist_ok=True)
def run_path(path):
    if path == "segment":
        cs.run_segment_path(torch, dev, WRAPPERS, "segment", 200_000, "rotate")
    elif path == "bf16":
        if hasattr(cs, "run_bf16_path"):
            cs.run_bf16_path(torch, dev, WRAPPERS, "bf16", 500_000, 10)
        else:
            print("bf16 path: not in this checkout", flush=True)
    else:
        cs.run_main_path(torch, dev, WRAPPERS, path)


for path in PATHS:
    run_path(path)
    print("MEASURED " + path, flush=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_path(path)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"{base / 2**20:.1f} MiB of it allocated before the run", flush=True)
    print("MEASURED_END", flush=True)
'''


# the lines of chip_smoke.py's main paths that carry end-to-end numbers
_PATH_LINES = (" path:", "phase seconds", "seconds per Harmony iteration", "launches:",
               "peak device memory")


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="", help="chip_smoke.py main paths to run per checkout")
    ap.add_argument("--entries", default="", help="timed entries to run (default: all)")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print("card:", smi.stdout.strip() or "nvidia-smi: n/a", flush=True)
    for tree in args.trees:
        out = subprocess.run([sys.executable, "-c", _ONE, args.paths, args.entries], cwd=tree,
                             capture_output=True, text=True)
        lines = out.stdout.splitlines()
        res = [line for line in lines if line.startswith("RESULT")]
        print(tree, res[0][7:] if res else "FAILED\n" + out.stderr[-2000:], flush=True)
        path = None
        for line in lines:
            if line.startswith("MEASURED_END"):
                path = None
            elif line.startswith("MEASURED"):
                path = line.split()[1]
            elif path and any(key in line for key in _PATH_LINES):
                print(f"{tree} {path}: {line.strip()}", flush=True)
        if not res or out.returncode:
            print(tree, f"exited {out.returncode}\n" + out.stderr[-2000:], flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
