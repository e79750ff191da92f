"""The mesh routes of harmony_tpu_torch beyond the stats-carrying rotate
route and the fused permute phase, against the JAX package's mesh engine.

The harness is ``test_torch_mesh.py``'s: each world size (2 and 4 gloo
ranks on the CPU) is started once for the module, a module fixture writes
the randomness the JAX package draws to a spec file, the ranks (this file
run as a script) run every case of their size and write their gathered
state, and the tests compare. The JAX mesh engine runs on conftest's
virtual CPU devices: its XLA rounds and M-step auto-partitioned, its
Pallas kernels in interpret mode.

Seeded inputs: d = 8, K = 8, B = 3 (two covariates: B_vec (3, 4)), three
Harmony rounds, lambda estimated, the same centroids on both sides.

* Against the JAX mesh engine, objective rtol 1e-5, Z_corr, R and Y atol
  1e-4: the per-round permute schedule (global permutations injected) with
  the dense M-step, one covariate at N = 4,000 (K4's plain version per
  shard, summed) and two at N = 4,096 (the plain contractions, the cell
  mask per shard); the cell-granular rotate round (each round's (r, order)
  from the JAX keys) taken through ``rotate_stats_carry=False`` at N =
  4,096 and below ``n_blocks * 128`` cells a shard at N = 4,094, whose two
  pad cells sit on the last rank; the segmented M-step on the per-round
  permute schedule at N = 4,000.
* The bf16 engine on a mesh against the JAX bf16 mesh engine at
  ``tests/test_torch_bf16_engine.py``'s bounds (objective rtol 5e-3,
  Z_corr relative Frobenius 5e-3, R's columns within 5e-3 of 1): virtual R
  with each shard's draws (K6, K7, K10 and K11's plain versions on bf16
  storage, the bf16 product form) and the fused permute phase; the
  float16 engine's virtual R against the JAX float16 mesh engine at the
  same bounds.
* Shard-count invariance: the per-round permute schedule (N = 4,000) and
  the cell-granular round (N = 2,400, a cell route on one device too) on 2
  and 4 ranks with the port's own draws equal the port's one-device run
  (objective rtol 1e-4, Z_corr atol 2e-4), as ``tests/test_sharding.py``
  holds the JAX package; the generators stay in lockstep.
* On every case the ranks' objective traces and centroids are equal bit
  for bit, and each rank's state gathered (``state_to_arrays(mesh=)``, a
  bf16 state as float32 arrays of its values) and taken apart again
  (``state_from_arrays(mesh=)``) is its state bit for bit.
* In one process: a JAX bf16 state's global arrays split into each rank's
  bf16 state and rejoin bit for bit; a rank's bf16 ``Z_orig`` streamed by
  ``AsyncIngest(mesh=)`` is its columns of the one-device bf16 ingest, bit
  for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_mesh as tm  # noqa: E402
from harmony_tpu_torch import config as tconfig  # noqa: E402
from harmony_tpu_torch import engine as tengine  # noqa: E402
from harmony_tpu_torch import preprocess as tpre  # noqa: E402
from harmony_tpu_torch import sharding as tsh  # noqa: E402
from harmony_tpu_torch import state as tstate  # noqa: E402
from harmony_tpu_torch.ops import rotate as tr  # noqa: E402
from harmony_tpu_torch.ops.tiled import build_batch_tiled_order  # noqa: E402

D, K, ROUNDS = 8, 8, 3
# mode: schedule, block size, two covariates, dtype, config changes, and
# whether the run takes the batch-tiled ingest order and M-step (the JAX
# package's Pallas routes) or the XLA ones
MODES = {
    "permute_rounds": dict(shuffle="permute"),
    "permute_rounds2": dict(shuffle="permute", two_cov=True),
    "segment": dict(shuffle="permute", over={"mstep_mode": "segment"}),
    "cell_nocarry": dict(shuffle="rotate", block=0.25, over={"rotate_stats_carry": False}),
    "cell_small": dict(shuffle="rotate"),
    "virtual_bf16": dict(shuffle="rotate", block=0.25, dtype="bfloat16", tiled=True,
                         over={"virtual_r": True, "estep_sub_tile": 512}),
    "permute_bf16": dict(shuffle="permute", dtype="bfloat16", tiled=True,
                         over={"estep_sub_tile": 256}),
    "virtual_f16": dict(shuffle="rotate", block=0.25, dtype="float16", tiled=True,
                        over={"virtual_r": True, "estep_sub_tile": 512}),
}
# (mode, N, world size) held against the JAX mesh engine
JAX_CASES = (("permute_rounds", 4000, 2), ("permute_rounds2", 4096, 4), ("segment", 4000, 4),
             ("cell_nocarry", 4096, 2), ("cell_small", 4094, 4), ("virtual_bf16", 4096, 2),
             ("permute_bf16", 4096, 4), ("virtual_f16", 4096, 2))
# (mode, N) run with the port's own draws on every world size, held to the
# port's one-device run
OWN_CASES = (("permute_rounds", 4000), ("cell_small", 2400))
SIZES = (2, 4)
BF16_RTOL = 5e-3


def route_problem(mod, pre, mode: str, N: int, mesh):
    """The problem of ``mode`` at N in package ``mod`` (config) with its
    ``pre`` (preprocess), padded and finalised for ``mesh`` (anything with
    a ``size``): (config, design in engine order, (d, N) cells,
    hyperparameters, centroids)."""
    m = MODES[mode]
    rng = np.random.default_rng(7)
    meta = {"dataset": rng.integers(0, 3, N)}
    if m.get("two_cov"):
        meta["cell_type"] = rng.integers(0, 4, N)
    Z = (rng.normal(size=(3, D)) * 0.8)[meta["dataset"]] + rng.normal(size=(N, D))
    design = pre.build_design(meta, list(meta))
    opts = mod.harmony_options(block_size=m.get("block", 0.05))
    cfg = pre.resolve_config(design=design, options=opts, n_cells=N, d=D, nclust=K,
                             max_iter=ROUNDS, early_stop=False, verbose=False,
                             lambda_estimation=True)
    over = dict(shuffle_mode=m["shuffle"], dtype=m.get("dtype", "float32"), **m.get("over", {}))
    if m.get("tiled"):
        over.update(mstep_tile=128, mstep_mode="tiled")
    if mod is tconfig:
        impl = "kernel" if over["dtype"] != "float64" else "torch"
        cfg = dataclasses.replace(cfg, estep_impl=impl, mstep_impl=impl, **over)
        if mode == "permute_bf16":
            cfg = dataclasses.replace(cfg, permute_fused=True)
        cfg = tconfig.finalize_engine_config(tsh.pad_for_mesh(cfg, mesh), mesh)
    else:
        from harmony_tpu.sharding import pad_for_mesh

        cfg = dataclasses.replace(cfg, estep_impl="pallas" if m.get("tiled") else "xla", **over)
        cfg = mod.finalize_engine_config(pad_for_mesh(cfg, mesh), mesh)
    Zt = pre.orient_embedding(Z, N)
    if m.get("tiled"):
        perm, _ = build_batch_tiled_order(design.codes, 128, seed=0)
        Zt = Zt[:, perm]
        design = dataclasses.replace(design, codes=design.codes[:, perm])
    hp = pre.expand_hyperparams(design, cfg.K, None, 0.1, None, opts.tau)
    Y0 = Zt[:, rng.choice(N, cfg.K, replace=False)]
    return cfg, design, Zt, hp, Y0


def _cell_schedule(cfg, key):
    """(r, order) as the JAX cell-granular round draws them from its key."""
    k1, k2 = jax.random.split(key)
    return (int(jax.random.randint(k1, (), 0, cfg.Np)),
            [int(b) for b in jax.random.permutation(k2, cfg.n_blocks)])


# ---- the ranks -------------------------------------------------------------

def _rank_case(case, mesh, out):
    ct, design, Zt, hp, Y0 = route_problem(tconfig, tpre, case["mode"], case["N"], mesh)
    assert ct.Np == case["Np"] and ct.rotate_route == case["route"]
    layout = tengine.mstep_layout(ct, design.codes, "cpu", mesh)
    st = tstate.init_state(ct, Zt, design, hp.sigma, hp.theta, hp.lamb, 3, "cpu", mesh=mesh)
    st = tengine.init_cluster_from(ct, st, Y0, mesh)
    for r in range(ROUNDS):
        kw = {}
        if "perms" in case:
            kw["perms"] = np.asarray(case["perms"][r])
        elif "schedules" in case:
            kw["schedules"] = tr.schedule_table(case["schedules"][r])
        elif "shard_schedules" in case:
            kw["schedules"] = tr.schedule_table(
                [s[mesh.rank] for s in case["shard_schedules"][r]])
        st = tengine.correct(ct, tengine.cluster(ct, st, tiled=layout.tiled, mesh=mesh, **kw),
                             layout, mesh)
    st = tengine.materialize_r(ct, st, mesh)
    arrays = tstate.state_to_arrays(st, mesh=mesh)
    # the gathered state (float32 arrays holding a bf16 state's values) and
    # the rank's part of it again: the same bits
    back = tstate.state_from_arrays(ct, arrays, "cpu", mesh=mesh)
    for f in tstate.ARRAY_FIELDS + tstate.VIRTUAL_FIELDS:
        if isinstance(getattr(st, f, None), torch.Tensor):
            assert torch.equal(getattr(back, f), getattr(st, f)), f
    cid = case["id"]
    for f in ("Z_corr", "R", "objective_kmeans", "objective_harmony", "kmeans_rounds", "Y"):
        out[f"{cid}/{f}"] = arrays[f]
    out[f"{cid}/generator"] = st.generator.get_state().numpy()
    out[f"{cid}/route"] = np.asarray([str(ct.rotate_route)])
    out[f"{cid}/layout"] = np.asarray(["dense" if layout.segments is None and layout.tiled is None
                                       else "segment" if layout.tiled is None else "tiled"])


def _rank_main(argv):
    rank, world, port, spec_path, out_path = argv
    torch.set_num_threads(1)
    tsh.initialize_distributed("gloo", f"tcp://localhost:{port}", int(world), int(rank),
                               timeout=tm.RANK_TIMEOUT)
    mesh = tsh.make_mesh("cpu")
    with open(spec_path) as fh:
        spec = json.load(fh)
    out = {}
    for case in spec["cases"]:
        _rank_case(case, mesh, out)
    np.savez(out_path, **{k.replace("/", "__"): v for k, v in out.items()})
    print(json.dumps({"rank": mesh.rank, "ok": True}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ---- the JAX side and the fixtures ----------------------------------------

def _draws(cj, ct, mode, n):
    """The randomness the JAX engine draws in ROUNDS rounds of ``mode``."""
    if MODES[mode]["shuffle"] == "permute":
        rng = np.random.default_rng(11)
        return {"perms": [[rng.permutation(cj.N).tolist() for _ in range(cj.max_iter_cluster)]
                          for _ in range(ROUNDS)]}
    key, sched = jax.random.PRNGKey(3), []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, cj.max_iter_cluster)
        if MODES[mode].get("tiled"):
            NT = cj.Np // n // cj.estep_sub_tile
            sched.append([tm.shard_schedules(k, n, NT, min(cj.n_blocks, NT)) for k in keys])
        else:
            sched.append([_cell_schedule(ct, k) for k in keys])
    return {"shard_schedules" if MODES[mode].get("tiled") else "schedules": sched}


def spec(n: int) -> dict:
    """The cases a world of ``n`` ranks runs, with the JAX draws."""
    from harmony_tpu import config as jconfig
    from harmony_tpu import preprocess as jpre

    cases = []
    for mode, N, size in JAX_CASES:
        if size != n:
            continue
        cj = route_problem(jconfig, jpre, mode, N, tm._jax_mesh(n))[0]
        ct = route_problem(tconfig, tpre, mode, N, tm._Size(n))[0]
        assert (cj.Np, cj.n_blocks) == (ct.Np, ct.n_blocks)
        cases.append(dict(id=f"{mode}{N}", mode=mode, N=N, Np=ct.Np, route=ct.rotate_route,
                          **_draws(cj, ct, mode, n)))
    for mode, N in OWN_CASES:
        ct = route_problem(tconfig, tpre, mode, N, tm._Size(n))[0]
        cases.append(dict(id=f"own_{mode}{N}", mode=mode, N=N, Np=ct.Np, route=ct.rotate_route))
    return {"cases": cases}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: (spec, [each rank's outputs])}, each world started once
    (the ranks run this file)."""
    from harmony_tpu_torch.multihost_worker import free_port, json_line, run_ranks

    out = {}
    for n in SIZES:
        the_spec = spec(n)
        d = tmp_path_factory.mktemp(f"routes{n}")
        spec_path = str(d / "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(the_spec, fh)
        port = free_port()
        res = run_ranks([[sys.executable, os.path.abspath(__file__), str(r), str(n), str(port),
                          spec_path, str(d / f"rank{r}.npz")] for r in range(n)],
                        tm.RANK_TIMEOUT, cwd=ROOT)
        bad = [(r, rc, se[-3000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
        assert not bad, f"ranks failed or timed out: {bad}"
        assert all(json_line(so)["ok"] for _, so, _ in res)
        loaded = []
        for r in range(n):
            with np.load(str(d / f"rank{r}.npz")) as z:
                loaded.append({k.replace("__", "/"): z[k] for k in z.files})
        out[n] = (the_spec, loaded)
    return out


def _jax_run(mode, N, n, case):
    """ROUNDS rounds of the JAX mesh engine on ``case``'s draws; the final
    state, virtual R materialised."""
    from harmony_tpu import config as jconfig
    from harmony_tpu import engine as jengine
    from harmony_tpu import preprocess as jpre
    from harmony_tpu import state as jstate
    from harmony_tpu.ops import segments as jseg
    from harmony_tpu.ops import tiled as jtiled
    from harmony_tpu.sharding import shard_state

    mesh = tm._jax_mesh(n)
    cj, design, Zt, hp, Y0 = route_problem(jconfig, jpre, mode, N, mesh)
    s = shard_state(jstate.init_state(cj, Zt, design, hp.sigma, hp.theta, hp.lamb,
                                      jax.random.PRNGKey(3)), mesh)
    tiled = segments = None
    if MODES[mode].get("tiled"):
        tiled = jtiled.detect_tiled_layout(np.asarray(s.codes), cj.N, 128)
        assert tiled is not None
    elif cj.use_segments:
        segments = jseg.build_segments(cj, np.asarray(s.codes), tile=cj.segment_tile)
    s = jengine.init_cluster_from(cj, s, jnp.asarray(Y0))
    co = jax.jit(lambda s: jengine.correct(cj, s, segments=segments, tiled=tiled, mesh=mesh))
    if "perms" in case:
        cl = jax.jit(lambda s, p: jengine.cluster(cj, s, perms=p, mesh=mesh, tiled=tiled))
        for r in range(ROUNDS):
            s = co(cl(s, jnp.asarray(np.asarray(case["perms"][r], np.int32))))
    else:
        rnd = jax.jit(lambda s: jengine.harmony_round(cj, s, segments=segments, tiled=tiled,
                                                      mesh=mesh))
        for _ in range(ROUNDS):
            s = rnd(s)
    return cj, s, jengine.materialize_r(cj, s, mesh=mesh)


def _f64(a):
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _lockstep(outs, cid):
    for other in outs[1:]:
        for f in ("objective_kmeans", "objective_harmony", "Y"):
            np.testing.assert_array_equal(other[f"{cid}/{f}"], outs[0][f"{cid}/{f}"])


@pytest.mark.parametrize("mode,N,n", JAX_CASES)
def test_mesh_route_matches_jax_mesh_engine(ranks, mode, N, n):
    the_spec, outs = ranks[n]
    cid = f"{mode}{N}"
    cj, sj, sjm = _jax_run(mode, N, n, next(c for c in the_spec["cases"] if c["id"] == cid))
    o = outs[0]
    want_layout = ("tiled" if MODES[mode].get("tiled")
                   else "segment" if mode == "segment" else "dense")
    assert str(o[cid + "/layout"][0]) == want_layout
    tj = sj.trace_lists(cj)
    np.testing.assert_array_equal(o[cid + "/kmeans_rounds"], tj["kmeans_rounds"])
    nk, nh = len(tj["objective_kmeans"]), len(tj["objective_harmony"])
    bf16 = MODES[mode].get("dtype") in ("bfloat16", "float16")
    rtol = BF16_RTOL if bf16 else 1e-5
    np.testing.assert_allclose(o[cid + "/objective_kmeans"][:nk], tj["objective_kmeans"],
                               rtol=rtol)
    np.testing.assert_allclose(o[cid + "/objective_harmony"][:nh], tj["objective_harmony"],
                               rtol=rtol)
    if bf16:
        zj, zt = _f64(sj.Z_corr), o[cid + "/Z_corr"].astype(np.float64)
        assert np.linalg.norm(zt - zj) / np.linalg.norm(zj) <= BF16_RTOL
        np.testing.assert_allclose(o[cid + "/R"][:, :N].sum(0), 1.0, atol=BF16_RTOL)
    else:
        for f, ref in (("Z_corr", sj.Z_corr), ("R", sjm.R), ("Y", sj.Y)):
            np.testing.assert_allclose(o[f"{cid}/{f}"], np.asarray(ref), rtol=0, atol=1e-4)
    # pad cells: zero R, Z_corr from their zero Z_orig
    assert (o[cid + "/R"][:, N:] == 0).all() and (o[cid + "/Z_corr"][:, N:] == 0).all()
    _lockstep(outs, cid)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode,N", OWN_CASES)
def test_per_round_routes_do_not_depend_on_the_mesh_size(ranks, mode, N, n):
    """The port's own draws on ``n`` ranks against one device: the global
    blocks and the lockstep generator give one trajectory."""
    _, outs = ranks[n]
    cid = f"own_{mode}{N}"
    ct, design, Zt, hp, Y0 = route_problem(tconfig, tpre, mode, N, tm._Size(1))
    assert ct.Np == N and str(ct.rotate_route) == str(outs[0][cid + "/route"][0])
    layout = tengine.mstep_layout(ct, design.codes, "cpu")
    st = tstate.init_state(ct, Zt, design, hp.sigma, hp.theta, hp.lamb, 3, "cpu")
    st = tengine.init_cluster_from(ct, st, Y0)
    for _ in range(ROUNDS):
        st = tengine.harmony_round(ct, st, layout=layout)
    tt = st.trace_lists(ct)
    o = outs[0]
    nk = len(tt["objective_kmeans"])
    np.testing.assert_allclose(o[cid + "/objective_kmeans"][:nk], tt["objective_kmeans"],
                               rtol=1e-4)
    np.testing.assert_allclose(o[cid + "/Z_corr"], st.Z_corr.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(o[cid + "/kmeans_rounds"], tt["kmeans_rounds"])
    # the ranks drew what one device drew, and nothing more
    np.testing.assert_array_equal(o[cid + "/generator"], st.generator.get_state().numpy())
    _lockstep(outs, cid)
    for other in outs[1:]:
        np.testing.assert_array_equal(other[cid + "/generator"], o[cid + "/generator"])


@pytest.mark.parametrize("n", SIZES)
def test_bf16_state_and_ingest_split_over_the_ranks(n):
    from harmony_tpu import config as jconfig
    from harmony_tpu import preprocess as jpre
    from harmony_tpu import state as jstate
    from harmony_tpu_torch.runtime import AsyncIngest

    N = 4094
    cj, design, Zt, hp, Y0 = route_problem(jconfig, jpre, "virtual_bf16", N, tm._jax_mesh(n))
    ct = route_problem(tconfig, tpre, "virtual_bf16", N, tm._Size(n))[0]
    assert ct.dtype == cj.dtype == "bfloat16" and ct.Np == cj.Np
    sj = jstate.init_state(cj, Zt, design, hp.sigma, hp.theta, hp.lamb, jax.random.PRNGKey(3))
    arrays = {f: np.asarray(getattr(sj, f)) for f in tstate.ARRAY_FIELDS}
    meshes = [tsh.CellMesh(r, n, torch.device("cpu")) for r in range(n)]
    parts = [tstate.state_from_arrays(ct, arrays, "cpu", mesh=m) for m in meshes]
    for f in tstate.CELL_FIELDS:
        if f not in arrays:
            continue
        assert all(getattr(p, f).dtype == (torch.int32 if f == "codes" else torch.bfloat16)
                   for p in parts)
        joined = np.concatenate([tstate.host_numpy(getattr(p, f)) for p in parts], axis=-1)
        np.testing.assert_array_equal(joined, _f64(arrays[f]).astype(joined.dtype))
    perm = np.random.default_rng(1).permutation(N)
    whole = AsyncIngest(Zt, ct, "cpu").result(perm)
    for m in meshes:
        lo, hi = tsh.cell_range(ct, m)
        mine = AsyncIngest(Zt, ct, "cpu", chunk_bytes=4096, mesh=m).result(perm)
        assert mine.dtype == torch.bfloat16
        assert torch.equal(mine.view(torch.int16), whole[:, lo:hi].view(torch.int16))


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
