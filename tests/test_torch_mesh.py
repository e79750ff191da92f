"""Multi-device runs of harmony_tpu_torch against the JAX package's mesh.

The port's ranks are processes joined by ``torch.distributed`` over gloo on
the CPU, one per shard, running the kernels' plain versions; the JAX side
runs the sharded wrappers and the engine on conftest's virtual CPU devices
with Pallas in interpret mode, as ``tests/test_sharded_pallas.py`` and
``tests/test_sharded_permute.py`` do. Each world size (2 and 4 ranks) is
started once for the module: a module fixture writes the randomness the
JAX package draws (each shard's (rotation, block order) from
``fold_in(round_key, shard)``, the permutations of the permute phase) to a
spec file, the ranks (this file run as a script) compute every case and
write their columns to an npz each, and the tests compare.

* The sharded wrappers at N = 4096 on 2 ranks and N = 3600 on 4 (pad
  cells in the last shard; 29 tiles of 128 before padding, which 4 shards
  do not divide), d
  = 8, K = 8, B = 3, block_size 0.25: K6 (Zn atol 1e-6; tile_O, O, E),
  K7 writing R with the fused moments and the penalty tables (R atol
  1e-5; E, O, M, the objective terms; the penalty stack and the global
  block ids), K10, K11, K8 and K9 (the sums at rtol 1e-4 of their largest
  entry, ``PERF.md`` §2's kernel-against-plain gates; the corrections at
  atol 1e-5).
* Three Harmony rounds against the JAX mesh engine (``tests/test_torch_
  rotate.py``'s slice, block_size 0.25 so each shard holds two tiles a
  block): the fused permute phase here (objective rtol 1e-4), the rotate
  route with R written (1e-5) and with virtual R (1e-4) in
  ``test_torch_mesh_rounds.py``, which starts its ranks from this file;
  Z_corr and R atol 1e-4.
  The JAX package's permute phase on a mesh slices its layout-tile table
  with the shards, so it is held at N = 4096, where shard boundaries fall
  on layout tiles; the port's phase at N = 4000 (boundaries inside tiles)
  is held to the port's own one-device phase, which its global blocks make
  the same trajectory (objective rtol 1e-5, Z_corr atol 1e-4).
* The gathered state (``state_to_arrays(mesh=)``) equals the JAX package's
  global arrays, virtual R's stacked penalty tables and global block ids
  included; the JAX arrays split into each rank's state
  (``state_from_arrays(mesh=)``, ``sharding.shard_state``) and rejoin; and every rank ends each case with the same centroids bit for
  bit; with the port's own draws every rank also ends with the same
  generator state.

Every rank has its own time limit; a rank that fails fails the tests.
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

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harmony_tpu_torch import config as tconfig  # noqa: E402
from harmony_tpu_torch import engine as tengine  # noqa: E402
from harmony_tpu_torch import preprocess as tpre  # noqa: E402
from harmony_tpu_torch import sharding as tsh  # noqa: E402
from harmony_tpu_torch import state as tstate  # noqa: E402
from harmony_tpu_torch.multihost_worker import free_port, json_line, run_ranks  # noqa: E402
from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate  # noqa: E402
from harmony_tpu_torch.ops import rotate as tr  # noqa: E402
from harmony_tpu_torch.ops.tiled import build_batch_tiled_order  # noqa: E402

SIZES = (2, 4)
RANK_TIMEOUT = 120.0
D, K, B, TILE, NJ = 8, 8, 3, 128, 3
# (N, world size) of the wrapper cases
WRAP_CASES = ((4096, 2), (3600, 4))
# (mode, N, world size) of the three-round slices against the JAX engine;
# the rotate and virtual ones are in test_torch_mesh_rounds.py
PERMUTE_CASES = (("permute", 4096, 2), ("permute", 4096, 4))
# the port's sharded permute phase against its one-device phase
OWN_PERMUTE = (4000, 4)
ROUNDS = 3


# ---- problems, built alike in the test process and in the ranks -----------

def wrap_config(mod, N: int, mesh):
    """The wrappers' config in package ``mod`` (harmony_tpu.config or the
    port's), padded and finalised for ``mesh``."""
    kw = dict(N=N, d=D, K=K, B=B, B_vec=(B,), shuffle_mode="rotate", block_size=0.25,
              estep_sub_tile=512)
    if mod is tconfig:
        return tconfig.finalize_engine_config(tsh.pad_for_mesh(tconfig.HarmonyConfig(**kw),
                                                               mesh), mesh)
    from harmony_tpu.sharding import pad_for_mesh

    cfg = pad_for_mesh(mod.HarmonyConfig(**kw, estep_impl="pallas"), mesh)
    return mod.finalize_engine_config(cfg, mesh)


def wrap_arrays(N: int, Np: int, seed: int) -> dict:
    """Global inputs of the wrapper cases, pad cells past N."""
    rng = np.random.default_rng(seed)
    Z = np.zeros((D, Np), np.float32)
    Z[:, :N] = 2.5 * rng.normal(size=(D, N))
    Zn = Z[:, :N] / np.linalg.norm(Z[:, :N], axis=0)
    Y = Zn[:, rng.choice(N, K, replace=False)] + 0.3 * rng.normal(size=(D, K))
    Y = (Y / np.linalg.norm(Y, axis=0)).astype(np.float32)
    codes = np.zeros((1, Np), np.int32)
    codes[0, :N] = rng.integers(0, B, N)
    Pr = (np.bincount(codes[0, :N], minlength=B) / N).astype(np.float32)
    Zo = np.zeros((D, Np), np.float32)
    Zo[:, :N] = rng.normal(size=(D, N))
    Rr = rng.uniform(0.1, 1.0, (K, Np)).astype(np.float32)
    Rr[:, N:] = 0.0
    Rr /= np.maximum(Rr.sum(0), 1e-30)
    W = (0.1 * rng.normal(size=(NJ + 1, D, K))).astype(np.float32)
    W[NJ] = 0.0
    tj = rng.integers(0, NJ + 1, Np // TILE).astype(np.int32)
    return dict(Z=Z, Y=Y, codes=codes, Pr=Pr, sigma=rng.uniform(0.08, 0.15, K).astype(np.float32),
                theta=rng.uniform(1.0, 2.0, B).astype(np.float32), Zo=Zo, Rr=Rr, W=W, tj=tj)


def engine_problem(mod, pre, mode: str, N: int, mesh):
    """tests/test_torch_rotate.py's slice for a mesh, in package ``mod``
    (config) with its ``pre`` (preprocess): (config, design in a
    batch-tiled order at tile 128, cells, hyperparameters, centroids)."""
    rng = np.random.default_rng(7)
    batches = rng.integers(0, B, N)
    Z = rng.normal(size=(N, D)).astype(np.float32)
    design = pre.build_design({"dataset": batches}, ["dataset"])
    opts = mod.harmony_options(block_size=0.25)
    cfg = pre.resolve_config(design=design, options=opts, n_cells=N, d=D, nclust=K,
                             max_iter=ROUNDS, early_stop=False, verbose=False,
                             lambda_estimation=True)
    over = dict(shuffle_mode="permute" if mode == "permute" else "rotate",
                estep_sub_tile=512, mstep_tile=128, mstep_mode="tiled",
                virtual_r=mode == "virtual")
    if mod is tconfig:
        cfg = dataclasses.replace(cfg, estep_impl="kernel", mstep_impl="kernel",
                                  permute_fused=True if mode == "permute" else None, **over)
        cfg = tconfig.finalize_engine_config(tsh.pad_for_mesh(cfg, mesh), mesh)
    else:
        from harmony_tpu.sharding import pad_for_mesh

        cfg = dataclasses.replace(cfg, estep_impl="pallas", **over)
        cfg = mod.finalize_engine_config(pad_for_mesh(cfg, mesh), mesh)
    perm, _ = build_batch_tiled_order(design.codes, 128, seed=0)
    Zt = pre.orient_embedding(Z, N)[:, perm]
    design = dataclasses.replace(design, codes=design.codes[:, perm])
    hp = pre.expand_hyperparams(design, cfg.K, None, 0.1, None, opts.tau)
    Y0 = Zt[:, rng.choice(N, cfg.K, replace=False)]
    return cfg, design, Zt, hp, Y0


class _Size:
    """A mesh of ``size`` shards as the config functions read it."""

    def __init__(self, size):
        self.size = size


def jax_schedule(NT: int, nb: int, key):
    """(rt, order) as the JAX round draws them from a shard's key
    (pallas_rotate.py:550-566)."""
    k1, k2 = jax.random.split(key)
    return (int(jax.random.randint(k1, (), 0, NT)),
            [int(b) for b in jax.random.permutation(k2, nb)])


def shard_schedules(key, n: int, NT: int, nb: int):
    """Every shard's (rt, order) of a round key: fold_in(key, shard)."""
    return [jax_schedule(NT, nb, jax.random.fold_in(key, s)) for s in range(n)]


# ---- the ranks -------------------------------------------------------------

def _t(a):
    return torch.as_tensor(np.array(a, order="C"))


def _rank_wrap(case, mesh, out):
    N = case["N"]
    ct = wrap_config(tconfig, N, mesh)
    assert (ct.estep_sub_tile, ct.Np) == tuple(case["geometry"])
    a = wrap_arrays(N, ct.Np, case["seed"])
    lo, hi = tsh.cell_range(ct, mesh)
    Y, Pr, sig, th = _t(a["Y"]), _t(a["Pr"]), _t(a["sigma"]), _t(a["theta"])
    cp = tr.make_codes_pad(ct, _t(a["codes"][:, lo:hi]), mesh)
    Zo = _t(a["Zo"][:, lo:hi])
    Zn, tO, O, E, G = tr.sharded_reassign(ct, mesh, Y, sig, Pr, _t(a["Z"][:, lo:hi]), cp,
                                          fn=cuda_rotate.reassign)
    plain = tr.sharded_reassign(ct, mesh, Y, sig, Pr, _t(a["Z"][:, lo:hi]), cp)
    assert all(torch.equal(x, y) for x, y in zip(plain, (Zn, tO, O, E, G)))
    rs = tr.RoundState(R=torch.full((K, hi - lo), 0.5), E=E, O=O, tile_O=tO,
                       kmeans_error=None, entropy=None)
    mom = tr.MomentsSpec(Z_orig=Zo, tile_joint=a["tj"][lo // TILE:hi // TILE], n_joint=NJ,
                         tile=TILE)
    sched = tr.schedule_table([case["schedules"][mesh.rank]])[0]
    res = tr.sharded_rotate_round_v2(ct, mesh, Y, rs, Pr, sig, th, sched,
                                     tr.CodesLayout(Zn, cp, G), True, mom, True,
                                     fn=cuda_rotate.rotate_update_round_v2)
    Zv = tr.sharded_virtual_correction(ct, mesh, _t(a["W"]), a["tj"], TILE, Y, sig, res.pen,
                                       res.blkmap, Zn, cp, Zo, G,
                                       fn=cuda_rotate.virtual_correction)
    Rm = tr.sharded_materialize_r(ct, mesh, Y, sig, res.pen, res.blkmap, Zn, cp,
                                  fn=cuda_rotate.materialize_r)
    # the kernel wrappers run the plain versions on CPU tensors
    pres = tr.sharded_rotate_round_v2(ct, mesh, Y, rs, Pr, sig, th, sched,
                                      tr.CodesLayout(Zn, cp, G), True, mom, True)
    assert all(torch.equal(getattr(pres, f), getattr(res, f))
               for f in ("R", "E", "O", "tile_O", "M", "pen", "blkmap"))
    assert torch.equal(Zv, tr.sharded_virtual_correction(
        ct, mesh, _t(a["W"]), a["tj"], TILE, Y, sig, res.pen, res.blkmap, Zn, cp, Zo, G))
    assert torch.equal(Rm, tr.sharded_materialize_r(ct, mesh, Y, sig, res.pen, res.blkmap,
                                                    Zn, cp))
    Rr = _t(a["Rr"][:, lo:hi])
    M8 = cuda_ridge.sharded_tile_moments(ct, mesh, Rr, Zo, TILE, a["tj"], NJ)
    Z9 = cuda_ridge.sharded_tiled_correction(ct, mesh, _t(a["W"]), a["tj"], Rr, Zo, TILE)
    for k, v in dict(Zn=Zn, tO=tO, O=O, E=E, R=res.R, rE=res.E, rO=res.O, rtO=res.tile_O,
                     kerr=res.kmeans_error, ent=res.entropy, M=res.M, pen=res.pen,
                     blk=res.blkmap, Zv=Zv, Rm=Rm, M8=M8, Z9=Z9).items():
        out[f"{case['id']}/{k}"] = v.numpy()


def _rank_engine(case, mesh, out):
    ct, design, Zt, hp, Y0 = engine_problem(tconfig, tpre, case["mode"], case["N"], mesh)
    if "geometry" in case:
        assert (ct.estep_sub_tile, ct.Np) == tuple(case["geometry"])
    layout = tengine.mstep_layout(ct, design.codes)
    assert layout.tiled is not None
    st = tstate.init_state(ct, Zt, design, hp.sigma, hp.theta, hp.lamb, 3, "cpu", mesh=mesh)
    st = tengine.init_cluster_from(ct, st, Y0, mesh)
    for r in range(ROUNDS):
        kw = {}
        if "perms" in case:
            kw["perms"] = np.asarray(case["perms"][r])
        elif "schedules" in case:
            kw["schedules"] = tr.schedule_table([s[mesh.rank] for s in case["schedules"][r]])
        st = tengine.correct(ct, tengine.cluster(ct, st, tiled=layout.tiled, mesh=mesh, **kw),
                             layout, mesh)
    arrays = tstate.state_to_arrays(st, mesh=mesh)
    st = tengine.materialize_r(ct, st, mesh)
    R = tsh.gather_cells(st.R, mesh)
    cid = case["id"]
    for f in ("Z_corr", "O", "E", "objective_kmeans", "objective_harmony", "kmeans_rounds",
              "virt_pen", "virt_blkmap", "virt_Zn", "codes"):
        if f in arrays:
            out[f"{cid}/{f}"] = arrays[f]
    out[f"{cid}/R"] = R.numpy()
    out[f"{cid}/Y"] = st.Y.numpy()
    out[f"{cid}/generator"] = st.generator.get_state().numpy()


def _rank_main(argv):
    rank, world, port, spec_path, out_path = argv
    torch.set_num_threads(1)
    tsh.initialize_distributed("gloo", f"tcp://localhost:{port}", int(world), int(rank),
                               timeout=RANK_TIMEOUT)
    mesh = tsh.make_mesh("cpu")
    with open(spec_path) as fh:
        spec = json.load(fh)
    out = {}
    for case in spec["cases"]:
        (_rank_wrap if case["kind"] == "wrap" else _rank_engine)(case, mesh, out)
    np.savez(out_path, **{k.replace("/", "__"): v for k, v in out.items()})
    print(json.dumps({"rank": mesh.rank, "ok": True}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ---- the JAX side and the fixtures ----------------------------------------

def _jax_mesh(n):
    from harmony_tpu.sharding import make_mesh

    return make_mesh(n)


def spec(n: int, wrap=(), engine=(), own=False) -> dict:
    """The cases a world of ``n`` ranks computes, with the JAX draws: the
    wrapper cases of ``wrap`` and the three-round slices of ``engine`` at
    this size, and with ``own`` the port's permute phase against its
    one-device phase and a run on the port's own draws."""
    from harmony_tpu import config as jconfig
    from harmony_tpu import preprocess as jpre

    mesh = _jax_mesh(n)
    cases = []
    for N in [N for N, size in wrap if size == n]:
        cj = wrap_config(jconfig, N, mesh)
        NT = cj.Np // n // cj.estep_sub_tile
        cases.append(dict(kind="wrap", id=f"wrap{N}", N=N, seed=N + n,
                          geometry=[cj.estep_sub_tile, cj.Np],
                          schedules=shard_schedules(jax.random.PRNGKey(N), n, NT,
                                                    min(cj.n_blocks, NT))))
    for mode, N, size in engine:
        if size != n:
            continue
        cj = engine_problem(jconfig, jpre, mode, N, mesh)[0]
        case = dict(kind="engine", id=f"{mode}{N}", mode=mode, N=N,
                    geometry=[cj.estep_sub_tile, cj.Np])
        if mode == "permute":
            rng = np.random.default_rng(11)
            case["perms"] = [[rng.permutation(N).tolist() for _ in range(cj.max_iter_cluster)]
                             for _ in range(ROUNDS)]
        else:
            NT = cj.Np // n // cj.estep_sub_tile
            nb = min(cj.n_blocks, NT)
            key, sched = jax.random.PRNGKey(3), []
            for _ in range(ROUNDS):
                key, sub = jax.random.split(key)
                sched.append([shard_schedules(k, n, NT, nb)
                              for k in jax.random.split(sub, cj.max_iter_cluster)])
            case["schedules"] = sched
        cases.append(case)
    if own and n == OWN_PERMUTE[1]:
        N = OWN_PERMUTE[0]
        rng = np.random.default_rng(12)
        perms = [[rng.permutation(N).tolist() for _ in range(4)] for _ in range(ROUNDS)]
        cases.append(dict(kind="engine", id=f"own_permute{N}", mode="permute", N=N,
                          perms=perms))
    if own:
        # the port's own draws: the generator in lockstep
        cases.append(dict(kind="engine", id="own_rotate", mode="rotate", N=4096))
    return {"cases": cases}


def start_ranks(d, n: int, the_spec: dict) -> list:
    """Run ``n`` ranks of this file on ``the_spec`` in directory ``d``,
    each within RANK_TIMEOUT (all killed on expiry); every rank must
    succeed. Returns each rank's outputs."""
    spec_path = str(d / "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(the_spec, fh)
    port = free_port()
    res = run_ranks([[sys.executable, os.path.abspath(__file__), str(r), str(n), str(port),
                      spec_path, str(d / f"rank{r}.npz")] for r in range(n)],
                    RANK_TIMEOUT, cwd=ROOT)
    bad = [(r, rc, se[-3000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
    assert not bad, f"ranks failed or timed out: {bad}"
    assert all(json_line(so)["ok"] for _, so, _ in res)
    loaded = []
    for r in range(n):
        with np.load(str(d / f"rank{r}.npz")) as z:
            loaded.append({k.replace("__", "/"): z[k] for k in z.files})
    return loaded


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: (spec, [each rank's outputs])}, each world started once."""
    out = {}
    for n in SIZES:
        the_spec = spec(n, WRAP_CASES, PERMUTE_CASES, own=True)
        out[n] = (the_spec, start_ranks(tmp_path_factory.mktemp(f"mesh{n}"), n, the_spec))
    return out


def _cells(outs, key):
    """A cell-axis output of every rank, joined in rank order."""
    return np.concatenate([o[key] for o in outs], axis=-1)


def _sum_close(a, b, rtol):
    """max |a - b| <= rtol * max |b| (PERF.md §2's gate for sums)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-30), (
        np.max(np.abs(a - b)), np.max(np.abs(b)))


# ---- the tests -------------------------------------------------------------

@pytest.mark.parametrize("N,n", WRAP_CASES)
def test_sharded_wrappers_match_jax(ranks, N, n):
    from harmony_tpu import config as jconfig
    from harmony_tpu.ops import pallas_ridge as jrd
    from harmony_tpu.ops import pallas_rotate as jpr

    the_spec, outs = ranks[n]
    case = next(c for c in the_spec["cases"] if c["id"] == f"wrap{N}")
    mesh = _jax_mesh(n)
    cj = wrap_config(jconfig, N, mesh)
    a = wrap_arrays(N, cj.Np, case["seed"])
    j = {k: jnp.asarray(v) for k, v in a.items()}
    cp = jpr.make_codes_pad(cj, j["codes"])
    Zn, tO, O, E = jpr.sharded_reassign(cj, mesh, j["Y"], j["sigma"], j["Pr"],
                                        jpr.pad_cells_to_tile(cj, j["Z"]), cp, interpret=True)
    pre = case["id"] + "/"
    np.testing.assert_allclose(_cells(outs, pre + "Zn"), np.asarray(Zn), rtol=0, atol=1e-6)
    _sum_close(np.concatenate([o[pre + "tO"] for o in outs]), tO, 1e-5)
    for r in range(n):
        _sum_close(outs[r][pre + "O"], O, 1e-4)
        _sum_close(outs[r][pre + "E"], E, 1e-4)
    rs = jpr.RoundState(R=jnp.full((K, cj.Np), 0.5, jnp.float32), E=E, O=O, tile_O=tO,
                        kmeans_error=jnp.float32(0), entropy=jnp.float32(0))
    mom = jpr.MomentsSpec(Z_orig_pad=j["Zo"], tile_joint=j["tj"], n_joint=NJ, tile=TILE)
    res, M, (pen, blk) = jpr.sharded_rotate_round_v2(
        cj, mesh, j["Y"], rs, j["Pr"], j["sigma"], j["theta"], jax.random.PRNGKey(N),
        layout=jpr.CodesLayout(Z_pad=Zn, codes_pad=cp), interpret=True, write_r=True,
        moments=mom, emit_pen=True)
    np.testing.assert_allclose(_cells(outs, pre + "R"), np.asarray(res.R), rtol=0, atol=1e-5)
    _sum_close(np.concatenate([o[pre + "rtO"] for o in outs]), res.tile_O, 1e-5)
    for r in range(n):
        for k, ref in (("rE", res.E), ("rO", res.O), ("M", M)):
            _sum_close(outs[r][pre + k], ref, 1e-4)
        np.testing.assert_allclose(outs[r][pre + "kerr"], float(res.kmeans_error), rtol=1e-4)
        np.testing.assert_allclose(outs[r][pre + "ent"], float(res.entropy), rtol=1e-4)
    # each rank keeps its own tables; stacked in rank order they are JAX's
    # (size * nb, K, B), and the map's global block ids are JAX's
    np.testing.assert_array_equal(np.concatenate([o[pre + "blk"] for o in outs]),
                                  np.asarray(blk))
    pen_t = np.concatenate([o[pre + "pen"] for o in outs])
    assert pen_t.shape == np.asarray(pen).shape
    np.testing.assert_allclose(pen_t, np.asarray(pen), rtol=1e-4)
    Zv = jpr.sharded_virtual_correction(cj, mesh, j["W"], j["tj"], TILE, j["Y"], j["sigma"],
                                        pen, blk, Zn, cp, j["Zo"], interpret=True)
    np.testing.assert_allclose(_cells(outs, pre + "Zv"), np.asarray(Zv), rtol=0, atol=1e-5)
    Rm = jpr.sharded_materialize_r(cj, mesh, j["Y"], j["sigma"], pen, blk, Zn, cp,
                                   interpret=True)
    np.testing.assert_allclose(_cells(outs, pre + "Rm"), np.asarray(Rm), rtol=0, atol=1e-5)
    M8 = jrd.sharded_tile_moments(cj, mesh, j["Rr"], j["Zo"], TILE, j["tj"], NJ,
                                  interpret=True)
    Z9 = jrd.sharded_tiled_correction(cj, mesh, j["W"], j["tj"], j["Rr"], j["Zo"], TILE,
                                      interpret=True)
    for r in range(n):
        _sum_close(outs[r][pre + "M8"], M8, 1e-4)
    np.testing.assert_allclose(_cells(outs, pre + "Z9"), np.asarray(Z9), rtol=0, atol=1e-5)


def _jax_engine_run(mode, N, n, case):
    """ROUNDS rounds of the JAX engine on the mesh, the same centroids and
    randomness; returns the final state, virtual R materialised apart."""
    from harmony_tpu import config as jconfig
    from harmony_tpu import engine as jengine
    from harmony_tpu import preprocess as jpre
    from harmony_tpu import state as jstate
    from harmony_tpu.ops import tiled as jtiled
    from harmony_tpu.sharding import shard_state

    mesh = _jax_mesh(n)
    cj, design, Zt, hp, Y0 = engine_problem(jconfig, jpre, mode, N, mesh)
    s = jstate.init_state(cj, Zt, design, hp.sigma, hp.theta, hp.lamb, jax.random.PRNGKey(3))
    s = shard_state(s, mesh)
    tiled = jtiled.detect_tiled_layout(np.asarray(s.codes), cj.N, 128)
    assert tiled is not None
    s = jengine.init_cluster_from(cj, s, jnp.asarray(Y0))
    if mode == "permute":
        cl = jax.jit(lambda s, p: jengine.cluster(cj, s, perms=p, mesh=mesh, tiled=tiled))
        co = jax.jit(lambda s: jengine.correct(cj, s, tiled=tiled, mesh=mesh))
        for r in range(ROUNDS):
            s = co(cl(s, jnp.asarray(np.asarray(case["perms"][r], np.int32))))
    else:
        rnd = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled, mesh=mesh))
        for _ in range(ROUNDS):
            s = rnd(s)
    return cj, s, jengine.materialize_r(cj, s, mesh=mesh)


def check_three_rounds(ranks, mode, N, n):
    """The ranks' slice ``mode`` at N against ROUNDS rounds of the JAX mesh
    engine (see the module docstring for the bounds)."""
    the_spec, outs = ranks[n]
    cid = f"{mode}{N}"
    cj, sj, sjm = _jax_engine_run(mode, N, n,
                                  next(c for c in the_spec["cases"] if c["id"] == cid))
    o = outs[0]
    tj = sj.trace_lists(cj)
    obj_rtol = 1e-5 if mode == "rotate" else 1e-4
    np.testing.assert_array_equal(o[cid + "/kmeans_rounds"], tj["kmeans_rounds"])
    nk, nh = len(tj["objective_kmeans"]), len(tj["objective_harmony"])
    np.testing.assert_allclose(o[cid + "/objective_kmeans"][:nk], tj["objective_kmeans"],
                               rtol=obj_rtol)
    np.testing.assert_allclose(o[cid + "/objective_harmony"][:nh], tj["objective_harmony"],
                               rtol=obj_rtol)
    np.testing.assert_allclose(o[cid + "/Z_corr"], np.asarray(sj.Z_corr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(o[cid + "/R"], np.asarray(sjm.R), rtol=0, atol=1e-4)
    # the gathered state is the JAX package's global state
    np.testing.assert_array_equal(o[cid + "/codes"], np.asarray(sj.codes))
    for f in ("O", "E"):
        _sum_close(o[f"{cid}/{f}"], np.asarray(getattr(sj, f)), 1e-4)
    if mode == "virtual":
        assert sj.virt_pen is not None
        np.testing.assert_array_equal(o[cid + "/virt_blkmap"], np.asarray(sj.virt_blkmap))
        assert o[cid + "/virt_pen"].shape == np.asarray(sj.virt_pen).shape
        np.testing.assert_allclose(o[cid + "/virt_pen"], np.asarray(sj.virt_pen), rtol=1e-3)
        np.testing.assert_allclose(o[cid + "/virt_Zn"], np.asarray(sj.virt_Zn), rtol=0,
                                   atol=1e-4)
    else:
        assert cid + "/virt_pen" not in o
    # lockstep: every rank holds the same centroids, bit for bit
    for other in outs[1:]:
        np.testing.assert_array_equal(other[cid + "/Y"], o[cid + "/Y"])


@pytest.mark.parametrize("mode,N,n", PERMUTE_CASES)
def test_three_permute_rounds_match_jax_mesh_engine(ranks, mode, N, n):
    check_three_rounds(ranks, mode, N, n)


def test_sharded_permute_phase_matches_one_device_phase(ranks):
    """Global blocks: the port's phase on 4 ranks, shard boundaries inside
    layout tiles at N = 4000, against the one-device phase (the plain
    versions) on the same permutations."""
    N, n = OWN_PERMUTE
    the_spec, outs = ranks[n]
    cid = f"own_permute{N}"
    case = next(c for c in the_spec["cases"] if c["id"] == cid)

    class One:
        size = 1

    ct, design, Zt, hp, Y0 = engine_problem(tconfig, tpre, "permute", N, One())
    layout = tengine.mstep_layout(ct, design.codes)
    st = tstate.init_state(ct, Zt, design, hp.sigma, hp.theta, hp.lamb, 3, "cpu")
    st = tengine.init_cluster_from(ct, st, Y0)
    for r in range(ROUNDS):
        st = tengine.correct(ct, tengine.cluster(ct, st, perms=np.asarray(case["perms"][r]),
                                                 tiled=layout.tiled), layout)
    tt = st.trace_lists(ct)
    o = outs[0]
    nk = len(tt["objective_kmeans"])
    np.testing.assert_allclose(o[cid + "/objective_kmeans"][:nk], tt["objective_kmeans"],
                               rtol=1e-5)
    np.testing.assert_allclose(o[cid + "/Z_corr"][:, :N], st.Z_corr.numpy()[:, :N], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(o[cid + "/R"][:, :N], st.R.numpy()[:, :N], rtol=0, atol=1e-4)
    assert (o[cid + "/R"][:, N:] == 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_ranks_stay_in_lockstep_on_their_own_draws(ranks, n):
    """Three rounds with the port's own draws: every rank draws every
    shard's schedule from the replicated generator and takes its own, so
    the generators and the centroids stay equal bit for bit."""
    _, outs = ranks[n]
    for other in outs[1:]:
        np.testing.assert_array_equal(other["own_rotate/Y"], outs[0]["own_rotate/Y"])
        np.testing.assert_array_equal(other["own_rotate/generator"],
                                      outs[0]["own_rotate/generator"])
    tr_ = outs[0]["own_rotate/objective_harmony"]
    assert np.isfinite(tr_[: ROUNDS + 1]).all() and tr_[ROUNDS] < tr_[0]


def test_jax_state_crosses_to_the_ranks():
    """The JAX package's global arrays split into each rank's state
    (state_from_arrays(mesh=)): its columns, its rows of the stacked
    penalty tables and its tiles' global block ids; rejoined in rank order
    they are the JAX arrays."""
    n = 2
    # a JAX virtual state of the shapes the engine makes, from the slice
    from harmony_tpu import config as jconfig
    from harmony_tpu import preprocess as jpre

    mesh = _jax_mesh(n)
    cj = engine_problem(jconfig, jpre, "virtual", 4096, mesh)[0]
    ct = engine_problem(tconfig, tpre, "virtual", 4096, _Size(n))[0]
    rng = np.random.default_rng(5)
    NT = ct.Np // ct.estep_sub_tile
    nb = min(ct.n_blocks, NT // n)
    arrays = {f: rng.normal(size=s).astype(np.float32) for f, s in (
        ("Z_orig", (D, ct.Np)), ("Z_corr", (D, ct.Np)), ("Y", (D, K)), ("R", (K, ct.Np)),
        ("O", (K, B)), ("E", (K, B)), ("Pr_b", (B,)), ("batch_sizes", (B,)), ("sigma", (K,)),
        ("theta", (B,)), ("lamb", (B + 1,)), ("virt_pen", (n * nb, K, B)),
        ("virt_Zn", (D, ct.Np)), ("virt_Y", (D, K)))}
    arrays["codes"] = rng.integers(0, B, (1, ct.Np)).astype(np.int32)
    arrays["virt_blkmap"] = np.concatenate(
        [rng.integers(0, nb, NT // n) + s * nb for s in range(n)]).astype(np.int32)
    for f in ("objective_kmeans", "objective_kmeans_dist", "objective_kmeans_entropy",
              "objective_kmeans_cross"):
        arrays[f] = np.zeros(ct.kmeans_trace_capacity, np.float32)
    arrays["objective_harmony"] = np.zeros(ct.harmony_trace_capacity, np.float32)
    arrays["kmeans_rounds"] = np.zeros(ct.max_iter_harmony, np.int32)
    for f in ("n_kmeans", "n_harmony", "n_rounds"):
        arrays[f] = np.asarray(0, np.int32)
    assert (cj.Np, cj.estep_sub_tile) == (ct.Np, ct.estep_sub_tile)
    parts = [tstate.state_from_arrays(ct, arrays, "cpu",
                                      mesh=tsh.CellMesh(r, n, torch.device("cpu")))
             for r in range(n)]
    for f in tstate.CELL_FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f).numpy() for p in parts], axis=-1), arrays[f])
    np.testing.assert_array_equal(np.concatenate([p.virt_pen.numpy() for p in parts]),
                                  arrays["virt_pen"])
    np.testing.assert_array_equal(np.concatenate([p.virt_blkmap.numpy() for p in parts]),
                                  arrays["virt_blkmap"])
    whole = tstate.state_from_arrays(ct, arrays, "cpu")
    for r, p in enumerate(parts):
        # a state of the whole axis cut to the rank's part is the same
        cut = tsh.shard_state(whole, ct, tsh.CellMesh(r, n, torch.device("cpu")))
        for f in tstate.CELL_FIELDS + ("virt_pen", "virt_blkmap", "Y", "O"):
            assert torch.equal(getattr(cut, f), getattr(p, f)), f
        # each rank's map points into its own tables only
        local = tr.local_blocks(tsh.CellMesh(r, n, torch.device("cpu")), p.virt_pen,
                                p.virt_blkmap)
        assert int(local.min()) >= 0 and int(local.max()) < nb
        np.testing.assert_array_equal(p.Y.numpy(), arrays["Y"])


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
