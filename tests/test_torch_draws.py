"""The port's own draws, held to the JAX package's statistical criteria.

Every trajectory test of the port injects the JAX package's draws
(``jax.random`` and ``torch.Generator`` streams never match). Here nothing
is injected: the port draws its k-means init (``ops/kmeans.py``), its
(rotation, block order) pairs (``ops/rotate.draw_schedules``,
``engine.draw_shard_schedules`` on a mesh, ``ops/estep.draw_rotate_schedules``
for the cell-granular round) and its per-round permutations
(``engine.cluster``) from the run's ``torch.Generator``.

* (a) The sweep of tests/test_schedule_equivalence.py (2,048 x 10 cells, 3
  batches, ``nclust=8``, ``max_iter=6``, seeds 0-2, its generator copied)
  through run_harmony's steps on the CPU
  (``multihost_worker.driver_result``, ``device="cpu"``) on five routes:
  per-round permute, the fused permute phase, the stats carry
  (``block_size=0.25``), the two-phase rounds (``rotate_stats_carry=False``)
  and the cell-granular round (the default block size: 2,048 < 20 x 128
  cells). A module fixture runs the JAX package's own sweep (its
  ``permute`` and ``rotate1``) on the same problems and seeds. The criteria
  of tests/test_schedule_equivalence.py:63-93: per seed every port route
  and the JAX schedules lie within 5% of their mean; each port route's gap
  to the JAX permute is no wider than the JAX permute's seed-to-seed spread
  or 2% of its mean; the largest chi^2 is at most 1.3x the smallest.
* (b) The mesh leg: the carry and per-round permute routes on 2 and 4 gloo
  ranks (this file run as a script, one world a size for the module), the
  same seeds and criteria; the ranks' generators end in the same state, and
  the pairs ``draw_shard_schedules`` gives the ranks are those of one draw
  of ``rounds x size`` pairs, dealt by rank.
* (c) The draws themselves: 20,000 pairs from ``draw_schedules`` and from
  ``draw_rotate_schedules`` at a fixed seed, each rotation and each block's
  position in the order uniform by a chi^2 goodness of fit at p > 1e-3 (the
  seed is fixed, so the test is deterministic); the k-means init's picks lie
  within ``n_valid`` and are distinct; the same seed twice gives the same
  run bit for bit, another seed another run.
"""

from __future__ import annotations

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
from scipy import stats  # noqa: E402

from harmony_tpu_torch import config as tconfig  # noqa: E402
from harmony_tpu_torch import engine as tengine  # noqa: E402
from harmony_tpu_torch.multihost_worker import driver_result  # noqa: E402
from harmony_tpu_torch.ops import estep as testep  # noqa: E402
from harmony_tpu_torch.ops import kmeans as tkmeans  # noqa: E402
from harmony_tpu_torch.ops import rotate as trotate  # noqa: E402

SEEDS = (0, 1, 2)
# route: (shuffle mode, block size, config changes, resolved rotate route)
ROUTES = {
    "permute": ("permute", 0.25, {}, None),
    "permute_fused": ("permute", 0.25, {"permute_fused": True}, None),
    "carry": ("rotate", 0.25, {}, "carry"),
    "two_phase": ("rotate", 0.25, {"rotate_stats_carry": False}, "two_phase"),
    "cell": ("rotate", 0.05, {}, "cell"),
}
MESH_ROUTES = ("carry", "permute")
MESH_SIZES = (2, 4)
RANK_TIMEOUT = 240.0
N_DRAWS = 20_000
P_MIN = 1e-3


def _problem(seed):
    """tests/test_schedule_equivalence.py's problem, copied."""
    rng = np.random.default_rng(100 + seed)
    n, d, nb = 2048, 10, 3
    batches = rng.integers(0, nb, n)
    Z = (rng.normal(size=(nb, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    return Z, {"dataset": np.array([f"b{i}" for i in batches])}


def _chi2(O, E) -> float:
    O, E = np.asarray(O, np.float64), np.asarray(E, np.float64)
    return float(((O - E) ** 2 / np.maximum(E, 1e-12)).sum())


def _final(res):
    oh = np.asarray(res.objective_harmony)
    oh = oh[oh != 0]
    return float(oh[-1]), _chi2(res.O, res.E)


def port_run(route: str, seed: int, mesh=None, run_seed=None):
    """The port on ``route`` with its own draws on the problem of ``seed``,
    the run seeded with ``run_seed`` (default ``seed``): run_harmony's
    steps."""
    shuffle, block, change, _ = ROUTES[route]
    Z, meta = _problem(seed)
    return driver_result(Z, meta, mesh, 8, 6, seed if run_seed is None else run_seed, shuffle,
                         tconfig.harmony_options(block_size=block), device="cpu", **change)


# ---- the ranks of the mesh leg ---------------------------------------------

def _rank_main(argv):
    from harmony_tpu_torch import sharding

    rank, world, port, out_path = argv
    torch.set_num_threads(1)
    sharding.initialize_distributed("gloo", f"tcp://localhost:{port}", int(world), int(rank),
                                    timeout=RANK_TIMEOUT)
    mesh = sharding.make_mesh("cpu")
    out = {}
    for route in MESH_ROUTES:
        for seed in SEEDS:
            res = port_run(route, seed, mesh)
            cfg = res.config
            assert cfg.n_shards == mesh.size
            obj, chi2 = _final(res)
            out[f"{route}{seed}__final"] = np.asarray([obj, chi2])
            out[f"{route}{seed}__generator"] = res.state.generator.get_state().numpy()
            out[f"{route}{seed}__route"] = np.asarray([str(cfg.rotate_route)])
    # the dealing: this rank's pairs of 3 rounds over 8 tiles a shard
    cfg = tconfig.HarmonyConfig(
        N=8 * 512 * mesh.size, d=4, K=4, B=2, B_vec=(2,), shuffle_mode="rotate",
        block_size=0.25, estep_sub_tile=512)
    g = torch.Generator()
    g.manual_seed(11)
    pairs = trotate.schedule_pairs(tengine.draw_shard_schedules(cfg, g, 3, mesh, 8))
    out["deal__rt"] = np.asarray([p[0] for p in pairs])
    out["deal__order"] = np.asarray([p[1] for p in pairs])
    np.savez(out_path, **out)
    print(json.dumps({"rank": mesh.rank, "ok": True}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ---- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sweep():
    """{(schedule, seed): (final objective, chi^2)}: the JAX package's own
    permute and single-device rotate schedules on the same problems."""
    from harmony_tpu.api import run_harmony
    from harmony_tpu.config import harmony_options

    out = {}
    for seed in SEEDS:
        Z, meta = _problem(seed)
        for name, kw in (("permute", dict(shuffle_mode="permute")),
                         ("rotate1", dict(shuffle_mode="rotate", estep_impl="pallas"))):
            res = run_harmony(Z, meta, ["dataset"], nclust=8, max_iter=6, seed=seed,
                              options=harmony_options(block_size=0.25), return_object=True,
                              **kw)
            oh = np.asarray(res.objective_harmony)
            oh = oh[oh != 0]
            out[(name, seed)] = (float(oh[-1]), _chi2(res.O, res.E))
    return out


@pytest.fixture(scope="module")
def port_sweep():
    """{(route, seed): (final objective, chi^2)} of the port on one device."""
    out = {}
    for route, (_, _, _, want) in ROUTES.items():
        for seed in SEEDS:
            res = port_run(route, seed)
            assert res.config.rotate_route == want, (route, res.config.rotate_route)
            if route == "permute_fused":
                assert res.config.permute_fused
            out[(route, seed)] = _final(res)
    return out


@pytest.fixture(scope="module")
def mesh_sweep(tmp_path_factory):
    """{size: [each rank's outputs]} of the mesh leg."""
    from harmony_tpu_torch.multihost_worker import free_port, json_line, run_ranks

    d = tmp_path_factory.mktemp("draws_mesh")
    out = {}
    for n in MESH_SIZES:
        port = free_port()
        res = run_ranks([[sys.executable, os.path.abspath(__file__), str(r), str(n), str(port),
                          str(d / f"out{n}_{r}.npz")] for r in range(n)], RANK_TIMEOUT, cwd=ROOT)
        bad = [(r, rc, se[-3000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
        assert not bad, f"ranks failed or timed out: {bad}"
        assert all(json_line(so)["ok"] for _, so, _ in res)
        loaded = []
        for r in range(n):
            with np.load(str(d / f"out{n}_{r}.npz")) as z:
                loaded.append({k: z[k] for k in z.files})
        out[n] = loaded
    return out


# ---- (a) and (b): the criteria of tests/test_schedule_equivalence.py --------

def _hold(finals: dict, jax_sweep: dict, names) -> None:
    """Hold ``finals[(name, seed)] = (objective, chi^2)`` of each of
    ``names`` to the three criteria against the JAX sweep."""
    for seed in SEEDS:
        objs = ([finals[(n, seed)][0] for n in names]
                + [jax_sweep[(j, seed)][0] for j in ("permute", "rotate1")])
        assert max(objs) - min(objs) <= 0.05 * abs(np.mean(objs)), (seed, objs)
        chis = ([finals[(n, seed)][1] for n in names]
                + [jax_sweep[(j, seed)][1] for j in ("permute", "rotate1")])
        assert max(chis) <= 1.3 * min(chis) + 1e-6, (seed, chis)
    perm = [jax_sweep[("permute", s)][0] for s in SEEDS]
    allowed = max(np.ptp(perm), 0.02 * abs(np.mean(perm)))
    for n in names:
        gap = max(abs(finals[(n, s)][0] - jax_sweep[("permute", s)][0]) for s in SEEDS)
        assert gap <= allowed, (n, gap, allowed)


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_with_own_draws_matches_jax_sweep(port_sweep, jax_sweep, route):
    _hold(port_sweep, jax_sweep, [route])


def test_all_routes_together_match_jax_sweep(port_sweep, jax_sweep):
    _hold(port_sweep, jax_sweep, list(ROUTES))


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("route", MESH_ROUTES)
def test_mesh_route_with_own_draws_matches_jax_sweep(mesh_sweep, jax_sweep, route, n):
    outs = mesh_sweep[n]
    want = "carry" if route == "carry" else "None"
    finals = {}
    for seed in SEEDS:
        o = outs[0]
        assert str(o[f"{route}{seed}__route"][0]) == want
        finals[(route, seed)] = tuple(o[f"{route}{seed}__final"])
        # the ranks' generators in lockstep, and the same result on each
        for other in outs[1:]:
            np.testing.assert_array_equal(other[f"{route}{seed}__generator"],
                                          o[f"{route}{seed}__generator"])
            np.testing.assert_array_equal(other[f"{route}{seed}__final"],
                                          o[f"{route}{seed}__final"])
    _hold(finals, jax_sweep, [route])


@pytest.mark.parametrize("n", MESH_SIZES)
def test_shard_schedules_deal_one_draw_by_rank(mesh_sweep, n):
    """Round r, shard s takes pair r * size + s of one draw of 3 * size
    pairs from the generator every rank holds."""
    cfg = tconfig.HarmonyConfig(N=8 * 512 * n, d=4, K=4, B=2, B_vec=(2,),
                                shuffle_mode="rotate", block_size=0.25, estep_sub_tile=512)
    g = torch.Generator()
    g.manual_seed(11)
    every = trotate.schedule_pairs(trotate.draw_schedules(cfg, g, 3 * n, 8))
    outs = mesh_sweep[n]
    for r, o in enumerate(outs):
        mine = every[r::n]
        np.testing.assert_array_equal(o["deal__rt"], [p[0] for p in mine])
        np.testing.assert_array_equal(o["deal__order"], [p[1] for p in mine])
    # the ranks draw different pairs: no two shards share a schedule
    rts = np.stack([o["deal__rt"] for o in outs])
    orders = np.stack([o["deal__order"] for o in outs])
    assert any(len({(int(rts[r, i]), tuple(orders[r, i])) for r in range(n)}) > 1
               for i in range(3))


# ---- (c) the draws themselves -----------------------------------------------

def _uniform_fit(samples, bins: int) -> float:
    counts = np.bincount(np.asarray(samples), minlength=bins)
    assert counts.shape == (bins,)
    return float(stats.chisquare(counts).pvalue)


def _check_pairs(pairs, n_rot: int, nb: int) -> None:
    assert len(pairs) == N_DRAWS
    rts = np.asarray([p[0] for p in pairs])
    orders = np.asarray([p[1] for p in pairs])
    assert rts.min() >= 0 and rts.max() < n_rot
    assert (np.sort(orders, axis=1) == np.arange(nb)).all()
    assert _uniform_fit(rts, n_rot) > P_MIN
    # each block's position in the order
    pos = np.argsort(orders, axis=1)
    for b in range(nb):
        assert _uniform_fit(pos[:, b], nb) > P_MIN, b


def test_draw_schedules_are_uniform():
    cfg = tconfig.HarmonyConfig(N=20 * 4096, d=4, K=4, B=2, B_vec=(2,),
                                shuffle_mode="rotate", estep_sub_tile=4096)
    NT = trotate.n_tiles(cfg)
    nb = len(trotate.block_sizes(cfg, NT)[0])
    assert (NT, nb) == (20, 20)
    g = torch.Generator()
    g.manual_seed(1234)
    _check_pairs(trotate.schedule_pairs(trotate.draw_schedules(cfg, g, N_DRAWS)), NT, nb)


def test_draw_rotate_schedules_are_uniform():
    cfg = tconfig.HarmonyConfig(N=2048, d=4, K=4, B=2, B_vec=(2,), shuffle_mode="rotate")
    assert cfg.n_blocks == 20
    g = torch.Generator()
    g.manual_seed(4321)
    _check_pairs(trotate.schedule_pairs(testep.draw_rotate_schedules(cfg, g, N_DRAWS)), cfg.Np,
                 cfg.n_blocks)


@pytest.mark.parametrize("K,n_valid", [(8, 2000), (64, 64), (100, 1000)])
def test_kmeans_init_picks_valid_distinct_cells(K, n_valid):
    """The seeding's picks lie within the first ``n_valid`` columns (the
    rest are pad cells) and are distinct."""
    rng = np.random.default_rng(K + n_valid)
    N = n_valid + 37
    X = torch.as_tensor(rng.normal(size=(6, N)).astype(np.float32))
    X = X / X.norm(dim=0, keepdim=True)
    g = torch.Generator()
    g.manual_seed(5)
    Y = tkmeans._seed_centroids(X, K, n_valid, g)
    # each pick is one column of X: find it
    idx = [int(torch.nonzero((X == Y[:, [k]]).all(dim=0))[0, 0]) for k in range(K)]
    assert max(idx) < n_valid
    assert len(set(idx)) == K


def test_same_seed_same_run_other_seed_other_run():
    runs = {key: port_run("carry", 0, run_seed=r) for key, r in (("a", 0), ("b", 0), ("c", 1))}
    a, b, c = (runs[k] for k in "abc")
    assert np.array_equal(a.Z_corr, b.Z_corr) and np.array_equal(a.R, b.R)
    np.testing.assert_array_equal(a.objective_harmony, b.objective_harmony)
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    assert not np.array_equal(a.Z_corr, c.Z_corr)
    assert not torch.equal(a.state.generator.get_state(), c.state.generator.get_state())


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
