"""Mesh runs of harmony_tpu_torch through its entry points, on gloo ranks
on the CPU (one process a rank, each within its own time limit; a rank
that fails fails the test).

* End to end on 4 ranks, mirroring ``test_sharded_run_matches_single_
  device_quality`` (``tests/test_sharded_pallas.py:278-318``):
  ``run_harmony(mesh=)`` on the rotate schedule removes the batch effect
  (separation below 0.7x the input's) and ends within 5% of the port's
  one-device run's objective. 12,288 cells: the port runs only the
  batch-tiled M-step on a mesh, whose mixture gate wants two tiles of each
  batch in every block of every shard.
* On 2 ranks: an abort flag set on one rank stops every rank before the
  same round; a checkpointed two-round run resumed on 2 ranks for one
  round matches three uninterrupted rounds within the resume bound (5e-4,
  ``tests/test_torch_checkpoint.py``), the file holding the gathered state
  and ``mesh_size``; ``harmony-torch run --mesh auto`` under torchrun's
  environment variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) writes, from rank 0 alone, what
  ``run_harmony(mesh=)`` returns for the same arguments; ``harmony-torch
  bench --mesh 2`` prints its payload from rank 0.
* ``python -m harmony_tpu_torch.multihost_worker``: two ranks agree bit for
  bit on their traces, and ``--dryrun 2`` passes (``tests/test_multihost.
  py``'s two-process tests, here unmarked: they take seconds).
* The routes of ROADMAP A11's part 2 through ``run_harmony(mesh=)`` on 2
  ranks, each against ``run_harmony`` on one device on the same cells: the
  per-round permute schedule (``max_iter_cluster=6``, 4,000 cells) and the
  cell-granular rotate round (2,400 cells, a cell route on one device too)
  on the port's own draws, whose trajectory the global blocks keep
  (objective trace rtol 1e-4); the segmented M-step (65,536 cells in 32
  batches, rotate) and the bf16 engine (virtual R, 12,288 cells) within 5%
  of one device's final objective with the separation shrinking. Each
  resolves the route and M-step layout named, R's columns sum to 1.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from harmony_tpu_torch import harmony_options, run_harmony  # noqa: E402
from harmony_tpu_torch import sharding as tsh  # noqa: E402
from harmony_tpu_torch.multihost_worker import (  # noqa: E402
    free_port, json_line, run_ranks, separation, spawn)

RANK_TIMEOUT = 120.0
E2E = dict(n=12_288, d=10, B=3, ranks=4)
# the routes of A11's part 2: cells, batches, run_harmony arguments, the
# route, the M-step layout, whether the trajectory is one device's
ROUTES = {
    "permute_rounds": (4000, 3, dict(shuffle_mode="permute", options=harmony_options(
        max_iter_cluster=6)), "None", "dense", True),
    "cell": (2400, 3, dict(shuffle_mode="rotate"), "cell", "dense", True),
    "segment": (65_536, 32, dict(shuffle_mode="rotate"), "carry", "segment", False),
    "bf16": (12_288, 3, dict(shuffle_mode="rotate", dtype="bfloat16",
                             options=harmony_options(block_size=0.25)), "carry", "tiled", False),
}
HOST = dict(n=8192, d=8, B=3)
CLI = dict(n=20_480, d=8, B=2)


def problem(n, d, B, seed=0):
    """``tests/test_sharded_pallas.py:287-290``'s cells."""
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    return Z, batches


def _opts():
    return harmony_options(block_size=0.25)


# ---- the ranks -------------------------------------------------------------

class _Flag:
    """An abort flag that trips at its ``at``-th poll (never for None)."""

    def __init__(self, at):
        self.at, self.polls = at, 0

    def aborted(self) -> bool:
        self.polls += 1
        return self.at is not None and self.polls >= self.at


def _rank_e2e(mesh, d):
    Z, batches = problem(E2E["n"], E2E["d"], E2E["B"])
    res = run_harmony(Z, {"dataset": batches.astype(str)}, ["dataset"], nclust=8, max_iter=5,
                      seed=0, shuffle_mode="rotate", options=_opts(), mesh=mesh,
                      return_object=True)
    emb = res.embeddings  # every rank gathers
    if mesh.rank == 0:
        np.savez(os.path.join(d, "e2e.npz"), emb=emb, obj=res.objective_harmony,
                 route=res.config.rotate_route, Np=res.config.Np)


def _rank_host(mesh, d, cli_emb, cli_meta):
    from harmony_tpu_torch.api import HarmonyResult
    from harmony_tpu_torch.checkpoint import load_checkpoint, read_checkpoint_meta
    from harmony_tpu_torch.driver import harmonize
    from harmony_tpu_torch.engine import mstep_layout

    Z, batches = problem(HOST["n"], HOST["d"], HOST["B"])
    meta = {"dataset": batches.astype(str)}
    kw = dict(nclust=6, seed=0, shuffle_mode="rotate", options=_opts(), mesh=mesh,
              return_object=True, early_stop=False)
    out = {}
    # an abort flag set on rank 1 at its second poll
    flag = _Flag(2 if mesh.rank == 1 else None)
    try:
        run_harmony(Z, meta, ["dataset"], max_iter=4, abort=flag, **kw)
        out["abort_polls"] = -1
    except KeyboardInterrupt:
        out["abort_polls"] = flag.polls
    # checkpoint two rounds, resume one, against three
    ck = os.path.join(d, "ck.npz")
    first = run_harmony(Z, meta, ["dataset"], max_iter=2, checkpoint_path=ck, **kw)
    full = run_harmony(Z, meta, ["dataset"], max_iter=3, **kw)
    Zd = Z.T[:, np.argsort(first.ingest_inv)]
    cfg, st = load_checkpoint(ck, Z=Zd, design=first.design, extra_rounds=1, mesh=mesh)
    st = harmonize(cfg, st, max_iter=1, layout=mstep_layout(cfg, first.design.codes),
                   mesh=mesh)
    resumed = HarmonyResult(config=cfg, state=st, design=first.design,
                            ingest_inv=first.ingest_inv, mesh=mesh)
    out.update(resumed=resumed.Z_corr, full=full.Z_corr, resumed_obj=resumed.objective_harmony,
               full_obj=full.objective_harmony, ck_meta=json.dumps(read_checkpoint_meta(ck)),
               Y=st.Y.numpy(), generator=st.generator.get_state().numpy())
    with np.load(ck) as z:
        out["ck_shape"] = np.asarray(z["Z_corr"].shape)
    # what harmony-torch run --mesh auto computes, through run_harmony
    Zc = np.load(cli_emb)
    with open(cli_meta, newline="") as fh:
        rows = list(csv.reader(fh))[1:]
    out["cli_want"] = run_harmony(Zc, {"dataset": np.array([r[0] for r in rows])},
                                  ["dataset"], nclust=6, max_iter=3, seed=0,
                                  shuffle_mode="rotate", options=harmony_options(), mesh=mesh)
    np.savez(os.path.join(d, f"host{mesh.rank}.npz"), **out)


def _route_run(name, mesh=None):
    from harmony_tpu_torch.engine import mstep_layout

    n, B, kw, _, _, _ = ROUTES[name]
    Z, batches = problem(n, 4 if name == "segment" else 8, B)
    res = run_harmony(Z, {"dataset": batches.astype(str)}, ["dataset"], nclust=8, max_iter=4,
                      seed=0, mesh=mesh, device="cpu" if mesh is None else None,
                      return_object=True, **kw)
    lay = mstep_layout(res.config, res.design.codes, "cpu", mesh)
    return dict(emb=res.embeddings, obj=res.objective_harmony, route=str(res.config.rotate_route),
                layout="tiled" if lay.tiled is not None else
                "segment" if lay.segments is not None else "dense",
                virtual=res.state.virt_pen is not None, dtype=str(res.state.Z_corr.dtype),
                colsum=float(np.abs(res.R.sum(0) - 1).max()), sep=separation(res.embeddings,
                                                                              batches))


def _rank_routes(mesh, d):
    for name in ROUTES:
        out = _route_run(name, mesh)
        if mesh.rank == 0:
            np.savez(os.path.join(d, f"{name}.npz"), **out)
        np.save(os.path.join(d, f"{name}_obj{mesh.rank}.npy"), out["obj"])


def _rank_main(argv):
    task, rank, world, port, d = argv[:5]
    torch.set_num_threads(1)
    tsh.initialize_distributed("gloo", f"tcp://localhost:{port}", int(world), int(rank),
                               timeout=RANK_TIMEOUT)
    mesh = tsh.make_mesh("cpu")
    if task == "e2e":
        _rank_e2e(mesh, d)
    elif task == "routes":
        _rank_routes(mesh, d)
    else:
        _rank_host(mesh, d, *argv[5:])
    print(json.dumps({"rank": mesh.rank, "ok": True}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ---- the tests -------------------------------------------------------------

def _start(task, n, d, *extra):
    port = free_port()
    res = run_ranks([[sys.executable, os.path.abspath(__file__), task, str(r), str(n),
                      str(port), str(d), *extra] for r in range(n)], RANK_TIMEOUT, cwd=ROOT)
    bad = [(r, rc, se[-3000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
    assert not bad, f"ranks failed or timed out: {bad}"


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    Z, b = problem(CLI["n"], CLI["d"], CLI["B"], seed=4)
    np.save(d / "emb.npy", Z.astype(np.float32))
    with open(d / "meta.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["dataset"])
        w.writerows([[f"b{x}"] for x in b])
    return d


@pytest.fixture(scope="module")
def host(tmp_path_factory, cli_files):
    d = tmp_path_factory.mktemp("host")
    _start("host", 2, d, str(cli_files / "emb.npy"), str(cli_files / "meta.csv"))
    out = []
    for r in range(2):
        with np.load(d / f"host{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def test_four_rank_run_matches_one_device_quality(tmp_path):
    _start("e2e", E2E["ranks"], tmp_path)
    with np.load(tmp_path / "e2e.npz") as z:
        emb, obj, route = z["emb"], z["obj"], str(z["route"])
    Z, batches = problem(E2E["n"], E2E["d"], E2E["B"])
    assert route == "carry" and emb.shape == Z.shape and np.isfinite(emb).all()
    sep0 = separation(Z, batches)
    assert separation(emb, batches) < 0.7 * sep0
    one = run_harmony(Z, {"dataset": batches.astype(str)}, ["dataset"], nclust=8, max_iter=5,
                      seed=0, shuffle_mode="rotate", options=_opts(), device="cpu",
                      return_object=True)
    np.testing.assert_allclose(obj[-1], one.objective_harmony[-1], rtol=0.05)


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    d = tmp_path_factory.mktemp("routes")
    _start("routes", 2, d)
    return d


@pytest.mark.parametrize("name", list(ROUTES))
def test_part_2_routes_run_on_two_ranks(routes, name):
    n, B, kw, route, layout, same = ROUTES[name]
    with np.load(routes / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files}
    assert str(got["route"]) == route and str(got["layout"]) == layout
    assert bool(got["virtual"]) == (name == "bf16")
    assert str(got["dtype"]) == ("torch.bfloat16" if name == "bf16" else "torch.float32")
    assert got["emb"].shape[0] == n and np.isfinite(got["emb"]).all()
    assert float(got["colsum"]) <= (5e-3 if name == "bf16" else 1e-4)
    np.testing.assert_array_equal(np.load(routes / f"{name}_obj1.npy"), got["obj"])
    one = _route_run(name)
    assert one["route"] == route and one["layout"] == layout
    if same:
        np.testing.assert_allclose(got["obj"], one["obj"], rtol=1e-4)
    else:
        np.testing.assert_allclose(got["obj"][-1], one["obj"][-1], rtol=0.05)
    Z, batches = problem(n, 4 if name == "segment" else 8, B)
    assert float(got["sep"]) < separation(Z, batches)


def test_abort_on_one_rank_stops_every_rank_at_the_same_round(host):
    assert [h["abort_polls"] for h in host] == [2, 2]


def test_two_rank_checkpoint_resumes_on_two_ranks(host):
    h = host[0]
    np.testing.assert_allclose(h["resumed"], h["full"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(h["resumed_obj"], h["full_obj"], rtol=1e-4)
    meta = json.loads(str(h["ck_meta"]))
    assert meta["mesh_size"] == 2 and meta["shuffle_mode"] == "rotate"
    # the file holds the gathered state: the whole padded cell axis
    assert tuple(h["ck_shape"])[0] == HOST["d"] and tuple(h["ck_shape"])[1] >= HOST["n"]
    np.testing.assert_array_equal(host[1]["Y"], h["Y"])
    np.testing.assert_array_equal(host[1]["generator"], h["generator"])


def _torchrun_env(rank, n, port):
    # one thread a rank, as the ranks of _start run: the same sums in the
    # same order
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                MASTER_ADDR="localhost", MASTER_PORT=str(port), HARMONY_BENCH_PAIRS="1",
                OMP_NUM_THREADS="1")


def _torchrun(args, n=2):
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "harmony_tpu_torch.cli", *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_torchrun_env(r, n, port), cwd=ROOT) for r in range(n)]
    out = []
    for p in procs:
        try:
            out.append((*p.communicate(timeout=RANK_TIMEOUT), p.returncode))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, rc, se[-3000:]) for r, (_, se, rc) in enumerate(out) if rc != 0]
    assert not bad, f"ranks failed: {bad}"
    return out


def test_cli_mesh_auto_under_torchrun_equals_run_harmony(host, cli_files, tmp_path):
    out = tmp_path / "cli.npy"
    res = _torchrun(["run", "--embeddings", str(cli_files / "emb.npy"), "--meta",
                     str(cli_files / "meta.csv"), "--vars", "dataset", "--out", str(out),
                     "--nclust", "6", "--max-iter", "3", "--shuffle-mode", "rotate",
                     "--mesh", "auto", "--backend", "gloo", "--device", "cpu"])
    assert "wrote" in res[0][0] and "wrote" not in res[1][0]  # rank 0 alone writes
    np.testing.assert_array_equal(np.load(out), host[0]["cli_want"])
    np.testing.assert_array_equal(host[1]["cli_want"], host[0]["cli_want"])


def test_bench_mesh_2_prints_its_payload():
    res = _torchrun(["bench", "--mesh", "2", "--backend", "gloo", "--device", "cpu",
                     "--cells", str(CLI["n"]), "--dims", "8", "--batches", "2", "--nclust",
                     "6", "--max-iter", "1"])
    lines = res[0][0].strip().splitlines()
    assert len(lines) == 1 and not res[1][0].strip()
    payload = json.loads(lines[0])
    assert payload["n_devices"] == 2 and payload["platform"] == "cpu"
    assert payload["mstep"] == "tiled" and payload["value"] > 0


def test_worker_ranks_agree():
    res = spawn(2, ["--backend", "gloo", "--device", "cpu", "--cells", "8192", "--batches",
                    "3", "--block-size", "0.25", "--max-iter", "2"], RANK_TIMEOUT, cwd=ROOT)
    assert all(rc == 0 for rc, _, _ in res), [se[-2000:] for _, _, se in res]
    a, b = (json_line(so) for _, so, _ in res)
    assert a["objective_harmony"] == b["objective_harmony"]
    assert a["world_size"] == 2 and a["backend"] == "gloo"
    assert a["finite"] and a["separation_out"] < a["separation_in"]
    assert a["r_colsum_err"] < 1e-4 and a["config"]["route"] == "carry"


def test_worker_dryrun_two_ranks():
    p = subprocess.run([sys.executable, "-m", "harmony_tpu_torch.multihost_worker",
                        "--dryrun", "2", "--device", "cpu"], capture_output=True, text=True,
                       cwd=ROOT, timeout=RANK_TIMEOUT + 30)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json_line(p.stdout)
    assert line["ok"] and line["dryrun"] == 2 and line["shape"] == [8192, 8]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
def test_worker_dryrun_defaults_to_the_card():
    """Without ``--device`` the dry run's ranks take the card, and without
    one it raises before it starts a rank."""
    from harmony_tpu_torch.multihost_worker import dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun(2)


def test_worker_injects_schedule_tables_on_the_cell_route():
    """The worker's injected draws of the cell-granular round on a mesh are
    one global schedule table a round (rotation in [0, Np), then a block
    order), the same on every rank, as every rotate route takes them."""
    import dataclasses

    from harmony_tpu_torch.multihost_worker import inject_draws, inject_problem

    base = inject_problem("rotate_cell", 4096, 8, 3, 8, 2, 0)[0]
    cfg = dataclasses.replace(base, n_shards=2)
    assert cfg.rotate_route == "cell"
    tables = [inject_draws(cfg, 2, rank, 2, 0)["schedules"] for rank in (0, 1)]
    for t0, t1 in zip(*tables):
        assert t0.dtype == torch.int32 and t0.shape == (cfg.max_iter_cluster, 1 + cfg.n_blocks)
        assert torch.equal(t0, t1)
        assert ((t0[:, 0] >= 0) & (t0[:, 0] < cfg.Np)).all()
        assert (t0[:, 1:].sort(dim=1).values == torch.arange(cfg.n_blocks)).all()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
