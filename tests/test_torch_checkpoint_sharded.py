"""The sharded checkpoint of harmony_tpu_torch on torch.distributed.checkpoint.

``checkpoint.save_checkpoint_sharded`` and ``load_checkpoint_sharded`` are
the counterpart of the JAX package's orbax variant
(harmony_tpu/checkpoint.py:203-246, held by tests/test_aux.py:106-251).
Each world size (1, 2 and 4 gloo ranks on the CPU) is started once for the
module, the largest first; the ranks (this file run as a script) run the
stats-carrying rotate route with virtual R on the batch-tiled layout (d =
8, K = 8, 3 batches, 4,096 cells, T = 512, 128-cell tiles), in float32 and
in bf16, and write what the tests compare.

* The round trip: a state after 2 rounds, saved and loaded on the same
  mesh, is bit for bit the state (R materialised, as the npz format's full
  mode saves it) and the npz round trip of it (``save_checkpoint(...,
  mode="full")``, ``load_checkpoint``), on every field of the JAX state and
  the generator; the config comes back equal; the virtual-R context comes
  back on the mesh it was written on. bf16 fields stay bf16, bit for bit.
* The resume: that state loaded and run one more round equals the
  uninterrupted 3-round run (objective rtol 1e-6, Z_corr atol 1e-5, the
  same draws: the generator's state rides along), as tests/test_aux.py:
  158-251 holds the JAX package.
* Re-sharding: the file written on 4 ranks loads on 2 ranks and on one
  device, each holding the 4-rank state's global arrays (the columns of
  real cells bit for bit, pad cells zero), the virtual-R context dropped
  (its tables belong to the 4-rank blocks) and R the materialised one.
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

from harmony_tpu_torch import checkpoint as tck  # noqa: E402
from harmony_tpu_torch import config as tconfig  # noqa: E402
from harmony_tpu_torch import engine as tengine  # noqa: E402
from harmony_tpu_torch import preprocess as tpre  # noqa: E402
from harmony_tpu_torch import sharding as tsh  # noqa: E402
from harmony_tpu_torch import state as tstate  # noqa: E402
from harmony_tpu_torch.ops.tiled import build_batch_tiled_order  # noqa: E402

N, D, K, ROUNDS = 4096, 8, 8, 3
SIZES = (4, 2, 1)  # the largest first: the others load its file
DTYPES = ("float32", "bfloat16", "float16")
RANK_TIMEOUT = 180.0


class _Size:
    """A stand-in mesh of ``size`` ranks for config padding."""

    def __init__(self, size: int):
        self.size = size


def problem(mesh, dtype: str):
    """(config, design in engine order, (d, N) cells, hyperparameters,
    centroids) of the virtual rotate run in ``dtype``, for ``mesh``."""
    rng = np.random.default_rng(7)
    meta = {"dataset": rng.integers(0, 3, N)}
    Z = (rng.normal(size=(3, D)) * 0.8)[meta["dataset"]] + rng.normal(size=(N, D))
    design = tpre.build_design(meta, ["dataset"])
    opts = tconfig.harmony_options(block_size=0.25)
    cfg = tpre.resolve_config(design=design, options=opts, n_cells=N, d=D, nclust=K,
                              max_iter=ROUNDS, early_stop=False, verbose=False,
                              lambda_estimation=True)
    cfg = dataclasses.replace(cfg, shuffle_mode="rotate", dtype=dtype, virtual_r=True,
                              estep_impl="kernel", mstep_impl="kernel", estep_sub_tile=512,
                              mstep_tile=128, mstep_mode="tiled")
    cfg = tconfig.finalize_engine_config(tsh.pad_for_mesh(cfg, mesh), mesh)
    perm, _ = build_batch_tiled_order(design.codes, 128, seed=0)
    Zt = tpre.orient_embedding(Z, N)[:, perm]
    design = dataclasses.replace(design, codes=design.codes[:, perm])
    hp = tpre.expand_hyperparams(design, cfg.K, None, 0.1, None, opts.tau)
    return cfg, design, Zt, hp, Zt[:, rng.choice(N, K, replace=False)]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(_bits(a), _bits(b))
    return a == b


# ---- the ranks -------------------------------------------------------------

def _rank_case(dtype: str, mesh, work: str, out: dict) -> None:
    cfg, design, Zt, hp, Y0 = problem(mesh, dtype)
    layout = tengine.mstep_layout(cfg, design.codes, "cpu", mesh)

    def start():
        st = tstate.init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, 3, "cpu",
                               mesh=mesh)
        return tengine.init_cluster_from(cfg, st, Y0, mesh)

    def rounds(st, n):
        for _ in range(n):
            st = tengine.harmony_round(cfg, st, layout=layout, mesh=mesh)
        return st

    ref = tengine.materialize_r(cfg, rounds(start(), ROUNDS), mesh)
    mid = rounds(start(), ROUNDS - 1)
    assert mid.virt_pen is not None, "virtual R did not engage"
    tag = f"{dtype}_{mesh.size}"
    sharded = os.path.join(work, tag)
    tck.save_checkpoint_sharded(sharded, cfg, mid, mesh)
    tck.save_checkpoint(os.path.join(work, tag + ".npz"), cfg, mid, mode="full", mesh=mesh)
    cfg2, back = tck.load_checkpoint_sharded(sharded, mesh)
    _, back_npz = tck.load_checkpoint(os.path.join(work, tag + ".npz"), extra_rounds=0,
                                      device="cpu", mesh=mesh)
    want = tengine.materialize_r(cfg, mid, mesh)
    fields = [f for f in tstate.ARRAY_FIELDS if f != "key"]
    out[f"{tag}/config_equal"] = np.asarray(cfg2 == cfg)
    out[f"{tag}/bits_state"] = np.asarray([_same(getattr(back, f), getattr(want, f))
                                           for f in fields])
    out[f"{tag}/bits_npz"] = np.asarray([_same(getattr(back, f), getattr(back_npz, f))
                                         for f in fields])
    out[f"{tag}/dtypes"] = np.asarray([str(getattr(back, f).dtype) for f in fields
                                       if isinstance(getattr(back, f), torch.Tensor)])
    out[f"{tag}/virtual"] = np.asarray(all(
        _same(getattr(back, f), getattr(mid, f)) for f in tstate.VIRTUAL_FIELDS))
    out[f"{tag}/no_G"] = np.asarray(back.virt_G is None and back.tiled_moments is None)
    out[f"{tag}/generator"] = np.asarray(torch.equal(back.generator.get_state(),
                                                     mid.generator.get_state()))
    resumed = tengine.materialize_r(cfg2, rounds(back, 1), mesh)
    for name, st in (("ref", ref), ("resumed", resumed)):
        arrays = tstate.state_to_arrays(st, mesh=mesh)
        for f in ("objective_harmony", "objective_kmeans", "Z_corr"):
            out[f"{tag}/{name}/{f}"] = arrays[f]
        out[f"{tag}/{name}/n_rounds"] = np.asarray(st.n_rounds)
    # the mid state's global arrays, which the other meshes load back
    for f, a in tstate.state_to_arrays(want, mesh=mesh).items():
        if f in tstate.ARRAY_FIELDS:
            out[f"{tag}/mid/{f}"] = a
    out[f"{tag}/mid/generator"] = mid.generator.get_state().numpy()
    if mesh.size != SIZES[0]:
        # the file written on the largest mesh, loaded on this one
        cfg4, st4 = tck.load_checkpoint_sharded(os.path.join(work, f"{dtype}_{SIZES[0]}"), mesh)
        assert st4.virt_pen is None and st4.Z_corr.dtype == getattr(torch, dtype)
        lo, hi = tsh.cell_range(cfg4, mesh)
        out[f"{tag}/from4/range"] = np.asarray([lo, hi, cfg4.Np])
        for f, a in tstate.state_to_arrays(st4, mesh=mesh).items():
            if f in tstate.ARRAY_FIELDS:
                out[f"{tag}/from4/{f}"] = a
        out[f"{tag}/from4/generator"] = st4.generator.get_state().numpy()


def _rank_main(argv):
    rank, world, port, work, out_path = argv
    torch.set_num_threads(1)
    tsh.initialize_distributed("gloo", f"tcp://localhost:{port}", int(world), int(rank),
                               timeout=RANK_TIMEOUT)
    mesh = tsh.make_mesh("cpu")
    out = {}
    for dtype in DTYPES:
        _rank_case(dtype, mesh, work, out)
    np.savez(out_path, **{k.replace("/", "__"): v for k, v in out.items()})
    print(json.dumps({"rank": mesh.rank, "ok": True}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


# ---- the fixture and the tests ----------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's outputs]} and the shared work directory."""
    from harmony_tpu_torch.multihost_worker import free_port, json_line, run_ranks

    work = tmp_path_factory.mktemp("sharded_ck")
    out = {}
    for n in SIZES:
        port = free_port()
        res = run_ranks([[sys.executable, os.path.abspath(__file__), str(r), str(n), str(port),
                          str(work), str(work / f"out{n}_{r}.npz")] for r in range(n)],
                        RANK_TIMEOUT, cwd=ROOT)
        bad = [(r, rc, se[-3000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
        assert not bad, f"ranks failed or timed out: {bad}"
        assert all(json_line(so)["ok"] for _, so, _ in res)
        loaded = []
        for r in range(n):
            with np.load(str(work / f"out{n}_{r}.npz")) as z:
                loaded.append({k.replace("__", "/"): z[k] for k in z.files})
        out[n] = loaded
    return out, work


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_round_trip_is_bit_equal_to_the_npz_round_trip(worlds, n, dtype):
    outs, _ = worlds
    for o in outs[n]:
        tag = f"{dtype}_{n}"
        assert bool(o[f"{tag}/config_equal"])
        assert o[f"{tag}/bits_state"].all() and o[f"{tag}/bits_npz"].all()
        assert bool(o[f"{tag}/virtual"]) and bool(o[f"{tag}/no_G"])
        assert bool(o[f"{tag}/generator"])
        float_dtypes = set(o[f"{tag}/dtypes"]) - {"torch.int32", "torch.uint8"}
        assert f"torch.{dtype}" in float_dtypes if dtype != "float32" else (
            float_dtypes == {"torch.float32"})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_resume_matches_the_uninterrupted_run(worlds, n, dtype):
    outs, _ = worlds
    o = outs[n][0]
    tag = f"{dtype}_{n}"
    assert int(o[f"{tag}/resumed/n_rounds"]) == int(o[f"{tag}/ref/n_rounds"]) == ROUNDS
    np.testing.assert_allclose(o[f"{tag}/resumed/objective_harmony"],
                               o[f"{tag}/ref/objective_harmony"], rtol=1e-6)
    np.testing.assert_allclose(o[f"{tag}/resumed/objective_kmeans"],
                               o[f"{tag}/ref/objective_kmeans"], rtol=1e-6)
    np.testing.assert_allclose(o[f"{tag}/resumed/Z_corr"], o[f"{tag}/ref/Z_corr"], rtol=0,
                               atol=1e-5)


def _held_to_four(got: dict, four: dict) -> None:
    """``got`` (field -> global array) holds the 4-rank state ``four``: the
    columns of real cells bit for bit, any pad cells zero."""
    for f in tstate.ARRAY_FIELDS:
        a, b = got[f], four[f]
        if f in tstate.CELL_FIELDS:
            np.testing.assert_array_equal(a[..., :N], b[..., :N])
            assert not a[..., N:].any()
        else:
            np.testing.assert_array_equal(a, b)


def _four(outs, dtype: str) -> dict:
    o = outs[4][0]
    return {f: o[f"{dtype}_4/mid/{f}"] for f in tstate.ARRAY_FIELDS + ("generator",)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_file_of_four_ranks_loads_on_two_ranks(worlds, dtype):
    outs, _ = worlds
    four = _four(outs, dtype)
    for o in outs[2]:
        got = {f: o[f"{dtype}_2/from4/{f}"] for f in tstate.ARRAY_FIELDS + ("generator",)}
        _held_to_four(got, four)
        np.testing.assert_array_equal(got["generator"], four["generator"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_file_of_four_ranks_loads_on_one_device(worlds, dtype):
    outs, work = worlds
    four = _four(outs, dtype)
    cfg, st = tck.load_checkpoint_sharded(str(work / f"{dtype}_4"), device="cpu")
    assert cfg.n_shards == 1 and st.virt_pen is None
    assert st.Z_corr.dtype == getattr(torch, dtype) and st.Z_corr.shape[1] == cfg.Np
    _held_to_four(tstate.state_to_arrays(st), four)
    np.testing.assert_array_equal(st.generator.get_state().numpy(), four["generator"])
    # it runs on from there, and with room for more rounds past the file's
    st = tengine.harmony_round(cfg, st, layout=tengine.mstep_layout(cfg, st.codes.numpy()))
    assert np.isfinite(tstate.host_numpy(st.Z_corr)).all()
    cfg_x, st_x = tck.load_checkpoint_sharded(str(work / f"{dtype}_4"), device="cpu",
                                              extra_rounds=2)
    assert cfg_x.max_iter_harmony == cfg.max_iter_harmony + 2
    assert st_x.objective_harmony.numel() == cfg_x.harmony_trace_capacity
    assert st_x.kmeans_rounds.numel() == cfg_x.max_iter_harmony
    for _ in range(2):
        st_x = tengine.harmony_round(cfg_x, st_x, layout=tengine.mstep_layout(
            cfg_x, st_x.codes.numpy()))
    assert st_x.n_rounds == ROUNDS + 1


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
