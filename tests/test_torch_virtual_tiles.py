"""Virtual R on layout tiles that are not whole 64-cell pieces.

A user-set ``mstep_tile`` of 160 with ``estep_sub_tile=2560`` (which it
divides) gives a batch-tiled layout of 160-cell tiles: a 64-cell piece of
the E-step meets two of them wherever a tile boundary falls inside it
(every other piece). The JAX package takes virtual R there
(harmony_tpu/engine.py:127-141, ``estep_sub_tile % tile == 0``); so does
the port, with K7's moments split at the tile boundary and K10 cutting
its steps at tile edges (csrc/rotate.cu), and K9 masking a tile's last,
partial slice (csrc/tiled.cu).

* Both packages resolve the config to 160-cell tiles and virtual R.
* (e) Three Harmony rounds of the JAX engine with ``virtual_r=True`` and
  its run-end ``materialize_r`` against the port's engine with the same
  centroids and injected (rotation, order) pairs, Pallas in interpret
  mode: objective_kmeans rtol 1e-5, Z_corr and R atol 1e-4 (the bounds
  of tests/test_torch_virtual.py's case (e)).
* (g) The K7 twin's fused moments at tile 160 equal K8's plain moments
  on the R it writes (rtol 1e-5 of their max); the written path (K7's
  moments, K9) runs at tile 160 and the virtual run agrees with it at the
  JAX package's bounds (tests/test_multicov_fast.py:144-171).
* The launch plans: ``cuda_rotate.tile_steps`` over tile widths.
* A 2-rank gloo run on the carry route at tile 160: virtual against the
  written run on the same mesh and draws, the ranks in lockstep, and near
  one device's virtual run. The rotate schedule pads the cell axis to
  whole E-step tiles a shard (``config.finalize_engine_config``), and the
  E-step tile is a multiple of the layout tile here, so a shard boundary
  falls on a layout tile's edge; inside each shard every other piece
  still straddles two tiles.

On CPU tensors the kernel wrappers run their plain versions.
"""

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

from harmony_tpu import config as jconfig  # noqa: E402
from harmony_tpu import engine as jengine  # noqa: E402
from harmony_tpu import preprocess as jpre  # noqa: E402
from harmony_tpu import state as jstate  # noqa: E402
from harmony_tpu.ops import tiled as jtiled  # noqa: E402
from harmony_tpu_torch import config as tconfig  # noqa: E402
from harmony_tpu_torch import driver as tdriver  # noqa: E402
from harmony_tpu_torch import engine as tengine  # noqa: E402
from harmony_tpu_torch import preprocess as tpre  # noqa: E402
from harmony_tpu_torch import state as tstate  # noqa: E402
from harmony_tpu_torch.ops import cuda_ridge, cuda_rotate  # noqa: E402
from harmony_tpu_torch.ops import ridge as tridge  # noqa: E402
from harmony_tpu_torch.ops import rotate as tr  # noqa: E402

from test_torch_rotate import _close, _jax_schedule, _t  # noqa: E402

# T = 2560 needs a block of 4,096 cells or more (config._rotate_geometry)
T, TILE, N_CELLS = 2560, 160, 16_384


def _setup(B_vec=(3,), N=N_CELLS, lamb=None, seed=7, d=8, K=8, virtual=True):
    """A batch-tiled rotate problem at T = 2560 and 160-cell layout tiles
    (4 blocks), virtual R on, for both packages."""
    rng = np.random.default_rng(seed)
    meta = {f"v{c}": rng.integers(0, b, N).astype(np.int32) for c, b in enumerate(B_vec)}
    Z = rng.normal(size=(N, d)).astype(np.float32)
    jd = jpre.build_design(meta, list(meta))
    td = tpre.build_design(meta, list(meta))
    opts_j = jconfig.harmony_options(block_size=0.25)
    opts_t = tconfig.harmony_options(block_size=0.25)
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=3, early_stop=False, verbose=False,
              lambda_estimation=lamb is None)
    cj = jpre.resolve_config(design=jd, options=opts_j, **kw)
    ct = tpre.resolve_config(design=td, options=opts_t, **kw)
    over = dict(shuffle_mode="rotate", estep_sub_tile=T, mstep_tile=TILE, mstep_mode="tiled",
                virtual_r=virtual)
    cj = jconfig.finalize_engine_config(dataclasses.replace(cj, estep_impl="pallas", **over))
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        ct, estep_impl="kernel", mstep_impl="kernel", **over))
    perm, _ = jtiled.build_batch_tiled_order(jd.codes, TILE, seed=0)
    Zt = jpre.orient_embedding(Z, N)[:, perm]
    jd = dataclasses.replace(jd, codes=jd.codes[:, perm])
    td = dataclasses.replace(td, codes=td.codes[:, perm])
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, lamb, opts_j.tau)
    ht = tpre.expand_hyperparams(td, ct.K, None, 0.1, lamb, opts_t.tau)
    Y0 = Zt[:, rng.choice(N, cj.K, replace=False)]
    return cj, ct, jd, td, Zt, hj, ht, Y0


def _states(cj, ct, jd, td, Zt, hj, ht, Y0, key=3):
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(key))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, key, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, TILE)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    assert tiled_j is not None and tiled_t is not None
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    return sj, st, tiled_j, tiled_t


def test_both_packages_take_virtual_r_on_160_cell_tiles():
    cj, ct, jd, td = _setup()[:4]
    assert jtiled.choose_tiled_tile(cj, 3) == TILE  # one covariate of 3 batches
    tiled_t = tengine.mstep_layout(ct, td.codes).tiled
    assert tiled_t is not None and tiled_t.tile == TILE and TILE % 64
    assert jengine._virtual_gate(cj, tiled_t, None)
    assert tengine._virtual_gate(ct, tiled_t)


@pytest.mark.parametrize("tile,steps", [(64, 1), (128, 2), (256, 4), (160, 3), (320, 5),
                                        (192, 3), (130, 3)])
def test_tile_steps(tile, steps):
    """K10 walks a tile in ``tile_steps`` 64-cell steps: tile / 64 where
    tiles are whole pieces (the launch plan of those is unchanged), else
    the most pieces any tile meets."""
    assert cuda_rotate.tile_steps(tile) == steps
    starts = np.arange(0, 64 * tile, tile)
    met = (starts + tile - 1) // 64 - starts // 64 + 1
    assert met.max() == steps


def test_virtual_slice_at_160_cell_tiles_matches_jax_engine():
    """Case (e) at 160-cell tiles: three rounds of both engines with the
    JAX round keys' (rotation, order) pairs injected into the port."""
    setup = _setup()
    cj, ct = setup[:2]
    sj, st, tiled_j, tiled_t = _states(*setup)
    round_j = jax.jit(lambda s: jengine.harmony_round(cj, s, tiled=tiled_j))
    for _ in range(3):
        _, sub = jax.random.split(sj.key)
        sched = tr.schedule_table(
            [_jax_schedule(ct, k) for k in jax.random.split(sub, cj.max_iter_cluster)])
        sj = round_j(sj)
        st = tengine.harmony_round(ct, st, schedules=sched, layout=tengine.MStepLayout(tiled_t))
    assert sj.virt_pen is not None and st.virt_pen is not None
    _close(st.virt_pen, sj.virt_pen, rtol=1e-5)
    np.testing.assert_array_equal(st.virt_blkmap.numpy(), np.asarray(sj.virt_blkmap))
    mj, mt = jengine.materialize_r(cj, sj), tengine.materialize_r(ct, st)
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    _close(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    _close(st.Z_corr.numpy(), np.asarray(sj.Z_corr), rtol=0, atol=1e-4)
    _close(mt.R.numpy(), np.asarray(mj.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(mt.R.numpy()[:, :N_CELLS].sum(0), 1.0, atol=1e-5)
    assert (mt.R.numpy()[:, N_CELLS:] == 0).all()


@pytest.mark.parametrize("B_vec", [(3,), (2, 3)])
def test_fused_moments_at_160_cell_tiles_match_k8(B_vec):
    """Case (g) at 160-cell tiles: the phase fuses the moments (virtual and
    written), equal to K8's plain moments on the R the round leaves."""
    setup = _setup(B_vec)
    ct = setup[1]
    for virtual in (True, False):
        cfg = dataclasses.replace(ct, virtual_r=virtual)
        _, st, _, tiled = _states(*setup)
        out = tengine.cluster(cfg, st, tiled=tiled)
        assert out.tiled_moments is not None and (out.virt_pen is not None) == virtual
        R = tengine.materialize_r(cfg, out).R if virtual else out.R
        M = cuda_ridge.tile_moments_twin(R.float(), tr.pad_cells_to_tile(cfg, out.Z_orig.float()),
                                         TILE, tridge.full_tile_joint(cfg, tiled),
                                         int(tiled.joint_codes.shape[1]))
        _close(out.tiled_moments, M, rtol=0, atol=1e-5 * float(M.abs().max()))


@pytest.mark.parametrize("B_vec", [(3,), (2, 3)])
def test_virtual_run_at_160_cell_tiles_matches_written_run(B_vec):
    """The virtual run against the written run of the same config (K7's
    moments, K9 at tile 160), at the JAX package's bounds
    (tests/test_multicov_fast.py:144-171)."""
    setup = _setup(B_vec, lamb=1.0)
    ct, td, Zt, ht = setup[1], setup[3], setup[4], setup[6]
    layout = tengine.mstep_layout(ct, td.codes)
    assert layout.tiled.tile == TILE
    out = {}
    for virtual in (True, False):
        cfg = dataclasses.replace(ct, virtual_r=virtual)
        st = tstate.init_state(cfg, Zt, td, ht.sigma, ht.theta, ht.lamb, 5, "cpu")
        out[virtual] = tdriver.run(cfg, st, layout=layout)
    assert out[True].virt_pen is not None and out[False].virt_pen is None
    _close(out[True].Z_corr, out[False].Z_corr, rtol=0, atol=2e-4)
    _close(out[True].trace_lists(ct)["objective_harmony"],
           out[False].trace_lists(ct)["objective_harmony"], rtol=1e-5)
    _close(out[True].R, out[False].R, rtol=0, atol=1e-6)


MESH_N, MESH_WORLD = 2 * N_CELLS, 2


def _mesh_run(mesh, virtual: bool):
    """run_harmony's steps (``multihost_worker.driver_result``) on the mesh
    cells at tile 160, carry route, three iterations, early stop off."""
    from harmony_tpu_torch.multihost_worker import driver_result

    rng = np.random.default_rng(11)
    batches = rng.integers(0, 3, MESH_N)
    Z = ((rng.normal(size=(3, 8)) * 0.8)[batches] + rng.normal(size=(MESH_N, 8)))
    return driver_result(Z.astype(np.float32), {"batch": batches.astype(str)}, mesh, 8, 3, 0,
                         "rotate", tconfig.harmony_options(block_size=0.25), early_stop=False,
                         device="cpu", estep_sub_tile=T, mstep_tile=TILE, mstep_mode="tiled",
                         virtual_r=virtual)


def _rank_main(argv):
    """A gloo rank (this file run as a script): the virtual and the written
    run on the mesh; writes their traces, Z_corr and generator states."""
    from harmony_tpu_torch import sharding

    rank, world, port, out_path = argv
    torch.set_num_threads(1)
    sharding.initialize_distributed("gloo", f"tcp://localhost:{port}", int(world), int(rank),
                                    timeout=120.0)
    mesh = sharding.make_mesh("cpu")
    out = {}
    for virtual in (True, False):
        res = _mesh_run(mesh, virtual)
        tiled = tengine.mstep_layout(res.config, res.design.codes, "cpu", mesh).tiled
        key = "virtual" if virtual else "written"
        out[key + "_tile"] = np.asarray(tiled.tile if tiled is not None else 0)
        out[key + "_engaged"] = np.asarray(res.state.virt_pen is not None)
        out[key + "_obj"] = np.asarray(res.objective_harmony)
        out[key + "_Zc"] = res.Z_corr
        out[key + "_gen"] = res.state.generator.get_state().numpy()
        out[key + "_lo"] = np.asarray(sharding.cell_range(res.config, mesh))
    np.savez(out_path, **out)
    print(json.dumps({"rank": mesh.rank, "ok": True}), flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_virtual_r_at_160_cell_tiles_on_two_ranks(tmp_path):
    """The carry route on 2 gloo ranks at tile 160: virtual R engages with
    K7's split moments on each shard, the ranks stay in lockstep, and the
    virtual run agrees with the written run on the same mesh and draws
    (Z_corr atol 2e-4, objective rtol 1e-5), and with one device's virtual
    run to 5% (other draws: each shard draws its own schedule)."""
    from harmony_tpu_torch.multihost_worker import free_port, json_line, run_ranks

    port = free_port()
    res = run_ranks([[sys.executable, os.path.abspath(__file__), str(r), str(MESH_WORLD),
                      str(port), str(tmp_path / f"rank{r}.npz")] for r in range(MESH_WORLD)],
                    240.0, cwd=ROOT)
    bad = [(r, rc, se[-3000:]) for r, (rc, _, se) in enumerate(res) if rc != 0]
    assert not bad, f"ranks failed or timed out: {bad}"
    assert all(json_line(so)["ok"] for _, so, _ in res)
    outs = [dict(np.load(str(tmp_path / f"rank{r}.npz"))) for r in range(MESH_WORLD)]
    o = outs[0]
    assert int(o["virtual_tile"]) == int(o["written_tile"]) == TILE
    assert bool(o["virtual_engaged"]) and not bool(o["written_engaged"])
    # a shard is whole E-step tiles, so its boundary is a layout tile's edge
    lo, hi = outs[1]["virtual_lo"]
    assert lo % T == 0 and lo % TILE == 0 and hi - lo == lo
    for other in outs[1:]:
        for k in ("virtual_obj", "written_obj", "virtual_gen", "written_gen"):
            np.testing.assert_array_equal(other[k], o[k])
    _close(o["virtual_Zc"], o["written_Zc"], rtol=0, atol=2e-4)
    _close(o["virtual_obj"], o["written_obj"], rtol=1e-5)
    one = _mesh_run(None, True)
    assert one.state.virt_pen is not None
    np.testing.assert_allclose(o["virtual_obj"][-1], one.objective_harmony[-1], rtol=0.05)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
