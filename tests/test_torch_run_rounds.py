"""engine.run_rounds and driver.harmonize's one-dispatch path, on the CPU.

* The port's ``run_rounds`` (the iterations with the convergence test on
  the device, traces written at the state's device cursor; on CPU tensors
  the eager loop, the graph's plain version) equals the port's per-round
  host loop bit for bit: Z_corr, Y, R after ``materialize_r``, the four
  kmeans traces, ``objective_harmony``, ``kmeans_rounds`` and the cursors,
  with the early stop firing inside the budget (tests/test_integration.py:
  233-270's check), on the stats-carrying rotate route (R written, virtual
  R, the bf16 and the float16 engines) and the fused permute phase.
* ``driver.harmonize`` on the graph route takes ``run_rounds`` (on CPU
  tensors its eager loop) and equals the host loop bit for bit; it chunks
  the run into ``abort_poll_rounds`` calls when given an abort flag: 1 and
  2 equal the unchunked run bit for bit, and a flag set before the second
  chunk stops the run there (tests/test_aux.py:436-470).
* With injected draws (the schedule tables or permutations each iteration
  of the JAX engine makes), two iterations of ``run_rounds`` are held to
  the JAX package's per-round loop at the bounds of the slices' own tests
  (tests/test_torch_rotate.py, tests/test_torch_permute_phase.py):
  objective rtol 1e-5, Z_corr atol 1e-4 (1e-5 on the permute phase), R
  atol 1e-4.
* The schedule table: ``draw_schedules`` makes the generator calls it made
  as (rotation, block order) pairs, and the block each K7 launch decodes
  from the table (the kernels' arithmetic: position -> block -> first
  virtual tile, tiles) is the host path's, for every position; the K7
  twin fed a table row equals it fed the row of the pairs.
* ``HarmonyConfig.graph_route``, a property of the route: true on one
  device with the kernels on every route (the carry route under any
  budget, the two-phase route, the cell-granular round, the fused permute
  phase and the per-round permute route), false on a mesh and without the
  kernels.
* The cell-granular rotate round (below ``n_blocks * 128`` cells, run_harmony's
  ingest order and dense M-step): ``run_rounds`` equals
  ``driver.harmonize``'s host loop bit for bit with ``max_iter_cluster=7``,
  a window test stopping a phase, and ``harmonize`` takes it; its rounds
  (the schedule table's draws, the phase layout, the rounds, a 2-byte
  engine's float32 copies and cast back, the window tests and the rounds
  they guard) run with ``Tensor.item``, ``tolist``, ``__int__``,
  ``__index__`` and ``__bool__`` raising: no round reads the host.
* A checkpoint written after a run_rounds chunk equals one written after
  the host loop's iterations.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from harmony_tpu import engine as jengine
from harmony_tpu import state as jstate
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import api as tapi
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import driver as tdriver
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.checkpoint import save_checkpoint
from harmony_tpu_torch.ops import cuda_rotate
from harmony_tpu_torch.ops import rotate as tr
from harmony_tpu_torch.runtime import AbortFlag

from test_torch_permute_phase import _engine_setup
from test_torch_rotate import _jax_schedule, _slice_setup

MAX_ITER = 8
ROUTES = {
    "rotate": dict(shuffle_mode="rotate"),
    "virtual": dict(shuffle_mode="rotate", virtual_r=True),
    "bf16": dict(shuffle_mode="rotate", dtype="bfloat16"),
    "f16": dict(shuffle_mode="rotate", dtype="float16"),
    "permute_fused": dict(shuffle_mode="permute", permute_fused=True),
}


def _run_setup(route, N=4096, d=8, B=3, K=8, seed=5):
    """run_harmony's steps up to init_cluster on the CPU: the resolved
    config, the batch-tiled ingest order, the M-step layout and the
    initialised state."""
    kw = dict(ROUTES[route])
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, N)
    Z = ((rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(N, d))).astype(np.float32)
    design = tpre.build_design({"dataset": batches}, ["dataset"])
    opts = tconfig.harmony_options()
    cfg = tpre.resolve_config(
        n_cells=N, d=d, design=design, nclust=K, max_iter=MAX_ITER, early_stop=True,
        options=opts, verbose=False, lambda_estimation=True, ridge_solver="auto",
        shuffle_mode=kw.pop("shuffle_mode"), dtype=kw.pop("dtype", "float32"))
    cfg = tconfig.finalize_engine_config(dataclasses.replace(
        cfg, mstep_tile=128, mstep_mode="tiled", **kw))
    perm = tapi.order_from_recipe(design, cfg.shuffle_mode, seed, 128)
    _, design, _ = tapi.apply_ingest_order(design, perm)
    layout = tengine.mstep_layout(cfg, design.codes, "cpu")
    assert layout.tiled is not None
    hp = tpre.expand_hyperparams(design, cfg.K, None, 0.1, None, opts.tau)
    Zt = tpre.orient_embedding(Z, N)[:, perm]

    def state():
        st = tstate.init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, seed, "cpu")
        return tengine.init_cluster(cfg, st)

    return cfg, layout, state


def _host_loop(cfg, state, layout, n):
    """The per-round host loop: harmony_round, then the convergence read."""
    for _ in range(n):
        state = tengine.harmony_round(cfg, state, layout=layout)
        if tengine.harmony_converged(cfg, state):
            break
    return state


def _same(a, b):
    """Bit for bit: every tensor field an iteration writes, the traces and
    the cursors."""
    for f in ("Z_corr", "Y", "R", "O", "E", "objective_kmeans", "objective_kmeans_dist",
              "objective_kmeans_entropy", "objective_kmeans_cross", "objective_harmony",
              "kmeans_rounds", "virt_pen", "virt_blkmap", "virt_Zn", "virt_Y"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f
    assert (a.n_kmeans, a.n_harmony, a.n_rounds) == (b.n_kmeans, b.n_harmony, b.n_rounds)
    assert a.cursor is None and b.cursor is None
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("route", list(ROUTES))
def test_run_rounds_equals_host_loop(route):
    cfg, layout, state = _run_setup(route)
    host = _host_loop(cfg, state(), layout, MAX_ITER)
    fused = tengine.run_rounds(cfg, state(), MAX_ITER, layout)
    # the early stop fired inside the budget
    assert 2 <= host.n_rounds < MAX_ITER
    _same(fused, host)
    assert (fused.virt_pen is not None) == (route in ("virtual", "bf16", "f16"))
    _same(tengine.materialize_r(cfg, fused), tengine.materialize_r(cfg, host))


@functools.lru_cache(maxsize=1)
def _unchunked():
    """The virtual route's run through the driver's one-dispatch path (the
    driver takes run_rounds on the graph route, and run_rounds runs its
    plain loop because the tensors lie on the CPU), and through the host
    loop and materialize_r, as harmonize's per-round loop runs them."""
    cfg, layout, state = _run_setup("virtual")
    assert cfg.graph_route
    ref = tdriver.harmonize(cfg, state(), layout=layout)
    host = tengine.materialize_r(cfg, _host_loop(cfg, state(), layout, MAX_ITER))
    return cfg, layout, state, ref, host


def test_harmonize_takes_run_rounds_on_the_graph_route(monkeypatch):
    cfg, layout, state, ref, host = _unchunked()
    calls = []
    real = tengine.run_rounds
    monkeypatch.setattr(tengine, "run_rounds",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    out = tdriver.harmonize(cfg, state(), layout=layout)
    assert calls == [MAX_ITER]
    _same(out, host)


@pytest.mark.parametrize("polls", [1, 2])
def test_abort_poll_rounds_chunks_equal_the_unchunked_run(polls):
    cfg, layout, state, ref, host = _unchunked()
    chunked = tdriver.harmonize(cfg, state(), layout=layout, abort=AbortFlag(),
                                abort_poll_rounds=polls)
    assert 2 <= ref.n_rounds < MAX_ITER
    _same(chunked, ref)
    _same(ref, host)


class _AbortAt:
    """An abort flag that is set from its ``n``-th poll on."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def aborted(self):
        self.polls += 1
        return self.polls >= self.n


def test_abort_before_the_second_chunk_stops_there(monkeypatch):
    cfg, layout, state = _run_setup("rotate")
    flag = _AbortAt(2)
    calls = []
    real = tengine.run_rounds

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out.n_rounds)
        return out

    monkeypatch.setattr(tengine, "run_rounds", spy)
    with pytest.raises(KeyboardInterrupt):
        tdriver.harmonize(cfg, state(), layout=layout, abort=flag, abort_poll_rounds=2)
    assert calls == [2] and flag.polls == 2


def test_draw_schedules_keeps_the_generator_calls():
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(
        N=100_000, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate"))
    NT, nb = tr.n_tiles(ct), len(tr.block_sizes(ct)[0])
    g, h = torch.Generator(), torch.Generator()
    g.manual_seed(11)
    h.manual_seed(11)
    table = tr.draw_schedules(ct, g, 5)
    assert table.dtype == torch.int32 and table.shape == (5, 1 + nb)
    rts = torch.randint(0, NT, (5,), generator=h)
    orders = [torch.randperm(nb, generator=h) for _ in range(5)]
    assert tr.schedule_pairs(table) == [(int(r), o.tolist()) for r, o in zip(rts, orders)]
    assert torch.equal(tr.schedule_table(tr.schedule_pairs(table)), table)
    assert torch.equal(g.get_state(), h.get_state())


@pytest.mark.parametrize("N", [100_000, 23_000, 333_333])
def test_block_decode_matches_the_host_path(N):
    """K7's launches decode a position of the round's order through the
    schedule row and the block table (rotate.cu: blk = sched[1 + pos], v0 =
    (vstart[blk] + rt) % NT, ntile = sizes[blk], the tiles (v0 + j) % NT);
    every position gives the host path's block_tiles, and the block map
    read from the table's rotation is the host one's."""
    ct = tconfig.finalize_engine_config(tconfig.HarmonyConfig(
        N=N, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate"))
    NT = tr.n_tiles(ct)
    blocks = tr.block_table(ct, NT).numpy()
    nb = blocks.shape[1]
    g = torch.Generator()
    g.manual_seed(N)
    table = tr.draw_schedules(ct, g, 6)
    for row in table:
        rt = int(row[0])
        for pos in range(nb):
            blk = int(row[1 + pos])
            v0 = (blocks[1, blk] + rt) % NT
            tiles = [(v0 + j) % NT for j in range(blocks[0, blk])]
            assert tiles == tr.block_tiles(ct, rt, blk)
        assert torch.equal(tr.block_of_tiles(ct, row[0], "cpu"), tr.block_of_tiles(ct, rt, "cpu"))


def test_k7_twin_reads_the_table_row():
    cfg, layout, state = _run_setup("rotate")
    st = state()
    codes_pad = tr.make_codes_pad(cfg, st.codes)
    Y32, sig, Pr, th = (t.float() for t in (st.Y, st.sigma, st.Pr_b, st.theta))
    Zn, tO, O, E, G = tr.reassign(cfg, Y32, sig, Pr, tr.pad_cells_to_tile(cfg, st.Z_corr),
                                  codes_pad)
    lay = tr.CodesLayout(Z_pad=Zn, codes_pad=codes_pad, G=G)
    rs = tr.RoundState(R=tr.pad_cells_to_tile(cfg, st.R), E=E, O=O, tile_O=tO,
                       kmeans_error=None, entropy=None)
    g = torch.Generator()
    g.manual_seed(2)
    table = tr.draw_schedules(cfg, g, 2)
    for row, pair in zip(table, tr.schedule_pairs(table)):
        a = cuda_rotate.rotate_update_round_v2(cfg, Y32, rs, Pr, sig, th, row, lay,
                                               emit_pen=True)
        b = tr.rotate_update_round_v2(cfg, Y32, rs, Pr, sig, th, tr.schedule_table([pair])[0],
                                      lay, emit_pen=True)
        for f in ("R", "E", "O", "tile_O", "kmeans_error", "entropy", "pen", "blkmap"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def _cell_run_setup(mic=7, N=2000, d=8, B=3, K=8, seed=5, dtype="float32"):
    """run_harmony's steps up to init_cluster on the CPU on the cell-granular
    rotate round: the config (``max_iter_cluster=mic``), its ingest order
    (a plain permutation), the dense M-step's layout (the K4/K5 cell index)
    and the initialised state."""
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, N)
    Z = ((rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(N, d))).astype(np.float32)
    design = tpre.build_design({"dataset": batches}, ["dataset"])
    opts = tconfig.harmony_options(max_iter_cluster=mic)
    cfg = tconfig.finalize_engine_config(tpre.resolve_config(
        n_cells=N, d=d, design=design, nclust=K, max_iter=MAX_ITER, early_stop=True,
        options=opts, verbose=False, lambda_estimation=True, ridge_solver="auto",
        shuffle_mode="rotate", dtype=dtype))
    perm, _ = tapi.ingest_perm(cfg, design, seed)
    _, design, _ = tapi.apply_ingest_order(design, perm)
    layout = tengine.mstep_layout(cfg, design.codes, "cpu")
    hp = tpre.expand_hyperparams(design, cfg.K, None, 0.1, None, opts.tau)
    Zt = tpre.orient_embedding(Z, N)[:, perm]

    def state():
        st = tstate.init_state(cfg, Zt, design, hp.sigma, hp.theta, hp.lamb, seed, "cpu")
        return tengine.init_cluster(cfg, st)

    return cfg, layout, state


def test_cell_route_run_rounds_equals_the_host_loop(monkeypatch):
    cfg, layout, state = _cell_run_setup()
    assert cfg.rotate_route == "cell" and cfg.graph_route and cfg.max_iter_cluster == 7
    assert layout.tiled is None and layout.segments is None and layout.cells is not None
    host = tdriver.harmonize(cfg, state(), layout=layout, verbose=True)  # the host loop
    fused = tengine.run_rounds(cfg, state(), MAX_ITER, layout)
    rounds = host.kmeans_rounds[:host.n_rounds]
    assert (rounds < cfg.max_iter_cluster).any()  # a window test stopped a phase
    assert host.n_rounds >= 2
    _same(fused, host)
    calls = []
    real = tengine.run_rounds
    monkeypatch.setattr(tengine, "run_rounds",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    _same(tdriver.harmonize(cfg, state(), layout=layout), host)
    assert calls == [MAX_ITER]


def test_the_m_step_keeps_the_centroids_row_major():
    """The M-step's centroids keep the row-major layout of the graph route's
    static copies, so a product with Y reads the same operand layout in the
    host loop as in a captured iteration (a transposed Y made cuBLAS take
    another kernel in the host loop than in the capture on the card)."""
    cfg, layout, state = _cell_run_setup()
    st = tengine.harmony_round(cfg, state(), layout=layout)
    assert st.Y.is_contiguous()
    assert tengine.harmony_round(cfg, st, layout=layout).Y.is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_rounds_make_no_host_read(monkeypatch, dtype):
    """A clustering phase of the cell-granular round on a state with a device
    cursor (run_rounds' state), every round run: the guarded rounds' bodies
    run as a capture records them, unconditionally. Nothing may read a
    tensor to the host."""
    from harmony_tpu_torch import graphs

    cfg, _, state = _cell_run_setup(dtype=dtype)
    st = state()
    st = dataclasses.replace(st, cursor=tengine._cursor_of(st))
    n_k = st.n_kmeans

    def refuse(*a, **k):
        raise AssertionError("a cell-granular round read a tensor to the host")

    with monkeypatch.context() as m:
        m.setattr(graphs, "guarded", lambda flag, body: body())
        for name in ("item", "tolist", "__int__", "__index__", "__bool__"):
            m.setattr(torch.Tensor, name, refuse)
        out = tengine._cluster_rotate_written(cfg, st)
    assert out.cursor[0] == n_k + cfg.max_iter_cluster and out.R.dtype == st.R.dtype
    assert torch.isfinite(out.R.float()).all()
    np.testing.assert_allclose(out.R[:, :cfg.N].float().sum(0).numpy(), 1.0, atol=1e-2)
    with pytest.raises(AssertionError, match="read a tensor"):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "tolist", refuse)
            out.R.tolist()


@pytest.mark.parametrize("route,change,want", [
    ("cell", {}, True),
    ("cell", {"n_shards": 2}, False),
    ("cell", {"estep_impl": "torch"}, False),
    ("rotate", {}, True),
    ("permute_fused", {}, True),
    ("rotate", {"n_shards": 2}, False),
    ("permute_fused", {"n_shards": 2}, False),
    ("permute_fused", {"estep_impl": "torch"}, False),
    ("rotate", {"max_iter_cluster": 6}, True),
    ("rotate", {"rotate_stats_carry": False}, True),
    ("rotate", {"estep_impl": "torch"}, False),
    ("permute_fused", {"permute_fused": False}, True),
])
def test_graph_route(route, change, want):
    cfg = _cell_run_setup()[0] if route == "cell" else _run_setup(route)[0]
    assert dataclasses.replace(cfg, **change).graph_route is want


def test_graph_route_of_a_per_round_permute_config():
    cfg = tconfig.finalize_engine_config(tconfig.HarmonyConfig(
        N=4096, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="permute"))
    assert not cfg.permute_fused and cfg.graph_route
    cell = tconfig.finalize_engine_config(tconfig.HarmonyConfig(
        N=1000, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate"))
    assert cell.rotate_route == "cell" and cell.graph_route


def test_checkpoint_after_a_chunk_equals_the_host_loop(tmp_path):
    cfg, layout, state = _run_setup("virtual")
    fused = tengine.run_rounds(cfg, state(), 2, layout)
    host = _host_loop(cfg, state(), layout, 2)
    assert host.n_rounds == 2
    for name, st in (("fused", fused), ("host", host)):
        save_checkpoint(str(tmp_path / name), cfg, st, mode="minimal")
    a, b = (np.load(tmp_path / f"{n}.npz") for n in ("fused", "host"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_rotate_run_rounds_with_injected_draws_matches_jax():
    """Two iterations of run_rounds with the schedule tables JAX's cluster
    draws, against the JAX engine's per-round loop (the bounds of
    tests/test_torch_rotate.py's slice, lambda estimated)."""
    cj, ct, jd, td, Zt, hj, ht, Y0 = _slice_setup(4000, 4096, None)
    ct = dataclasses.replace(ct, estep_impl="kernel", mstep_impl="kernel")
    key = jax.random.PRNGKey(3)
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, key)
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    cluster_j = jax.jit(lambda s: jengine.cluster(cj, s, tiled=tiled_j))
    correct_j = jax.jit(lambda s: jengine.correct(cj, s, tiled=tiled_j))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    tables = []
    for _ in range(2):
        _, sub = jax.random.split(sj.key)
        tables.append(tr.schedule_table(
            [_jax_schedule(ct, k) for k in jax.random.split(sub, cj.max_iter_cluster)]))
        sj = correct_j(cluster_j(sj))
    st = tengine.run_rounds(ct, st, 2, tengine.MStepLayout(tiled_t),
                            schedules=torch.stack(tables))
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=1e-5)
    np.testing.assert_allclose(st.Z_corr.numpy(), np.asarray(sj.Z_corr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(st.R.numpy(), np.asarray(sj.R), rtol=0, atol=1e-4)


def test_permute_run_rounds_with_injected_draws_matches_jax():
    """Two iterations of run_rounds on the fused permute phase with the
    injected permutations, against the JAX engine's fused per-round loop
    (tests/test_torch_permute_phase.py's bounds)."""
    cj, ct, jd, td, Zt, hj, ht, Y0, perms = _engine_setup()
    ct = tconfig.finalize_engine_config(dataclasses.replace(
        ct, estep_impl="kernel", mstep_impl="kernel", mstep_tile=128, permute_fused=True))
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    tiled_j = jtiled.detect_tiled_layout(np.asarray(sj.codes), cj.N, 128)
    tiled_t = tengine.mstep_layout(ct, st.codes.numpy()).tiled
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    st = tengine.init_cluster_from(ct, st, Y0)
    for it in range(2):
        sj, M = jengine.cluster(cj, sj, jnp.asarray(perms[it]), tiled=tiled_j,
                                return_moments=True)
        sj = jengine.correct(cj, sj, tiled=tiled_j, tiled_moments=M)
    st = tengine.run_rounds(ct, st, 2, tengine.MStepLayout(tiled_t),
                            perms=torch.as_tensor(perms).long())
    tj, tt = sj.trace_lists(cj), st.trace_lists(ct)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=1e-5)
    np.testing.assert_allclose(st.Z_corr.numpy(), np.asarray(sj.Z_corr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.R.numpy(), np.asarray(sj.R), atol=1e-4, rtol=0)


def test_run_rounds_refuses_past_the_trace_capacity():
    cfg, layout, state = _run_setup("rotate")
    with pytest.raises(ValueError, match="trace capacity"):
        tengine.run_rounds(cfg, state(), MAX_ITER + 1, layout)


def test_count_goes_to_the_device_counter_while_an_iteration_is_captured(monkeypatch):
    """graphs.count adds to the wrapper's host count outside a capture; while
    an iteration is captured it adds to the graph's counter of that wrapper
    (on the card a captured add, run by each replay that runs the body) and
    leaves the host count alone."""
    import types

    from harmony_tpu_torch import graphs

    f = cuda_rotate.reassign
    n0 = f.launches
    try:
        graphs.count(f, 3)
        assert f.launches == n0 + 3
        open_graph = types.SimpleNamespace(slot={f: 1}, counts=torch.zeros(2, dtype=torch.int64),
                                           tables=[])
        monkeypatch.setattr(graphs, "_capturing", open_graph)
        graphs.count(f, 2)
        graphs.count(f)
        assert f.launches == n0 + 3 and open_graph.counts.tolist() == [0, 3]
    finally:
        f.launches = n0
