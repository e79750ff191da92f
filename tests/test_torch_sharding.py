"""harmony_tpu_torch.sharding and the mesh geometry against harmony_tpu's,
in one process (no ranks are started here).

* ``pad_for_mesh`` and each rank's contiguous cell range equal the JAX
  package's ``pad_for_mesh`` and the ``addressable_shards`` of a
  ``P(None, CELL_AXIS)`` array on 1, 2 and 4 of conftest's virtual
  devices, over a sweep of N.
* ``finalize_engine_config(cfg, mesh)`` equals the JAX package's: the
  rotate geometry (sub-tile T, padded N) per shard, its kernel gate
  ``Np // n_shards >= n_blocks * 128`` and the fused permute gate (the JAX
  side resolved as on a TPU, where its 'auto' picks Pallas).
* The batch-tiled ingest order with ``n_shards`` equals the JAX
  package's; each rank's columns of a state (``init_state(mesh=)``,
  streamed, and ``state_from_arrays(mesh=)``) equal the JAX shard's data,
  and a shard's padded codes equal its slice of the JAX global ones.
* ``AsyncIngest(mesh=)`` copies only the rank's columns, in chunks of
  ``chunk_bytes`` (the JAX mesh path ignores it), pads zero.
* The ranks' schedules: each takes its own of every shard's draws, the
  generator advancing alike on every rank.
* ``initialize_distributed`` raises on a failed init and is idempotent.
* Every mesh route ported in ROADMAP A11's part 2 (the per-round permute
  schedule, the cell-granular rotate round and ``rotate_stats_carry=False``,
  the dense and segmented M-steps, the bf16 engine) and the float16
  engine resolve as the JAX package resolves them on a mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from harmony_tpu import config as jconfig
from harmony_tpu import preprocess as jpre
from harmony_tpu import sharding as jsh
from harmony_tpu import state as jstate
from harmony_tpu.ops import pallas_rotate as jpr
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import run_harmony, sharding as tsh
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.api import ingest_perm
from harmony_tpu_torch.ops import rotate as tr
from harmony_tpu_torch.ops import tiled as ttiled
from harmony_tpu_torch.runtime import AsyncIngest

CPU = torch.device("cpu")


def _mesh(n, rank=0):
    return tsh.CellMesh(rank=rank, size=n, device=CPU)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("N", [6, 101, 1001, 4000, 4096, 12_345, 500_000])
def test_pad_and_cell_ranges_match_jax_shards(n, N):
    kw = dict(N=N, d=4, K=3, B=2, B_vec=(2,))
    jm = jsh.make_mesh(n)
    cj = jsh.pad_for_mesh(jconfig.HarmonyConfig(**kw), jm)
    ct = tsh.pad_for_mesh(tconfig.HarmonyConfig(**kw), _mesh(n))
    assert (ct.N_pad, ct.Np) == (cj.N_pad, cj.Np)
    arr = jax.device_put(jnp.arange(cj.Np)[None, :], NamedSharding(jm, P(None, jsh.CELL_AXIS)))
    devices = list(jm.devices.flat)
    for shard in arr.addressable_shards:
        r = devices.index(shard.device)
        lo, hi = tsh.cell_range(ct, _mesh(n, r))
        np.testing.assert_array_equal(np.asarray(shard.data)[0], np.arange(lo, hi))
        assert tsh.valid_cells(ct, _mesh(n, r)) == int(np.sum(np.arange(lo, hi) < N))


ROTATE_SHAPES = [(500_000, 50, 100, (10,)), (100_000, 20, 30, (3,)), (20_000, 50, 100, (10,)),
                 (3000, 8, 5, (3,)), (4000, 8, 8, (3,)), (3600, 8, 8, (3,)),
                 (60_000, 30, 50, (4, 5)), (2_000_000, 50, 100, (10,)),
                 (130_001, 16, 200, (40,))]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("N,d,K,B_vec", ROTATE_SHAPES)
def test_finalize_engine_config_matches_jax_per_shard(n, N, d, K, B_vec, monkeypatch):
    jm = jsh.make_mesh(n)
    for bs in (0.05, 0.25):
        kw = dict(N=N, d=d, K=K, B=sum(B_vec), B_vec=B_vec, block_size=bs)
        # the rotate geometry of the kernel route
        cj = jconfig.finalize_engine_config(jsh.pad_for_mesh(jconfig.HarmonyConfig(
            **kw, shuffle_mode="rotate", estep_impl="pallas"), jm), jm)
        ct = tconfig.finalize_engine_config(tsh.pad_for_mesh(tconfig.HarmonyConfig(
            **kw, shuffle_mode="rotate"), _mesh(n)), _mesh(n))
        assert ct.n_shards == n
        if ct.rotate_route == "carry":
            assert (ct.estep_sub_tile, ct.Np) == (cj.estep_sub_tile, cj.Np)
            assert ct.Np % (n * ct.estep_sub_tile) == 0
        # the gates: the JAX 'auto' resolved as on a TPU
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        for mode in ("rotate", "permute"):
            cj = jconfig.finalize_engine_config(jsh.pad_for_mesh(jconfig.HarmonyConfig(
                **kw, shuffle_mode=mode, estep_impl="auto"), jm), jm)
            ct = tconfig.finalize_engine_config(tsh.pad_for_mesh(tconfig.HarmonyConfig(
                **kw, shuffle_mode=mode), _mesh(n)), _mesh(n))
            if mode == "rotate":
                assert (cj.estep_impl == "pallas") == (ct.rotate_route == "carry")
                if ct.rotate_route == "carry":
                    assert (ct.estep_sub_tile, ct.Np) == (cj.estep_sub_tile, cj.Np)
            else:
                assert (cj.estep_impl == "pallas") == ct.permute_fused
                assert ct.Np == cj.Np
        monkeypatch.undo()


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("N,B", [(200_000, 10), (60_000, 3), (40_000, 20)])
def test_batch_tiled_order_with_shards_matches_jax(n, N, B):
    rng = np.random.default_rng(N + B)
    codes = rng.integers(0, B, N)
    kw = dict(N=N, d=4, K=8, B=B, B_vec=(B,), shuffle_mode="rotate")
    ct = tconfig.finalize_engine_config(tsh.pad_for_mesh(tconfig.HarmonyConfig(**kw),
                                                         _mesh(n)), _mesh(n))
    # as harmony_tpu/api.py:499-502 calls it: on the finalised config
    jm = jsh.make_mesh(n)
    cj = jconfig.finalize_engine_config(jsh.pad_for_mesh(jconfig.HarmonyConfig(
        **kw, estep_impl="pallas"), jm), jm)
    assert cj.Np == ct.Np
    nj = ttiled.count_joint_levels(codes[None])
    tj = jtiled.choose_tiled_tile(cj, nj, n_shards=n)
    assert ttiled.choose_tiled_tile(ct, nj, n) == tj
    design = tpre.build_design({"b": codes}, ["b"])
    perm, tile = ingest_perm(ct, design, seed=3)
    assert tile == (tj or 0)
    if tj:
        np.testing.assert_array_equal(perm, jtiled.build_batch_tiled_order(
            design.codes, tj, 3)[0])
    else:
        np.testing.assert_array_equal(perm, np.random.default_rng(3).permutation(N))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("N", [4096, 3600])
def test_rank_columns_match_jax_shards(n, N):
    rng = np.random.default_rng(2)
    d = 8
    batches = rng.integers(0, 3, N)
    Z = rng.normal(size=(N, d)).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    jm = jsh.make_mesh(n)
    kw = dict(N=N, d=d, K=8, B=3, B_vec=(3,), shuffle_mode="rotate", block_size=0.25)
    cj = jconfig.finalize_engine_config(jsh.pad_for_mesh(jconfig.HarmonyConfig(
        **kw, estep_impl="pallas"), jm), jm)
    ct = tconfig.finalize_engine_config(tsh.pad_for_mesh(tconfig.HarmonyConfig(**kw),
                                                         _mesh(n)), _mesh(n))
    assert ct.Np == cj.Np and ct.Np > N or N == 4096
    sig, th, lam = np.full(8, 0.1), np.full(3, 2.0), np.ones(4)
    sj = jsh.shard_state(jstate.init_state(cj, Z.T, jd, sig, th, lam, jax.random.PRNGKey(0)),
                         jm)
    arrays = {f: np.asarray(getattr(sj, f)) for f in tstate.ARRAY_FIELDS}
    cp_j = jpr.make_codes_pad(cj, sj.codes)
    devices = list(jm.devices.flat)
    for f in ("Z_orig", "Z_corr", "codes"):
        for shard in getattr(sj, f).addressable_shards:
            r = devices.index(shard.device)
            # streamed from the host array: only the rank's columns
            st = tstate.init_state(ct, Z.T, td, sig, th, lam, 0, CPU, mesh=_mesh(n, r))
            # Z_corr is normalised by each package (one ulp apart)
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(shard.data), rtol=0,
                                       atol=1e-6 if f == "Z_corr" else 0)
            back = tstate.state_from_arrays(ct, arrays, CPU, mesh=_mesh(n, r))
            np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(shard.data))
            lo, hi = tsh.cell_range(ct, _mesh(n, r))
            np.testing.assert_array_equal(tr.make_codes_pad(ct, st.codes, _mesh(n, r)).numpy(),
                                          np.asarray(cp_j)[:, lo:hi])


@pytest.mark.parametrize("perm", [None, "shuffled"])
def test_async_ingest_streams_only_the_ranks_columns_in_chunks(perm):
    N, d, n = 1000, 6, 4
    Z = np.random.default_rng(0).normal(size=(d, N))
    ct = tsh.pad_for_mesh(tconfig.HarmonyConfig(N=N, d=d, K=3, B=2, B_vec=(2,), N_pad=1012),
                          _mesh(n))
    order = None if perm is None else np.random.default_rng(1).permutation(N)
    src = np.arange(N) if order is None else order
    for r in range(n):
        m = _mesh(n, r)
        lo, hi = tsh.cell_range(ct, m)
        # 40 columns a chunk (6 float32 values a column)
        ing = AsyncIngest(Z, ct, CPU, chunk_bytes=40 * d * 4, mesh=m)
        assert ing.n_chunks == -(-tsh.valid_cells(ct, m) // 40)
        ing.order(order)
        out = ing.result()
        want = np.zeros((d, hi - lo), np.float32)
        nv = tsh.valid_cells(ct, m)
        want[:, :nv] = Z[:, src[lo:lo + nv]]
        np.testing.assert_array_equal(out.numpy(), want)
    for m in (_mesh(n), None):
        with AsyncIngest(Z, ct, CPU, mesh=m) as ing:
            ing.order(order)
            with pytest.raises(ValueError, match="given already"):
                ing.result(np.arange(N))


def test_each_rank_takes_its_own_schedule():
    n, rounds = 4, 3
    ct = tconfig.finalize_engine_config(tsh.pad_for_mesh(tconfig.HarmonyConfig(
        N=100_000, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate"), _mesh(n)), _mesh(n))
    NT = ct.Np // n // ct.estep_sub_tile
    gens = []
    for r in range(n + 1):
        g = torch.Generator()
        g.manual_seed(5)
        gens.append(g)
    every = tr.schedule_pairs(tr.draw_schedules(ct, gens[n], rounds * n, NT))
    for r in range(n):
        mine = tr.schedule_pairs(tengine.draw_shard_schedules(ct, gens[r], rounds, _mesh(n, r), NT))
        assert mine == every[r::n] and len(mine) == rounds
        for rt, order in mine:
            assert 0 <= rt < NT and sorted(order) == list(range(len(order)))
        assert torch.equal(gens[r].get_state(), gens[n].get_state())
    # the shards of a round draw apart
    assert len({(rt, tuple(o)) for rt, o in every[:n]}) > 1


def test_initialize_distributed_raises_on_bad_init(monkeypatch):
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def boom(*a, **k):
        raise RuntimeError("Connection refused: unable to reach the store at 127.0.0.1:1")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="Connection refused"):
        tsh.initialize_distributed("gloo", "tcp://127.0.0.1:1", world_size=2, rank=0,
                                   timeout=1.0)


def test_initialize_distributed_idempotent(monkeypatch):
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)

    def boom(*a, **k):  # pragma: no cover - must not be called
        raise AssertionError("init_process_group called on an initialised group")

    monkeypatch.setattr(dist, "init_process_group", boom)
    assert tsh.initialize_distributed("gloo") == 3


def _cells(n, B, seed=0, d=4):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.8)[b] + rng.normal(size=(n, d))
    return Z, {"dataset": b.astype(str)}


def _codes_of(n_cells, B):
    return tpre.build_design(_cells(n_cells, B)[1], ["dataset"]).codes


def _resolve_both(n_cells, B, kw, n=2):
    """The configs a run on an ``n``-device mesh resolves: the port's as
    ``run_harmony(mesh=)`` builds it, the JAX package's as its ``RunHarmony``
    does with its 'auto' resolved as on a TPU; and the port's M-step layout
    on its ingest order (rank 0's)."""
    Z, meta = _cells(n_cells, B)
    opts = kw.get("options", tconfig.harmony_options())
    jopts = jconfig.harmony_options(**dataclasses.asdict(opts))
    common = dict(n_cells=n_cells, d=4, nclust=6, max_iter=3, early_stop=True, verbose=False,
                  lambda_estimation=True, shuffle_mode=kw["shuffle_mode"],
                  dtype=kw.get("dtype", "float32"))
    td = tpre.build_design(meta, ["dataset"])
    ct = tpre.resolve_config(design=td, options=opts, **common)
    ct = tconfig.finalize_engine_config(tsh.pad_for_mesh(ct, _mesh(n)), _mesh(n))
    jm = jsh.make_mesh(n)
    jd = jpre.build_design(meta, ["dataset"])
    cj = jpre.resolve_config(design=jd, options=jopts, **common)
    cj = jconfig.finalize_engine_config(
        jsh.pad_for_mesh(dataclasses.replace(cj, estep_impl="auto"), jm), jm)
    perm, _ = ingest_perm(ct, td, 0)
    codes = td.codes if perm is None else td.codes[:, perm]
    return ct, cj, tengine.mstep_layout(ct, codes, CPU, _mesh(n))


@pytest.mark.parametrize(
    "n_cells,B,kw,route",
    [(3000, 3, {"shuffle_mode": "permute"}, "the per-round permute schedule"),
     (6000, 3, {"shuffle_mode": "rotate", "options": tconfig.harmony_options(
         max_iter_cluster=6)}, "the rotate rounds past the static budget"),
     (3000, 3, {"shuffle_mode": "rotate"}, "the cell-granular rotate round"),
     (12_000, 30, {"shuffle_mode": "rotate"}, "the segmented and dense M-steps"),
     (12_000, 3, {"shuffle_mode": "rotate", "dtype": "bfloat16"}, "dtype='bfloat16'"),
     (12_000, 3, {"shuffle_mode": "rotate", "dtype": "float16"}, "dtype='float16'")],
)
def test_mesh_routes_of_part_2_raise(n_cells, B, kw, route, monkeypatch):
    """The routes that raised on a mesh until ROADMAP A11's part 2 was
    ported resolve on a 2-rank mesh as the JAX package resolves them there
    (its 'auto' as on a TPU: Pallas on the stats-carrying rotate route and
    the fused permute phase, XLA elsewhere; the same padded axis), take
    the M-step layout it takes; so does the float16 engine, which raised
    until it was ported."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ct, cj, layout = _resolve_both(n_cells, B, kw)
    assert ct.n_shards == 2 and ct.Np == cj.Np and ct.dtype == cj.dtype
    assert (cj.estep_impl == "pallas") == (ct.rotate_route == "carry" or ct.permute_fused)
    if route == "the per-round permute schedule":
        assert ct.shuffle_mode == "permute" and not ct.permute_fused
    elif route == "the cell-granular rotate round":
        assert ct.rotate_route == "cell" and cj.estep_impl == "xla"
    else:
        assert ct.rotate_route == "carry"
    if route == "the segmented and dense M-steps":
        # no batch-tiled order passes the mixture gate at 30 batches
        assert layout.tiled is None and layout.segments is None
        assert not cj.use_segments
    if kw.get("dtype") in ("bfloat16", "float16"):
        assert ct.virtual_r and cj.virtual_r and ct.bf16_products
    # the batch-tiled M-step where the JAX package's ingest takes its order
    tj = cj.estep_impl == "pallas" and jtiled.choose_tiled_tile(
        cj, ttiled.count_joint_levels(_codes_of(n_cells, B)), n_shards=2)
    assert (layout.tiled is not None) == bool(tj)


def test_written_r_rounds_on_a_mesh_raise(monkeypatch):
    """rotate_stats_carry=False has no run_harmony argument: on a mesh it
    resolves to the cell-granular round, as the JAX package's 'auto' takes
    its XLA round there (only its stats-carry kernel has a sharded
    wrapper), as the float16 engine's rotate route does (it raised until it
    was ported)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    base = tconfig.HarmonyConfig(N=20_000, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate")
    jm = jsh.make_mesh(2)
    for change, route in (({"rotate_stats_carry": False}, "cell"), ({"N": 3000}, "cell"),
                          ({"shuffle_mode": "permute"}, None), ({"dtype": "bfloat16"}, "carry"),
                          ({}, "carry")):
        cfg = tconfig.finalize_engine_config(tsh.pad_for_mesh(
            dataclasses.replace(base, **change), _mesh(2)), _mesh(2))
        cj = jconfig.finalize_engine_config(jsh.pad_for_mesh(jconfig.HarmonyConfig(
            **{**dict(N=20_000, d=4, K=8, B=3, B_vec=(3,), shuffle_mode="rotate",
                      estep_impl="auto"), **change}),
            jm), jm)
        assert cfg.rotate_route == route and cfg.Np == cj.Np
        assert (cj.estep_impl == "pallas") == (route == "carry")
    # one device keeps K12 for the same change
    one = tconfig.finalize_engine_config(dataclasses.replace(base, rotate_stats_carry=False))
    assert one.rotate_route == "two_phase"
    f16 = tconfig.finalize_engine_config(tsh.pad_for_mesh(
        dataclasses.replace(base, dtype="float16", matmul_precision="auto"), _mesh(2)), _mesh(2))
    assert f16.rotate_route == "carry" and f16.virtual_r and f16.bf16_products
