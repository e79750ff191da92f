"""Checkpoint and resume of harmony_tpu_torch, against itself and against
harmony_tpu.

* The file: ``.npz`` appended, an atomic overwrite (a failed write leaves
  the earlier file), the JAX config header and field set, bf16 fields as
  ``'V2'`` patterns.
* A full save loads back bit for bit, generator state included; a minimal
  save resumed with the port's own draws (the generator restored) matches
  the uninterrupted run, Z_corr atol 5e-4 (the bound of
  ``tests/test_cli.py:154``), on the permute and rotate schedules.
* A diverged round raises and leaves the last good checkpoint.
* Per-round minimal saves of a virtual-R run do not materialise R; a full
  save does, once.
* Across packages, float32, minimal and full: a checkpoint written by
  ``harmony_tpu.checkpoint.save_checkpoint`` resumes in the port with the
  JAX run's per-round draws injected (rotate schedules, permute
  permutations) and matches the JAX resume: objective rtol 1e-5, Z_corr
  atol 1e-4, the bands of ``tests/test_torch_rotate.py``. A port
  checkpoint loads in ``harmony_tpu.checkpoint.load_checkpoint``, with its
  fields and config, and runs a JAX round.
* A JAX bf16 checkpoint loads in the port with every bf16 field's bits
  equal, and a port bf16 checkpoint round-trips them.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from harmony_tpu import checkpoint as jckpt
from harmony_tpu import config as jconfig
from harmony_tpu import engine as jengine
from harmony_tpu import preprocess as jpre
from harmony_tpu import state as jstate
from harmony_tpu.ops import tiled as jtiled
from harmony_tpu_torch import checkpoint as tckpt
from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import driver as tdriver
from harmony_tpu_torch import engine as tengine
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import run_harmony
from harmony_tpu_torch import state as tstate
from harmony_tpu_torch.api import HarmonyResult
from harmony_tpu_torch.runtime import DivergenceError

from test_torch_rotate import _jax_table, _slice_setup as _rotate_setup

RESUME_ATOL = 5e-4


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _problem(n=4096, d=8, B=3, seed=9):
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    return Z.astype(np.float32), {"dataset": batches.astype(str)}


def _run(Z, meta, **kw):
    return run_harmony(Z, meta, ["dataset"], nclust=6, seed=0, device="cpu",
                       return_object=True, early_stop=False,
                       options=tconfig.harmony_options(block_size=0.25), **kw)


def test_path_suffix_and_atomic_overwrite(tmp_path, monkeypatch):
    res = _run(*_problem(n=600), max_iter=1, shuffle_mode="permute")
    base = str(tmp_path / "ck")
    assert tckpt.normalize_checkpoint_path(base) == base + ".npz"
    tckpt.save_checkpoint(base, res.config, res.state, meta={"seed": 3})
    tckpt.save_checkpoint(base, res.config, res.state, meta={"seed": 4})
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    assert tckpt.read_checkpoint_meta(base) == {"seed": 4}

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        tckpt.save_checkpoint(base, res.config, res.state, meta={"seed": 5})
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    assert tckpt.read_checkpoint_meta(base + ".npz") == {"seed": 4}


def test_header_is_the_jax_field_set(tmp_path):
    res = _run(*_problem(n=600), max_iter=1, shuffle_mode="permute")
    path = str(tmp_path / "ck.npz")
    tckpt.save_checkpoint(path, res.config, res.state)
    with np.load(path) as z:
        header = json.loads(bytes(z["__config__"]).decode())
        assert tstate.GENERATOR_FIELD in z.files
    assert set(header) == {f.name for f in dataclasses.fields(jconfig.HarmonyConfig)}
    assert header["estep_impl"] == "pallas" and header["mstep_impl"] == "pallas"
    assert tckpt.config_from_header(header) == res.config


@pytest.mark.parametrize("shuffle_mode", ["permute", "rotate"])
def test_full_round_trip(tmp_path, shuffle_mode):
    res = _run(*_problem(), max_iter=2, shuffle_mode=shuffle_mode)
    path = str(tmp_path / "full")
    tckpt.save_checkpoint(path, res.config, res.state, mode="full")
    cfg, st = tckpt.load_checkpoint(path, extra_rounds=0, device="cpu")
    assert cfg == res.config
    a = tstate.state_to_arrays(res.state, with_generator=True)
    b = tstate.state_to_arrays(st, with_generator=True)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("shuffle_mode", ["permute", "rotate"])
def test_minimal_resume_matches_uninterrupted(tmp_path, shuffle_mode):
    """Two rounds with a checkpoint a round, then one resumed round with the
    port's own draws (the generator restored), against three rounds."""
    Z, meta = _problem()
    path = str(tmp_path / "ck")
    first = _run(Z, meta, max_iter=2, shuffle_mode=shuffle_mode, checkpoint_path=path)
    full = _run(Z, meta, max_iter=3, shuffle_mode=shuffle_mode)
    assert first.config.rotate_route == ("carry" if shuffle_mode == "rotate" else None)
    meta_ck = tckpt.read_checkpoint_meta(path + ".npz")
    assert meta_ck["shuffle_mode"] == shuffle_mode and meta_ck["seed"] == 0
    Zd = Z.T if first.ingest_inv is None else Z.T[:, np.argsort(first.ingest_inv)]
    cfg, st = tckpt.load_checkpoint(path, Z=Zd, design=first.design, extra_rounds=1,
                                    device="cpu")
    assert st.n_harmony == 3 and cfg.max_iter_harmony == 3
    layout = tengine.mstep_layout(cfg, first.design.codes)
    st = tdriver.harmonize(cfg, st, max_iter=1, layout=layout)
    resumed = HarmonyResult(config=cfg, state=st, design=first.design,
                            ingest_inv=first.ingest_inv)
    np.testing.assert_allclose(resumed.Z_corr, full.Z_corr, rtol=0, atol=RESUME_ATOL)
    np.testing.assert_allclose(resumed.objective_harmony, full.objective_harmony, rtol=1e-4)
    np.testing.assert_array_equal(resumed.kmeans_rounds, full.kmeans_rounds)


def test_diverged_round_keeps_the_last_good_checkpoint(tmp_path, monkeypatch):
    correct = tengine.correct

    def poisoned(cfg, state, layout=None, mesh=None):
        out = correct(cfg, state, layout, mesh)
        if out.n_rounds == 2:
            out = dataclasses.replace(out, Z_corr=torch.full_like(out.Z_corr, float("nan")))
        return out

    monkeypatch.setattr(tengine, "correct", poisoned)
    path = str(tmp_path / "ck")
    with pytest.raises(DivergenceError):
        _run(*_problem(n=600), max_iter=4, shuffle_mode="permute", checkpoint_path=path)
    with np.load(path + ".npz") as z:
        assert int(z["n_harmony"]) == 3  # init, round 1, round 2
        assert np.isfinite(z["objective_harmony"][:3]).all()


def test_virtual_r_saves(tmp_path, monkeypatch):
    calls = []
    materialize = tengine.materialize_r

    def counted(cfg, state, mesh=None):
        calls.append(state.virt_pen is not None)
        return materialize(cfg, state, mesh)

    monkeypatch.setattr(tengine, "materialize_r", counted)
    path = str(tmp_path / "ck")
    res = _run(*_problem(), max_iter=2, shuffle_mode="rotate", virtual_r=True,
               checkpoint_path=path)
    assert res.state.virt_pen is not None, "virtual path did not engage"
    assert calls == [True]  # the run's own, after the loop; no save asked for one
    with np.load(path + ".npz") as z:
        assert "R" not in z.files and int(z["n_harmony"]) == 3
    tckpt.save_checkpoint(str(tmp_path / "full"), res.config, res.state, mode="full")
    assert calls == [True, True]
    with np.load(str(tmp_path / "full.npz")) as z:
        np.testing.assert_array_equal(z["R"], res.state.R.numpy())
    # the round-end file needs no G: the resumed round's cluster makes K6's
    # table and the virtual context again, and its correction reads them
    Z, meta = _problem()
    cfg, st = tckpt.load_checkpoint(path, Z=Z.T[:, np.argsort(res.ingest_inv)],
                                    design=res.design, extra_rounds=1, device="cpu")
    assert st.virt_pen is None and st.virt_G is None
    st = tengine.cluster(cfg, st, tiled=tengine.mstep_layout(cfg, res.design.codes).tiled)
    assert st.virt_pen is not None and st.virt_G is not None
    st = tdriver.harmonize(cfg, tengine.correct(cfg, st, tengine.mstep_layout(
        cfg, res.design.codes)), max_iter=0)
    full = _run(Z, meta, max_iter=3, shuffle_mode="rotate", virtual_r=True)
    resumed = HarmonyResult(config=cfg, state=st, design=res.design, ingest_inv=res.ingest_inv)
    np.testing.assert_allclose(resumed.Z_corr, full.Z_corr, rtol=0, atol=RESUME_ATOL)


def _slice_setup(N, Np, lamb):
    """tests/test_torch_rotate.py's rotate problem with both configs
    resolved as a run resolves them (T = 128 at this size), as a file
    written by either package holds them."""
    cj, ct, *rest = _rotate_setup(N, Np, lamb)
    return (jconfig.finalize_engine_config(cj), tconfig.finalize_engine_config(ct), *rest)


def _permute_setup(N=1200, d=8, K=8, B=3):
    rng = np.random.default_rng(11)
    batches = rng.integers(0, B, N)
    Z = ((rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(N, d))).astype(np.float32)
    jd = jpre.build_design({"dataset": batches}, ["dataset"])
    td = tpre.build_design({"dataset": batches}, ["dataset"])
    kw = dict(n_cells=N, d=d, nclust=K, max_iter=2, early_stop=False, verbose=False,
              lambda_estimation=True)
    cj = jpre.resolve_config(design=jd, options=jconfig.harmony_options(), **kw)
    cj = jconfig.finalize_engine_config(dataclasses.replace(cj, estep_impl="xla"))
    Zt = jpre.orient_embedding(Z, N)
    hj = jpre.expand_hyperparams(jd, cj.K, None, 0.1, None, 0.0)
    Y0 = Zt[:, rng.choice(N, K, replace=False)]
    return cj, jd, td, Zt, hj, Y0


def _jax_rounds(cfg, state, n, tiled=None, perms=None):
    cluster = jax.jit(lambda s, p: jengine.cluster(cfg, s, perms=p, tiled=tiled))
    correct = jax.jit(lambda s: jengine.correct(cfg, s, tiled=tiled))
    for i in range(n):
        state = correct(cluster(state, None if perms is None else jnp.asarray(perms[i])))
    return state


@pytest.mark.parametrize("mode", ["minimal", "full"])
@pytest.mark.parametrize("schedule", ["rotate", "permute"])
def test_jax_checkpoint_resumes_in_port(tmp_path, schedule, mode):
    """JAX runs two rounds and saves; JAX and the port each load the file
    and run a round with the same draws."""
    path = str(tmp_path / "jax")
    if schedule == "rotate":
        cj, _, jd, td, Zt, hj, _, Y0 = _slice_setup(4000, 4096, None)
        tiled_j = jtiled.detect_tiled_layout(np.asarray(jd.codes), cj.N, 128)
    else:
        cj, jd, td, Zt, hj, Y0 = _permute_setup()
        tiled_j = None
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    sj = _jax_rounds(cj, sj, 2, tiled_j)
    jckpt.save_checkpoint(path, cj, sj, mode=mode)

    cj2, sj2 = jckpt.load_checkpoint(path, Z=Zt, design=jd, extra_rounds=1)
    ct2, st2 = tckpt.load_checkpoint(path, Z=Zt, design=td, extra_rounds=1, device="cpu")
    assert (ct2.N, ct2.Np, ct2.K, ct2.max_iter_harmony) == (cj2.N, cj2.Np, cj2.K,
                                                          cj2.max_iter_harmony)
    layout = tengine.mstep_layout(ct2, td.codes)
    if schedule == "rotate":
        _, sub = jax.random.split(sj2.key)
        sched = _jax_table(ct2, jax.random.split(sub, cj2.max_iter_cluster))
        sj3 = _jax_rounds(cj2, sj2, 1, tiled_j)
        st3 = tengine.harmony_round(ct2, st2, schedules=sched, layout=layout)
    else:
        perms = np.stack([np.random.default_rng(s).permutation(cj2.N)
                          for s in range(cj2.max_iter_cluster)])[None]
        sj3 = _jax_rounds(cj2, sj2, 1, perms=perms)
        st3 = tengine.harmony_round(ct2, st2, perms=perms[0], layout=layout)
    tj, tt = sj3.trace_lists(cj2), st3.trace_lists(ct2)
    np.testing.assert_array_equal(tt["kmeans_rounds"], tj["kmeans_rounds"])
    np.testing.assert_allclose(tt["objective_kmeans"], tj["objective_kmeans"], rtol=1e-5)
    np.testing.assert_allclose(tt["objective_harmony"], tj["objective_harmony"], rtol=1e-5)
    np.testing.assert_allclose(st3.Z_corr.numpy(), np.asarray(sj3.Z_corr), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["minimal", "full"])
def test_port_checkpoint_loads_in_jax(tmp_path, mode):
    cj, ct, jd, td, Zt, _, ht, Y0 = _slice_setup(4000, 4096, None)
    st = tstate.init_state(ct, Zt, td, ht.sigma, ht.theta, ht.lamb, 3, "cpu")
    st = tengine.init_cluster_from(ct, st, Y0)
    layout = tengine.mstep_layout(ct, td.codes)
    for _ in range(2):
        st = tengine.harmony_round(ct, st, layout=layout)
    path = str(tmp_path / "port")
    tckpt.save_checkpoint(path, ct, st, mode=mode)
    cj2, sj2 = jckpt.load_checkpoint(path, Z=Zt, design=jd, extra_rounds=0)
    hdr = {k: v for k, v in dataclasses.asdict(cj2).items()
           if k not in ("estep_impl", "mstep_impl", "donate", "permute_sorted_blocks")}
    # permute_fused and n_shards are the port's own (resolved, not written)
    port = {k: v for k, v in dataclasses.asdict(ct).items()
            if k not in ("estep_impl", "mstep_impl", "permute_fused", "n_shards")}
    assert {**hdr, "B_vec": tuple(hdr["B_vec"])} == port
    arrays = tstate.state_to_arrays(st)
    for f in ("Y", "O", "E", "objective_kmeans", "objective_harmony", "kmeans_rounds",
              "sigma", "theta", "lamb", "Pr_b", "batch_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(sj2, f)), arrays[f], err_msg=f)
    assert int(sj2.n_harmony) == st.n_harmony and int(sj2.n_rounds) == st.n_rounds
    if mode == "full":
        for f in ("Z_orig", "R", "Z_corr", "codes"):
            np.testing.assert_array_equal(np.asarray(getattr(sj2, f)), arrays[f], err_msg=f)
    # the JAX package runs a round on it (its Pallas rotate rounds)
    tiled_j = jtiled.detect_tiled_layout(np.asarray(jd.codes), cj2.N, 128)
    sj3 = _jax_rounds(dataclasses.replace(cj2, estep_impl="pallas"), sj2, 1, tiled_j)
    assert np.isfinite(np.asarray(sj3.Z_corr)).all() and int(sj3.n_rounds) == 3


@pytest.mark.parametrize("mode", ["minimal", "full"])
def test_bf16_checkpoint_bits(tmp_path, mode):
    """A JAX bf16 file ('V2' fields) loads in the port bit for bit; a port
    bf16 file writes 'V2' and round-trips the bits."""
    cj, ct, jd, td, Zt, hj, _, Y0 = _slice_setup(4000, 4096, None)
    cj = dataclasses.replace(cj, dtype="bfloat16", matmul_precision="bfloat16")
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    path = str(tmp_path / "jax_bf16")
    jckpt.save_checkpoint(path, cj, sj, mode=mode)
    with np.load(path + ".npz") as z:
        assert z["Y"].dtype.kind == "V" and z["Y"].dtype.itemsize == 2
    ct2, st2 = tckpt.load_checkpoint(path, Z=Zt, design=td, extra_rounds=0, device="cpu")
    assert ct2.dtype == "bfloat16" and st2.Y.dtype == torch.bfloat16
    fields = ["Y", "O", "E", "sigma", "theta", "lamb", "Pr_b", "batch_sizes"]
    fields += ["Z_corr", "Z_orig", "R"] if mode == "full" else []
    for f in fields:
        np.testing.assert_array_equal(_bits(getattr(st2, f)),
                                      np.asarray(getattr(sj, f)).view(np.int16), err_msg=f)
    back = str(tmp_path / "port_bf16")
    tckpt.save_checkpoint(back, ct2, st2, mode=mode)
    with np.load(back + ".npz") as z:
        assert z["Z_corr"].dtype.kind == "V"
    _, st3 = tckpt.load_checkpoint(back, Z=Zt, design=td, extra_rounds=0, device="cpu")
    for f in fields:
        np.testing.assert_array_equal(_bits(getattr(st3, f)), _bits(getattr(st2, f)), err_msg=f)


@pytest.mark.parametrize("mode", ["minimal", "full"])
def test_f16_checkpoint_bits(tmp_path, mode):
    """A JAX float16 file (numpy float16 fields) loads in the port bit for
    bit; the port writes float16 fields back, and they round-trip."""
    cj, ct, jd, td, Zt, hj, _, Y0 = _slice_setup(4000, 4096, None)
    cj = dataclasses.replace(cj, dtype="float16", matmul_precision="bfloat16")
    sj = jstate.init_state(cj, Zt, jd, hj.sigma, hj.theta, hj.lamb, jax.random.PRNGKey(3))
    sj = jengine.init_cluster_from(cj, sj, jnp.asarray(Y0))
    path = str(tmp_path / "jax_f16")
    jckpt.save_checkpoint(path, cj, sj, mode=mode)
    with np.load(path + ".npz") as z:
        assert z["Y"].dtype == np.float16
    ct2, st2 = tckpt.load_checkpoint(path, Z=Zt, design=td, extra_rounds=0, device="cpu")
    assert ct2.dtype == "float16" and st2.Y.dtype == torch.float16 and ct2.bf16_products
    fields = ["Y", "O", "E", "sigma", "theta", "lamb", "Pr_b", "batch_sizes"]
    fields += ["Z_corr", "Z_orig", "R"] if mode == "full" else []
    for f in fields:
        np.testing.assert_array_equal(getattr(st2, f).numpy().view(np.int16),
                                      np.asarray(getattr(sj, f)).view(np.int16), err_msg=f)
    back = str(tmp_path / "port_f16")
    tckpt.save_checkpoint(back, ct2, st2, mode=mode)
    with np.load(back + ".npz") as z:
        assert z["Z_corr"].dtype == np.float16
    _, st3 = tckpt.load_checkpoint(back, Z=Zt, design=td, extra_rounds=0, device="cpu")
    for f in fields:
        assert torch.equal(getattr(st3, f), getattr(st2, f)), f
