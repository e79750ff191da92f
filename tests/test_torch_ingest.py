"""Streamed ingest (``runtime.AsyncIngest``, ``run_harmony(stream_ingest=)``)
on the CPU.

* ``run_harmony`` with ``stream_ingest=True`` (the copy overlapping the
  ingest order) against ``False`` (the copy first), on the permute
  schedule and on the rotate schedule (the batch-tiled ingest order, pad
  cells), float32 and bfloat16: ``Z_orig`` bit-equal to each other and to
  the plain host path (the caller's array cast by ``runtime.engine_cast``
  and reordered), and the results equal. The input is float64 with values
  that round differently through float32 than straight to bf16, so the one
  conversion rule is what makes the bits agree.
* ``AsyncIngest`` alone with ``chunk_bytes`` small enough for many chunks,
  a ragged last chunk and pad cells, with and without an order.
* An exception on the thread is raised by ``result``; an error in the
  caller's set-up leaves no copy running.
* 'auto' streams at every size: the order is built while the copy runs;
  ``False`` joins the copy first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from harmony_tpu_torch import config as tconfig
from harmony_tpu_torch import preprocess as tpre
from harmony_tpu_torch import run_harmony
from harmony_tpu_torch import api
from harmony_tpu_torch.config import HarmonyConfigError
from harmony_tpu_torch.runtime import AsyncIngest, engine_cast


def _problem(n, d=8, B=3, seed=5):
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, B, n)
    Z = (rng.normal(size=(B, d)) * 0.8)[batches] + rng.normal(size=(n, d))
    # values 2^-30 above a bf16 midpoint, below float32's resolution there:
    # straight to bf16 they would round up, through float32 they tie to even
    Z[: n // 2, 0] = 1.0 + 2.0 ** -8 + 2.0 ** -30
    return Z, {"dataset": batches.astype(str)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_the_conversion_rounds_through_float32():
    x = torch.tensor([1.0 + 2.0 ** -8 + 2.0 ** -30], dtype=torch.float64)
    assert engine_cast(x, torch.bfloat16).item() == 1.0
    assert engine_cast(x, torch.float32).item() == np.float32(x.item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffle_mode", ["permute", "rotate"])
def test_streamed_equals_host_path(shuffle_mode, dtype):
    Z, meta = _problem(3000)
    kw = dict(nclust=6, max_iter=2, seed=0, device="cpu", return_object=True,
              shuffle_mode=shuffle_mode, dtype=dtype,
              options=tconfig.harmony_options(block_size=0.25))
    host = run_harmony(Z, meta, ["dataset"], stream_ingest=False, **kw)
    streamed = run_harmony(Z, meta, ["dataset"], stream_ingest=True, **kw)
    for res in (host, streamed):
        assert "ingest_stream" in res.phase_seconds()
    if shuffle_mode == "rotate":
        assert host.ingest_inv is not None and host.config.Np > host.config.N
    np.testing.assert_array_equal(_bits(streamed.state.Z_orig), _bits(host.state.Z_orig))
    # the plain host path: cast the caller's array, reorder it, pad it
    cfg, inv = host.config, host.ingest_inv
    want = engine_cast(torch.from_numpy(Z.T.copy()), getattr(torch, dtype))
    if inv is not None:
        want = want[:, np.argsort(inv)]
    want = torch.nn.functional.pad(want, (0, cfg.Np - cfg.N))
    np.testing.assert_array_equal(_bits(streamed.state.Z_orig), _bits(want))
    np.testing.assert_array_equal(streamed.Z_corr, host.Z_corr)
    np.testing.assert_array_equal(streamed.objective_harmony, host.objective_harmony)


def _cfg(N, d, dtype, N_pad=None):
    design = tpre.build_design({"b": np.zeros(N, int)}, ["b"])
    cfg = tpre.resolve_config(n_cells=N, d=d, design=design, nclust=3, max_iter=1,
                              early_stop=True, options=tconfig.harmony_options(),
                              verbose=False, dtype=dtype)
    return dataclasses.replace(cfg, N_pad=N_pad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_perm", [False, True])
def test_chunks_ragged_tail_and_pads(dtype, with_perm):
    N, Np, d = 1001, 1152, 7
    Z = _problem(N, d)[0].T.copy()
    cfg = _cfg(N, d, dtype, Np)
    item = getattr(torch, dtype).itemsize
    stream = AsyncIngest(Z, cfg, "cpu", chunk_bytes=d * item * 64)
    assert stream.cols == 64 and stream.n_chunks == 16 and N % 64
    perm = np.random.default_rng(1).permutation(N) if with_perm else None
    out = stream.result(perm)
    Zp = Z if perm is None else Z[:, perm]
    want = engine_cast(torch.from_numpy(np.ascontiguousarray(Zp)), out.dtype)
    assert out.shape == (d, Np) and out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(out[:, :N]), _bits(want))
    assert (out[:, N:] == 0).all()


def test_thread_error_is_raised():
    cfg = _cfg(100, 4, "float32")
    bad = np.empty((4, 100), dtype=object)  # torch cannot take object arrays
    stream = AsyncIngest(bad, cfg, "cpu")
    with pytest.raises(TypeError):
        stream.result()


class _Spy(AsyncIngest):
    """AsyncIngest that records its instances and the order of the calls."""

    made, calls = [], []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Spy.made.append(self)

    def join(self):
        _Spy.calls.append("join")
        super().join()


@pytest.fixture
def spy(monkeypatch):
    _Spy.made, _Spy.calls = [], []
    perm = api.ingest_perm
    monkeypatch.setattr(api, "AsyncIngest", _Spy)
    monkeypatch.setattr(api, "ingest_perm",
                        lambda *a, **k: (_Spy.calls.append("order"), perm(*a, **k))[1])
    return _Spy


@pytest.mark.parametrize("stream_ingest,first", [("auto", "order"), (True, "order"),
                                                 (False, "join")])
def test_auto_gate(spy, stream_ingest, first):
    Z, meta = _problem(600)
    res = run_harmony(Z, meta, ["dataset"], nclust=4, max_iter=1, device="cpu",
                      return_object=True, shuffle_mode="rotate", stream_ingest=stream_ingest)
    assert spy.calls[0] == first and "order" in spy.calls and len(spy.made) == 1
    assert "ingest_stream" in res.phase_seconds()


def _raise_in_order(*a, **k):
    raise RuntimeError("order")


@pytest.mark.parametrize("bad,exc", [
    ({"theta": [1.0, 2.0]}, HarmonyConfigError),  # one covariate, two thetas
    ({"init_Y": np.zeros((3, 3))}, ValueError),
    ("order", RuntimeError),  # raised while the copy runs
])
def test_setup_error_leaves_no_copy_running(spy, monkeypatch, bad, exc):
    Z, meta = _problem(600)
    kw = {}
    if bad == "order":
        monkeypatch.setattr(api, "ingest_perm", _raise_in_order)
    else:
        kw = bad
    with pytest.raises(exc):
        run_harmony(Z, meta, ["dataset"], nclust=4, max_iter=1, device="cpu",
                    stream_ingest=True, **kw)
    # the arguments are checked before the copy starts; a later error joins it
    assert len(spy.made) == (bad == "order")
    assert all(not s._thread.is_alive() for s in spy.made)


def test_init_state_streams_a_host_array():
    N, d = 700, 5
    Z = _problem(N, d)[0].T.copy()
    cfg = _cfg(N, d, "bfloat16", 768)
    design = tpre.build_design({"b": np.zeros(N, int)}, ["b"])
    from harmony_tpu_torch.state import init_state

    one = np.ones(1)
    st = init_state(cfg, Z, design, one * 0.1, one, one, 0, "cpu")
    np.testing.assert_array_equal(_bits(st.Z_orig), _bits(AsyncIngest(Z, cfg, "cpu").result()))
    with pytest.raises(ValueError):
        AsyncIngest(Z[:, 1:], cfg, "cpu")
