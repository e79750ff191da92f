"""CUDA graphs of the one-dispatch run (:func:`engine.run_rounds`).

The JAX package runs a whole Harmony run as one device program: a
``lax.while_loop`` whose body is a Harmony iteration and whose predicate,
the convergence test, is computed on the device
(harmony_tpu/engine.py:709-767). The port's counterpart captures one
iteration once into a CUDA graph whose launches sit inside an IF
conditional node on a device predicate (:class:`IterationGraph`, the node
built by ``csrc/graph.cu``), and replays it once per iteration with no host
read in between. Stretches of the iteration that the JAX package runs
under a ``lax.cond`` or as the clustering ``while_loop``'s later rounds are
guarded regions (:func:`guarded`): inside the graph each sits in an IF
node of its own on its device flag, and on the host (CPU tensors, or the
capture's eager warm-up) it is a Python ``if`` on one read of the flag.
This module holds what the capture needs besides the engine:

* :func:`device_cache`, the cache of the host tables that the kernels'
  wrappers copy to the card once (a copy from host memory cannot be
  captured). While a capture is open every table it hands out is also kept
  by the graph, so no table a replay reads is freed when the cache evicts
  it.
* :func:`count`, through which every kernel wrapper counts its launches
  where it issues them: on the host when it runs, but while an iteration
  is captured on the device, into a counter of the graph's that the
  captured stream increments beside the launches, so a replay counts them
  exactly when its IF node runs the body. The run reads the counters with
  its one read at the end (:meth:`IterationGraph.add_counts`).
* The generator's offset (:func:`rng_offset`): a replay advances the
  registered generator by the iteration's draws whether or not the IF node
  runs the body, and the run puts it back to the draws made.
* :func:`stamp`, a one-thread kernel that writes the card's global timer
  into a slot of a buffer, on the stream: ``runtime.PhaseTimers``' spans
  take two each, and the captured iteration takes three an iteration, in
  slots picked on the device by the iteration counter.

Conditional nodes need a CUDA runtime of 12.4 or later.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import _build

# The IterationGraph being captured, if one is: it holds the tables the
# capture reads and the device counters of the launches it captures.
_capturing: Optional["IterationGraph"] = None


def device_cache(maxsize: int):
    """``functools.lru_cache`` for the functions that copy a host table to
    the card; each result is also kept by the graph being captured, if one
    is."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            out = cached(*args)
            if _capturing is not None:
                _capturing.tables.append(out)
            return out

        get.cache_clear = cached.cache_clear
        return get

    return wrap


@device_cache(maxsize=64)
def _table(data: bytes, dtype: str, shape: tuple, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).reshape(shape).copy()).to(device)


def device_table(a, dtype, device) -> torch.Tensor:
    """The host array ``a`` as a ``dtype`` (numpy) tensor on ``device``: on
    the card copied once per value (:func:`device_cache`), so an iteration
    that needs it makes no copy from host memory; on the CPU a new tensor."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if torch.device(device).type == "cpu":
        return torch.from_numpy(a.copy())
    return _table(a.tobytes(), a.dtype.str, a.shape, str(device))


def launch_counters() -> list:
    """The kernel wrappers, each with its ``launches`` count."""
    from .ops import cuda_estep, cuda_permute, cuda_ridge, cuda_rotate

    return list(dict.fromkeys(  # once each, where a module imports another's
        f for m in (cuda_estep, cuda_permute, cuda_ridge, cuda_rotate)
        for f in vars(m).values()
        if callable(f) and isinstance(getattr(f, "launches", None), int)))


def count(fn, n: int = 1) -> None:
    """Count ``n`` launches of the kernel wrapper ``fn``; called where the
    wrapper issues them. Outside a capture they are added to
    ``fn.launches``; while an iteration is captured the launches run at
    each replay that runs the body, not now, so the add is captured into
    the same stream, on the graph's device counter of ``fn``."""
    if _capturing is None:
        fn.launches += n
    else:
        i = _capturing.slot[fn]
        _capturing.counts[i:i + 1].add_(n)


def rng_offset(gen: torch.Generator) -> int:
    """The Philox offset of a CUDA generator (its state is the seed, then
    the offset, 8 bytes each)."""
    return int(gen.get_state().numpy()[8:16].view(np.int64)[0])


def set_rng_offset(gen: torch.Generator, offset: int) -> None:
    state = gen.get_state().clone()
    state[8:16] = torch.from_numpy(np.array([offset], np.int64).view(np.uint8))
    gen.set_state(state)


def guarded(flag: torch.Tensor, body: Callable[[], None]) -> None:
    """Run ``body()`` where ``flag`` (one int32, on the device of the
    tensors the body reads) is nonzero: the counterpart of ``lax.cond``
    with an identity branch. While an iteration is captured on the card the
    body's launches are captured as a guarded region of the graph, which a
    replay runs only where the flag, as the launches before the region left
    it, is nonzero; elsewhere a Python ``if`` on one read of the flag. The
    body writes what it computes into tensors that exist before the region
    (a skipped region leaves them as they were), and no tensor it makes is
    read after it. Regions do not nest."""
    if _capturing is not None and flag.device.type == "cuda":
        _capturing.region(flag, body)
    elif bool(flag):
        body()


_PTRS = [_build.PTR] * 3
_SIGNATURES = {"graph_mark": [_build.PTR, _build.PTR],
               "graph_wrap_regions": [_build.PTR, _build.PTR, _build.INT] + _PTRS,
               "graph_stamp": [_build.PTR, _build.PTR, _build.I64, _build.I64, _build.PTR],
               "graph_runtime_version": []}


def stamp(buf: torch.Tensor, offset: int, index: Optional[torch.Tensor] = None,
          stride: int = 0) -> None:
    """Write the card's global timer (nanoseconds, ``%globaltimer``) into
    ``buf[offset + stride * index[0]]`` (``buf`` int64 on the card;
    ``index`` an int64 on the card, read when the stamp runs, or None for
    ``buf[offset]``), on the current stream: a one-thread launch, which a
    capture records as a node of the graph."""
    lib = _build.load("graph", _SIGNATURES)
    # the raw handle: a span takes two stamps, and a Stream object costs
    # more host time than the launch
    stream = torch._C._cuda_getCurrentRawStream(buf.device.index)
    _build.check(lib.graph_stamp(buf.data_ptr(), None if index is None else index.data_ptr(),
                                 stride, offset, stream), "graph_stamp")
# graph_wrap_regions' code for markers that are not start/end pairs in order
_BAD_MARKERS = -1


class IterationGraph:
    """One iteration, ``body()``, captured into a CUDA graph of IF nodes: a
    replay runs the body exactly when ``ctl`` (3 int64 on the card:
    iterations run, budget, convergence flag) says the loop goes on, each
    guarded region of it (:func:`guarded`) only where its flag also allows,
    and launches nothing else but the nodes' one-thread predicate kernels
    otherwise (``csrc/graph.cu``). The body advances ``ctl`` itself.
    ``generator`` is registered with the graph, so each replay draws from
    the generator's offset at that replay. :attr:`counts` (int64 on the
    card, one a kernel wrapper) counts the launches the replays ran
    (:func:`count`). ``max_regions`` bounds the guarded regions the body
    opens: their marker words are made before the capture, outside the
    graph's memory pool, so no other memset the capture holds can name one.
    A failed capture or rewrite raises."""

    def __init__(self, body: Callable[[], None], ctl: torch.Tensor,
                 generator: torch.Generator, max_regions: int = 0):
        global _capturing
        lib = _build.load("graph", _SIGNATURES)
        version = lib.graph_runtime_version()
        if version < 12040:
            raise RuntimeError(f"run_rounds needs conditional graph nodes: CUDA 12.4 or later, "
                               f"the runtime is {version}")
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.register_generator_state(generator)
        self.tables: List[torch.Tensor] = []
        # each wrapper's launches in the replays since the counters were
        # zeroed: incremented by the body's captured adds (count)
        self.counters = launch_counters()
        self.slot: Dict[Callable, int] = {f: i for i, f in enumerate(self.counters)}
        self.counts = torch.zeros(len(self.counters), dtype=torch.int64, device=ctl.device)
        # each guarded region's (start word, end word, flag), in capture order
        self.regions: List[tuple] = []
        self.words = torch.empty(2 * max(max_regions, 1), dtype=torch.int32, device=ctl.device)
        self._open = False
        self._lib = lib
        _capturing = self
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                body()
        finally:
            _capturing = None
        arrays = [(ctypes.c_void_p * max(len(self.regions), 1))(
            *[r[i].data_ptr() for r in self.regions]) for i in range(3)]
        err = lib.graph_wrap_regions(self.graph.raw_cuda_graph(), ctl.data_ptr(),
                                     len(self.regions), *arrays)
        if err == _BAD_MARKERS:
            raise RuntimeError(f"graph_wrap_regions: the captured graph does not hold the "
                               f"{len(self.regions)} regions' markers in order")
        _build.check(err, "graph_wrap_regions")
        self.graph.instantiate()
        self.capture_s = time.perf_counter() - t0

    def region(self, flag: torch.Tensor, body: Callable[[], None]) -> None:
        """Capture ``body()`` as a guarded region on ``flag``: between two
        markers (``graph_mark``, a memset of a magic byte) on words of the
        region's own, which the rewrite finds by address and value and
        removes. The graph keeps the flag."""
        if self._open:
            raise RuntimeError("guarded regions do not nest")
        if flag.dtype != torch.int32 or flag.numel() != 1:
            raise TypeError(f"a region's flag is one int32, got {flag.dtype} {tuple(flag.shape)}")
        r = len(self.regions)
        if 2 * r + 2 > self.words.numel():
            raise RuntimeError(f"the iteration opens more than its {self.words.numel() // 2} "
                               "guarded regions")
        words = self.words[2 * r:2 * r + 2]
        self.regions.append((words[0:1], words[1:2], flag))
        stream = torch.cuda.current_stream(flag.device).cuda_stream
        self._open = True
        try:
            _build.check(self._lib.graph_mark(words[0:1].data_ptr(), stream), "graph_mark")
            body()
            _build.check(self._lib.graph_mark(words[1:2].data_ptr(), stream), "graph_mark")
        finally:
            self._open = False

    def replay(self, n: int) -> None:
        """``n`` replays back to back, one graph launch each."""
        for _ in range(n):
            self.graph.replay()

    def add_counts(self, values: List[int]) -> None:
        """Add ``values``, the device counters as read after the replays
        (``counts.tolist()``, read with the run's one read), to the
        wrappers' ``launches``; :attr:`counts` is zeroed before the next
        replays."""
        for f, n in zip(self.counters, values):
            f.launches += n
