"""Runtime pieces around the engine: device choice, phase timers and
profiler spans, divergence, cooperative abort, tracing and streamed ingest.

Counterpart of ``harmony_tpu/runtime.py``. Every span of the program is a
``torch.profiler.record_function`` range (:func:`span`), so a
:func:`trace` shows the engine's phases by name. Under an active
:class:`PhaseTimers` a span is also timed: its host wall, and on the card
its length on the device's clock, from two stamps of the global timer on
the stream; a scope (``sync=True``) synchronises with the card at its
end, so its wall time is the work it enqueued, not its dispatch.
``enable_compilation_cache`` has no counterpart: the port compiles no programs at run time, and its kernels
are built once per source into ``build/kernels/`` (``_build.py``), which
plays the part of a persistent cache.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, raise instead of falling back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


# the PhaseTimers that spans record into, set by PhaseTimers.active
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("phase_timers", default=None)


def span(name: str, sync: bool = False):
    """A named span of the program. With no active :class:`PhaseTimers`
    it is a ``torch.profiler.record_function`` range and nothing else:
    free when no profiler runs, a range of the trace when one does. Under
    an active one (:meth:`PhaseTimers.active`) it is also timed
    (:meth:`PhaseTimers.span`); ``sync`` then closes its host wall with a
    synchronise (:meth:`PhaseTimers.scope`)."""
    timers = _ACTIVE.get()
    if timers is None:
        return torch.profiler.record_function(name)
    return timers.span(name, sync)


def active_timers() -> Optional["PhaseTimers"]:
    """The PhaseTimers that spans record into, if any."""
    return _ACTIVE.get()


def timing(timers: Optional["PhaseTimers"]):
    """``timers`` made the active PhaseTimers for the block (None: the
    active one, if any, stays)."""
    return contextlib.nullcontext() if timers is None else timers.active()


class Phase(NamedTuple):
    """A name's totals: its calls, host seconds and device seconds (None
    where nothing was timed on that clock)."""

    calls: int
    host_s: Optional[float]
    device_s: Optional[float]


def _add(acc: Dict[str, float], name: str, value: Optional[float]) -> None:
    if value is not None:
        acc[name] = acc.get(name, 0.0) + value


class PhaseTimers:
    """Named accumulators of calls, host seconds and device seconds (the
    reference's ``timers`` map, src/timer.h:20), fed by the spans opened
    while the timers are active (:meth:`active`; ``driver.run``,
    ``driver.harmonize``, ``state.init_state`` and ``api.run_harmony``
    make the timers they are given active while they run).

    On a CUDA ``device`` each span stamps the current stream's timeline at
    its start and end (``graphs.stamp``: a one-thread kernel writing the
    card's global timer into a slot of a buffer of the timers'); the
    stamps are read with one device-to-host read when the outermost
    activation ends, and a span's device seconds are the difference of its
    two. The captured iteration of ``engine.run_rounds`` stamps itself
    (its ``cluster`` and ``correct``), read with the run's one read.
    :meth:`totals` sums every instance since :meth:`reset_totals`."""

    # every instance's calls, host seconds and device seconds per name
    _all_count: Dict[str, int] = {}
    _all_acc: Dict[str, float] = {}
    _all_dev: Dict[str, float] = {}

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._dev: Dict[str, float] = {}
        self._depth = 0  # activations open
        self._buf: Optional[torch.Tensor] = None  # the stamps, int64 on the card
        self._used = 0  # slots of _buf written since the last read
        self._pending = []  # (name, start slot, end slot) not read yet

    @contextlib.contextmanager
    def active(self):
        """The spans opened in the block record into these timers. Where
        this is the outermost activation of the timers, its end reads the
        stamps taken (one read, after the work; none where none were)."""
        token = _ACTIVE.set(self)
        self._depth += 1
        done = False
        try:
            yield self
            done = True
        finally:
            self._depth -= 1
            _ACTIVE.reset(token)
            if self._depth == 0:
                if done:
                    self._read_stamps()
                self._pending.clear()
                self._used = 0

    def _capturing(self) -> bool:
        """Is a CUDA graph being captured on the card's current stream (a
        stamp would be captured into the graph)?"""
        return (self.device is not None and self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing())

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """The span ``name``, timed: a ``record_function`` range, its host
        wall (closed by a synchronise where ``sync``) and on the card its
        device stamps. While a CUDA graph is captured it is the range
        alone: the capture runs nothing."""
        # (under runtime.span the timers are active already)
        activate = contextlib.nullcontext() if _ACTIVE.get() is self else self.active()
        with torch.profiler.record_function(name), activate:
            if self._capturing():
                yield
                return
            t0 = time.perf_counter()
            a = self._stamp()
            yield
            b = self._stamp()
            if sync:
                synchronize(self.device)
            self.add(name, host_s=time.perf_counter() - t0)
            if a is not None:
                self._pending.append((name, a, b))

    def scope(self, name: str):
        """A span whose host wall is closed by a synchronise with the card,
        so it times the work the scope enqueued, not its dispatch."""
        return self.span(name, sync=True)

    def _stamp(self) -> Optional[int]:
        if self.device is None or self.device.type != "cuda":
            return None
        from . import graphs

        if self._buf is None or self._used == self._buf.numel():
            grown = torch.empty(max(64, 2 * self._used), dtype=torch.int64, device=self.device)
            if self._used:
                grown[: self._used].copy_(self._buf[: self._used])
            self._buf = grown
        graphs.stamp(self._buf, self._used)
        self._used += 1
        return self._used - 1

    def _read_stamps(self) -> None:
        if not self._pending:
            return
        ts = self._buf[: self._used].tolist()
        for name, a, b in self._pending:
            self.add(name, calls=0, device_s=(ts[b] - ts[a]) * 1e-9)

    def add(self, name: str, calls: int = 1, host_s: Optional[float] = None,
            device_s: Optional[float] = None) -> None:
        """Add ``calls`` calls of ``name`` and their seconds on either clock
        to these timers and to :meth:`totals`."""
        for count, acc, dev in ((self._count, self._acc, self._dev),
                                (self._all_count, self._all_acc, self._all_dev)):
            count[name] = count.get(name, 0) + calls
            _add(acc, name, host_s)
            _add(dev, name, device_s)

    def report(self) -> str:
        def line(name):
            host = (f"{self._acc[name] * 1e3:10.2f} ms" if name in self._acc
                    else f"{'-':>10s}   ")
            dev = (f", {self._dev[name] * 1e3:.2f} ms on the device" if name in self._dev
                   else "")
            return f"{name:>24s}: {host} over {self._count[name]} calls{dev}"

        return "\n".join(line(name) for name in sorted(self._count))

    def as_dict(self) -> Dict[str, float]:
        """Host seconds per name (the names timed on the host)."""
        return dict(self._acc)

    def counts(self) -> Dict[str, int]:
        """Calls per name."""
        return dict(self._count)

    def device_dict(self) -> Dict[str, float]:
        """Device seconds per name (the names stamped on the card)."""
        return dict(self._dev)

    @classmethod
    def totals(cls) -> Dict[str, Phase]:
        """Every instance's calls and seconds per name since the last
        :meth:`reset_totals` (or the process's start)."""
        return {k: Phase(n, cls._all_acc.get(k), cls._all_dev.get(k))
                for k, n in cls._all_count.items()}

    @classmethod
    def reset_totals(cls) -> None:
        for d in (cls._all_count, cls._all_acc, cls._all_dev):
            d.clear()


class DivergenceError(RuntimeError):
    """The objective trace went non-finite (NaN/Inf) mid-run. Index 0 is the
    initial clustering's objective; index i >= 1 the objective after round i.
    With checkpointing on, the last good checkpoint on disk is the recovery
    point: the driver checks before it writes."""

    def __init__(self, round_idx: int, values):
        self.round_idx = round_idx
        self.values = values
        advice = ("check input scaling (embeddings should be PCA-scaled), "
                  "sigma > 0, and lambda >= 0")
        if round_idx == 0:
            where = (
                "at initialization (the objective of the initial "
                "clustering, before any harmony round — the input itself "
                "is likely non-finite or badly scaled)"
            )
        else:
            where = f"at round {round_idx}"
            advice += "; resume from the last checkpoint after fixing inputs"
        super().__init__(
            f"harmony objective became non-finite {where} "
            f"(objective trace tail: {values}); the run has diverged — {advice}"
        )


class AbortFlag:
    """Cooperative abort (the analog of ``Progress::check_abort``,
    src/harmony.cpp:233-234): the driver polls it between rounds, since
    device work is not interruptible mid-round. ``set`` may be called from
    any thread."""

    def __init__(self):
        self._event = threading.Event()

    def set(self):
        self._event.set()

    def aborted(self) -> bool:
        return self._event.is_set()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block with ``torch.profiler`` over the CPU and,
    where there is one, the card, and write a Chrome trace into ``log_dir``
    (``<host>_<pid>.<ms>.pt.trace.json``, TensorBoard's layout). No-op when
    ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield


def engine_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in the engine dtype: float64 rounds to float32 first, then to a
    narrower dtype once (as ``jnp.asarray`` does without 64-bit mode), on
    whichever device ``t`` lies, so a cast on the host and one on the card
    give the same bits."""
    if t.dtype == torch.float64 and dtype.itemsize < 4:
        t = t.to(torch.float32)
    return t.to(dtype)


class AsyncIngest:
    """Streamed host-to-device copy of the (d, N) cell embedding.

    Counterpart of ``harmony_tpu/runtime.py:163-304``. A background thread
    casts each column chunk of ``chunk_bytes`` (in the engine dtype) on the
    host into one of two pinned buffers and copies it on a side CUDA stream
    into a (d, cfg.Np) tensor on ``device``, so the caller builds the config,
    the ingest layout and the hyperparameters meanwhile. A bf16 run moves
    half the bytes of a float32 upload, a quarter of a float64 one. The pad
    cells (``cfg.Np - N``) are zero. :meth:`order` gives the ingest order;
    :meth:`result` joins the thread, makes the current stream wait for the
    side stream, and applies the order on the device with one gather whose
    pad columns map to themselves. An exception on the thread is raised by
    :meth:`join` and :meth:`result`. Used as a context manager it joins on
    the way out, so no copy outlives its tensor when the caller's set-up
    raises. On a CPU device the same steps run as plain copies.

    On a ``mesh`` (a ``sharding.CellMesh``) each rank copies only its own
    columns of the padded axis in ingest order, ``(d, Np / size)``, so its
    copy starts at :meth:`order` (every rank gives the same order; a join
    before it copies the input order): each chunk of ``chunk_bytes`` is
    gathered from the rank's input cells on the host into the pinned
    buffers, and :meth:`result` applies no order. ``overlap=False``
    finishes each copy where it starts (at construction on one device, at
    :meth:`order` on a mesh).
    """

    def __init__(self, Z: np.ndarray, cfg, device, chunk_bytes: int = 64 << 20, mesh=None,
                 overlap: bool = True):
        if Z.ndim != 2 or Z.shape[1] != cfg.N:
            raise ValueError(f"Z must be (d, {cfg.N}), got {Z.shape}")
        self._Z = Z
        self._cfg, self._mesh, self._overlap = cfg, mesh, overlap
        self._N, self._Np = cfg.N, cfg.Np
        if mesh is not None:
            from .sharding import cell_range

            lo, hi = cell_range(cfg, mesh)
            self._N, self._Np = min(hi, cfg.N) - lo, hi - lo
        # the input cells of the output's columns, in order (None: 0..N-1)
        self._src = None
        self._perm = None
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        d = Z.shape[0]
        self.cols = max(1, chunk_bytes // max(1, d * self.dtype.itemsize))
        self._out = torch.empty((d, self._Np), dtype=self.dtype, device=self.device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._exc: Optional[BaseException] = None
        self._joined = False
        self._thread = None
        self._ordered = False
        if mesh is None:
            self._start()

    def _start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._overlap:
            self.join()

    def order(self, perm: Optional[np.ndarray]) -> None:
        """The ingest order: column j < N of the result holds input cell
        ``perm[j]`` (None: the input order). On a mesh the rank's copy of
        its columns of it starts now. Call it once, before :meth:`result`."""
        if self._ordered:
            raise ValueError("the ingest order was given already")
        self._ordered = True
        if self._mesh is None:
            self._perm = perm
            return
        from .sharding import cell_range

        lo = cell_range(self._cfg, self._mesh)[0]
        src = np.arange(self._cfg.N) if perm is None else np.asarray(perm)
        self._src = src[lo:lo + self._N]
        self._start()

    @property
    def n_chunks(self) -> int:
        return -(-self._N // self.cols)

    def __enter__(self) -> "AsyncIngest":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.join()
        except BaseException:
            if exc_type is None:
                raise  # else the caller's own exception goes on

    def _run(self):
        try:
            if self._cuda:
                # the tensor was made on the caller's stream and is written
                # on this one: its memory is not reused before these copies
                self._out.record_stream(self._stream)
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    self._copy()
            else:
                self._copy()
        except BaseException as e:  # raised again on the caller's thread
            self._exc = e

    def _copy(self):
        d, w = self._Z.shape[0], min(self.cols, self._N)
        pin = self._cuda
        bufs = [torch.empty((d, w), dtype=self.dtype, pin_memory=pin) for _ in range(2)]
        done = [None, None]
        for i, a in enumerate(range(0, self._N, self.cols)):
            b = min(a + self.cols, self._N)
            buf = bufs[i % 2][:, : b - a]
            if done[i % 2] is not None:
                done[i % 2].synchronize()  # the copy out of this buffer has landed
            cols = self._Z[:, a:b] if self._src is None else self._Z[:, self._src[a:b]]
            buf.copy_(engine_cast(torch.from_numpy(cols), self.dtype))
            self._out[:, a:b].copy_(buf, non_blocking=pin)
            if pin:
                done[i % 2] = torch.cuda.Event()
                done[i % 2].record(self._stream)
        if self._Np > self._N:
            self._out[:, self._N:].zero_()

    def join(self) -> None:
        """Wait for the copies; the current stream then waits for the side
        stream, also after an exception on the thread."""
        if self._thread is None:
            self.order(None)  # a mesh copy without an order: the input order
        if not self._joined:
            self._thread.join()
            self._joined = True
            if self._cuda:
                torch.cuda.current_stream(self.device).wait_stream(self._stream)
        if self._exc is not None:
            raise self._exc

    def result(self, perm: Optional[np.ndarray] = None) -> torch.Tensor:
        """The (d, Np) tensor on the device (on a mesh the rank's columns),
        in ingest order; ``perm``, where given, is :meth:`order`'s. Call it
        once: the object lets go of its tensor."""
        if perm is not None:
            self.order(perm)
        self.join()
        out, self._out = self._out, None
        if self._perm is None:
            return out
        idx = np.arange(self._Np, dtype=np.int64)
        idx[: self._N] = self._perm
        return out.index_select(1, torch.as_tensor(idx, device=self.device))
