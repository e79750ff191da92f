"""Runtime pieces around the engine: device choice, phase timers and
profiler spans, divergence, cooperative abort, tracing and streamed ingest.

Counterpart of ``harmony_tpu/runtime.py``. Timers synchronise with the card
at the end of each scope, so a scope's wall time is the work it enqueued,
not its dispatch; each scope is also a ``torch.profiler.record_function``
span, so a :func:`trace` shows the engine's phases (``cluster``,
``correct``, ``materialize_r``) by name. ``enable_compilation_cache`` has
no counterpart: the port compiles no programs at run time, and its kernels
are built once per source into ``build/kernels/`` (``_build.py``), which
plays the part of a persistent cache.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

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


def span(name: str):
    """A named profiler span (``torch.profiler.record_function``): free when
    no profiler runs, a range of the trace when one does."""
    return torch.profiler.record_function(name)


class PhaseTimers:
    """Named wall-clock accumulators (the reference's ``timers`` map,
    src/timer.h:20). ``device`` is synchronised at each scope's end."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            yield
            synchronize(self.device)
        dt = time.perf_counter() - t0
        self._acc[name] = self._acc.get(name, 0.0) + dt
        self._count[name] = self._count.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(
            f"{name:>24s}: {self._acc[name] * 1e3:10.2f} ms over {self._count[name]} calls"
            for name in sorted(self._acc)
        )

    def as_dict(self) -> Dict[str, float]:
        return dict(self._acc)


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
