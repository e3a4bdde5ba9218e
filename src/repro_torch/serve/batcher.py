"""Batched query execution — many requests, one serving function (mirrors
:mod:`repro.serve.batcher`).

The :class:`MicroBatcher` accumulates point-labelling requests into
fixed-size padded batches: every flush calls the serving function with
exactly ``[batch_size, d]`` rows on the serving device.

The padded-batch contract:

* pad rows are zero rows appended after the real queries;
* the serving function is row-independent, so the real rows' outputs do not
  depend on the pad rows;
* pad-row outputs are sliced off before futures resolve.

A batch goes out when it is full or when its oldest request has waited
``max_wait_s``, whichever comes first.  An exception in the serving function
fails the futures of that flush only; the flush thread keeps serving.

Per flush the worker thread fills a pinned host buffer, makes one
host → device copy, calls ``fn``, and brings every output leaf back in one
device → host copy (the leaves packed as bytes on the device first); the
copy back waits for the device, so a future is set only after its flush
has finished.  Futures resolve to numpy arrays in ``fn``'s output
structure (a tensor, or a dict, tuple, list or named tuple of them).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Flush policy: ``batch_size`` is the static row count of every call
    (pick it for the device, not the traffic); ``max_wait_s`` bounds the
    queueing delay of the first request of a batch (p99 against fill)."""

    batch_size: int = 64
    max_wait_s: float = 0.01

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"BatchConfig.batch_size must be >= 1, got {self.batch_size}")
        if self.max_wait_s <= 0:
            raise ValueError(f"BatchConfig.max_wait_s must be > 0, got {self.max_wait_s}")


@dataclasses.dataclass
class BatcherStats:
    """Flush accounting (read after a trace for fill/padding ratios)."""

    batches: int = 0
    rows: int = 0  # real query rows served
    pad_rows: int = 0  # zero rows added to fill batches
    full_flushes: int = 0  # batch went out because it filled
    timed_flushes: int = 0  # batch went out on the max-wait deadline
    failed_batches: int = 0  # serving-fn exceptions (futures got the error)
    split_requests: int = 0  # oversized requests split across flushes

    @property
    def fill(self) -> float:
        total = self.rows + self.pad_rows
        return self.rows / total if total else 0.0


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees of dicts, tuples
    (named or not) and lists."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _to_host(out):
    """``out``'s leaves as numpy arrays: CUDA tensors packed as bytes on the
    device and copied back in one transfer, which waits for the device."""
    cuda = []
    _tree_map(lambda a: cuda.append(a) if isinstance(a, torch.Tensor) and a.is_cuda else None,
              out)
    host = iter(())
    if cuda:
        packed = torch.cat([a.detach().contiguous().reshape(-1).view(torch.uint8)
                            for a in cuda]).cpu().numpy()
        parts, off = [], 0
        for a in cuda:
            nbytes = a.numel() * a.element_size()
            dtype = torch.empty(0, dtype=a.dtype).numpy().dtype
            parts.append(packed[off:off + nbytes].view(dtype).reshape(tuple(a.shape)))
            off += nbytes
        host = iter(parts)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return next(host) if a.is_cuda else a.detach().numpy()
        return np.asarray(a)

    return _tree_map(leaf, out)


class _Pending:
    __slots__ = ("rows", "future", "t0")

    def __init__(self, rows: np.ndarray, future: Future, t0: float):
        self.rows = rows
        self.future = future
        self.t0 = t0


class MicroBatcher:
    """Accumulate point-labelling requests into fixed-size padded batches.

    ``fn(batch: [batch_size, d] float32 tensor on the serving device) ->
    tree of tensors`` is the serving function; every leaf of its output has
    leading dimension ``batch_size``.  Typically
    ``functools.partial(serve_fn, index)`` over a
    :class:`~repro_torch.serve.oos.ServingIndex`; :meth:`set_fn` swaps it
    (takes effect on the next flush).  ``device`` is the serving device:
    the card unless the caller asks for the CPU.

    :meth:`submit` may be called from any number of threads; one background
    thread owns flushing.  Use as a context manager (or call :meth:`close`).
    """

    def __init__(self, fn: Callable[[torch.Tensor], Any], feature_dim: int,
                 config: BatchConfig = BatchConfig(), *, device: DeviceLike = None):
        self._fn = fn
        self.d = feature_dim
        self.config = config
        self.device = resolve_device(device)
        self.stats = BatcherStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        self._queued_rows = 0
        self._closed = False
        # the flush buffer: pinned for the copy to the card; the event marks
        # the last copy out of it, which must end before the buffer is refilled
        shape = (config.batch_size, feature_dim)
        self._host = torch.zeros(shape, dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")
        self._copied = torch.cuda.Event() if self.device.type == "cuda" else None
        self._thread = threading.Thread(target=self._loop, name="micro-batcher", daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def submit(self, points) -> Future:
        """Enqueue one request ([m, d] or a single [d] point); resolves to the
        serving output rows for exactly those m points.  A request larger
        than ``batch_size`` is split into consecutive chunks (every flush is
        still ``[batch_size, d]``) and reassembled before the future
        resolves; if any chunk's flush fails, this request's future gets
        that error."""
        rows = np.asarray(points.detach().cpu() if isinstance(points, torch.Tensor) else points,
                          np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(
                f"request shape {rows.shape} does not match feature_dim="
                f"{self.d} (expected [m, {self.d}])")
        if rows.shape[0] > self.config.batch_size:
            return self._submit_split(rows)
        return self._enqueue(rows)

    def _enqueue(self, rows: np.ndarray) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(_Pending(rows, fut, time.monotonic()))
            self._queued_rows += rows.shape[0]
            self._cond.notify_all()
        return fut

    def _submit_split(self, rows: np.ndarray) -> Future:
        """Split an oversized request into batch-size chunks, enqueue them in
        order, and resolve one parent future with the per-leaf concatenation
        of the chunk results.  The first chunk error wins."""
        bs = self.config.batch_size
        chunks = [rows[off:off + bs] for off in range(0, rows.shape[0], bs)]
        parent: Future = Future()
        parts: List[Any] = [None] * len(chunks)
        state = {"left": len(chunks), "failed": False}
        lock = threading.Lock()

        def on_done(i: int):
            def cb(fut: Future) -> None:
                err = fut.exception()
                with lock:
                    if state["failed"]:
                        return
                    if err is not None:
                        state["failed"] = True
                        parent.set_exception(err)
                        return
                    parts[i] = fut.result()
                    state["left"] -= 1
                    done = state["left"] == 0
                if done:
                    parent.set_result(_tree_map(lambda *xs: np.concatenate(xs, axis=0), *parts))
            return cb

        with self._lock:
            self.stats.split_requests += 1
        futs = [self._enqueue(c) for c in chunks]
        for i, f in enumerate(futs):
            f.add_done_callback(on_done(i))
        return parent

    def label(self, points, timeout: Optional[float] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(points).result(timeout=timeout)

    def set_fn(self, fn: Callable[[torch.Tensor], Any]) -> None:
        """Swap the serving function (queued and later requests use it from
        the next flush on)."""
        with self._cond:
            self._fn = fn

    def close(self) -> None:
        """Stop accepting requests, flush what is queued, join the thread."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- flush side ---------------------------------------------------------

    def _take_batch_locked(self) -> Tuple[List[_Pending], int, bool]:
        """Pop whole requests up to batch_size rows (a request never spans
        two batches, so its outputs slice out contiguously)."""
        took: List[_Pending] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if rows + nxt.rows.shape[0] > self.config.batch_size:
                break
            took.append(self._queue.pop(0))
            rows += nxt.rows.shape[0]
        self._queued_rows -= rows
        return took, rows, rows == self.config.batch_size

    def _loop(self) -> None:
        cfg = self.config
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                # wait for fill or the oldest request's deadline
                deadline = self._queue[0].t0 + cfg.max_wait_s
                while self._queued_rows < cfg.batch_size and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                took, rows, full = self._take_batch_locked()
                fn = self._fn
            if took:
                self._flush(fn, took, rows, full)

    def _batch(self, took: List[_Pending]) -> Tuple[torch.Tensor, list]:
        """The padded batch on the serving device, and each request's
        (offset, rows)."""
        if self._copied is not None:
            self._copied.synchronize()  # the last copy out of the buffer is done
        host = self._host.numpy()
        host.fill(0.0)
        offsets, off = [], 0
        for p in took:
            m = p.rows.shape[0]
            host[off:off + m] = p.rows
            offsets.append((off, m))
            off += m
        if self._copied is None:
            return self._host.clone(), offsets
        batch = self._host.to(self.device, non_blocking=True)
        self._copied.record()
        return batch, offsets

    def _flush(self, fn, took: List[_Pending], rows: int, full: bool) -> None:
        cfg = self.config
        try:
            batch, offsets = self._batch(took)
            out = _to_host(fn(batch))  # one copy back per flush, after the device is done
        except Exception as e:  # isolation: this flush fails, the thread lives
            self.stats.failed_batches += 1
            for p in took:
                p.future.set_exception(e)
            return
        self.stats.batches += 1
        self.stats.rows += rows
        self.stats.pad_rows += cfg.batch_size - rows
        if full:
            self.stats.full_flushes += 1
        else:
            self.stats.timed_flushes += 1
        for p, (o, m) in zip(took, offsets):
            p.future.set_result(_tree_map(lambda a: a[o:o + m], out))
