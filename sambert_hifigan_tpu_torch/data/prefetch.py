"""Background batch prefetch: overlap host batch assembly and the copy to
the device with the device's compute.

`Prefetcher` moves `next(batches)` (numpy collation, random crops) and the
copy to the device onto one background thread with a bounded queue:

    batches = Prefetcher(batches, transfer=lambda b: batch_to_device(b, dev))
    for step in range(n):
        batch = next(batches)          # already on the device
        metrics = step_fn(state, batch, rng)

* `transfer` (optional) runs in the worker thread.  On the card it pins the
  host arrays and copies them with `non_blocking=True` (`dataset.
  batch_to_device`): a copy from pageable memory would be synchronous, so
  the worker would wait for the device and the host work would stop
  overlapping.  The copy is issued on the worker thread's current stream,
  which is the device's default stream, the one the step's kernels run on:
  the step enqueued after `next()` returns runs after the copy has landed,
  with no explicit synchronisation.  The pinned host buffer is held by
  PyTorch's host allocator until the copy has finished.
* In a process group the trainers' `transfer` first keeps the rank's rows
  of the global batch (`parallel.mesh.shard_batch`), then pins and
  copies only those.
* The queue is bounded (default depth 2): prefetch stays one or two
  batches ahead and never grows host memory.
* Exceptions of the source iterator or of `transfer` surface at the
  consumer's `next()`, with the original chained.
* `close()` (or `with` exit) stops the worker promptly, even on a full
  queue.

One thread is deliberate: batch order is part of the training contract
(seeded shuffles, resume determinism), and one producer keeps it.
`want_prefetch('auto')` turns the thread on only where the process has two
or more cores, where the worker can run beside the loop.
"""

from __future__ import annotations

import argparse
import os
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

_DONE = object()


def add_prefetch_flags(p: argparse.ArgumentParser) -> None:
    """The trainers' --prefetch {auto,on,off} and its alias --no-prefetch."""
    p.add_argument("--prefetch", choices=["auto", "on", "off"], default="auto",
                   help="collate the next batches and copy them to the device on a "
                        "background thread; 'auto' (default) does so only where this "
                        "process has two or more cores")
    p.add_argument("--no-prefetch", dest="prefetch", action="store_const", const="off",
                   help="alias for --prefetch off")


def want_prefetch(mode: str) -> bool:
    """Resolve a --prefetch {auto,on,off} flag: 'auto' enables the worker
    thread only when this process may use more than one core (on one core
    it only contends with the training loop for it)."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    return _available_cpus() > 1


def _available_cpus() -> int:
    """Cores available to this process: affinity-aware, since a container
    pinned to one CPU of a large host is the one-core case 'auto' avoids
    (os.cpu_count reports the machine, not the quota)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # not Linux
        return os.cpu_count() or 1


class _Failure:
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Iterator wrapper: pulls from `source` on a background thread, applies
    `transfer`, and serves the results from a bounded queue."""

    def __init__(self, source: Iterable[Any], depth: int = 2,
                 transfer: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._transfer = transfer
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._worker = threading.Thread(target=self._run, name="batch-prefetch", daemon=True)
        self._worker.start()

    # ---- worker ---------------------------------------------------------------

    def _put(self, item: Any) -> bool:
        """Bounded put that gives up when close() is requested."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transfer is not None:
                    item = self._transfer(item)
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            self._put(_Failure(e))
            return
        self._put(_DONE)

    # ---- consumer -------------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._exhausted:
            raise StopIteration
        item = self._queue.get()
        if item is _DONE:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._exhausted = True
            raise RuntimeError("batch prefetch worker failed") from item.error
        return item

    def close(self) -> None:
        """Stop the worker and drop queued batches.  Idempotent."""
        self._stop.set()
        while True:  # unblock a worker stuck on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._worker.join(timeout=5.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best effort; the daemon thread dies with the process anyway
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
