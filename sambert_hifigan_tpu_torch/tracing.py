"""Spans and counters inside the serving path, on the device trace's clock.

Tracing is on while `torch.profiler` runs (its flag is visible from every
thread, the batcher's worker included, whose host work the profiler itself
does not record) or after `enable(True)` (an operator's switch: `serve.py
--trace`).  While it is off every entry point returns at once: no clock
read, no record, no CUDA event.

* `span(name, req=None, start_ns=None)`: a context manager recording name,
  start, end, thread, request id and parent (the innermost open span of the
  same thread, whose request id a span without one takes over).  Times are
  `time.time_ns()`, the clock of `torch.profiler`'s events:
  `prof.events()` times are `(t_ns - trace_start_ns) / 1000` microseconds.
* `device_span(name, device=None)`: a span that also brackets the work it
  enqueues with a pair of CUDA events; the device time is read once the
  end event has completed (a synchronisation the path already makes), and
  never with a sync of its own.  On the CPU the device time is the host
  interval.
* `handoff()` / `leg(h, name)`: a span across threads.  The submitting
  thread stamps a request (`handoff`: a new request id, its open span, the
  time); the thread that takes it over records the leg from that stamp to
  now (`leg`) and may open spans under the same id.
* `count(name, n=1)`: a counter.
* `snapshot()`: per span name `n`, `total_ms`, `mean_ms` and the self time
  (the duration less what its child spans cover) since the last reset, and
  `p50_ms`, `p95_ms` (nearest rank) over its last `WINDOW` spans, under
  "spans"; the same of the device spans' device times under "device"; the
  counters under "counters".  The aggregates are kept as spans close, so a
  snapshot costs a partition of each window (well under a millisecond for
  a dozen names), however many spans there were: `DynamicBatcher.stats()`
  may be polled under load.
  `spans()` gives the raw records, the last `RING` of them; `reset()`
  clears records, aggregates and counters.

The names recorded (DynamicBatcher, TTSPipeline.stream, synthesize_batch,
VitsPipeline.synthesize_batch):

  batcher.queue_wait   a request's put to the worker's pop
  batcher.round        one pass of the worker's loop that had work
  stream.first_chunk   a stream's pop to its first chunk in the client's queue
  stream.chunk         each later chunk (the worker's advance to the put)
  stream.frontend      the stream's front end (host)
  stream.encode        encoder, variance adaptor and memory K/V (host, device)
  stream.decode        each K1 chunk (host, device)
  stream.vocode        each vocoded window (host, device)
  stream.fetch         the host's wait in a chunk's copy
  batch.call           one synthesize_batch
  batch.frontend       its front end and padding (host)
  batch.dispatch       its enqueue of every replica's acoustic pass and vocode
  batch.acoustic       each replica's acoustic pass (host, device)
  batch.vocode         each replica's vocode (host, device)
  batch.fetch          the host's wait in the wav and totals copies
  vits.encode          a VITS pass's text encoder, inside batch.acoustic (host, device)
  vits.duration        its duration flow, durations and path (host, device)
  vits.flow            its prior sample and coupling flow (host, device)

Counters: batcher.rounds, batcher.admitted (new streams), stream.k1_steps,
stream.frames_returned, stream.overflow_restarts, batch.overflow_reruns,
batch.rows_padded (batch-bucket and replica padding), batch.frames_decoded
(rows x frame bucket per pass), batch.k1_steps (the steps K1 ran per pass:
each replica's longest row within the bucket, summed over replicas),
batch.frames_returned; of a VITS pass (VitsPipeline, which counts no
batch.k1_steps): vits.tokens (the rows' valid tokens, blanks included) and
vits.frames (the rows' frames within the bucket, after the fetch).
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

RING = 100_000  # raw records kept; the oldest go first
WINDOW = 1024  # durations a name keeps for its percentiles


class Span:
    """One recorded interval.  `device_ms` is set for a device span once its
    events have completed (None before, and for host spans).  A `leg` ran
    between two threads (a request's wait), so it need not nest inside the
    spans of the thread that recorded it."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "req", "parent", "id", "device_ms",
                 "leg")

    def __init__(self, name, start_ns, end_ns, thread, req, parent, id_, device_ms=None,
                 leg=False):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.thread, self.req, self.parent, self.id = thread, req, parent, id_
        self.device_ms, self.leg = device_ms, leg

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Handoff:
    """A request's id, the span open where it was submitted, and the time of
    its last stamp."""

    __slots__ = ("req", "parent", "t_ns")

    def __init__(self, req, parent, t_ns):
        self.req, self.parent, self.t_ns = req, parent, t_ns


class _Agg:
    """A span name's count, total and self time since the last reset, and
    its last WINDOW durations."""

    __slots__ = ("n", "total", "own", "recent")

    def __init__(self):
        self.n, self.total, self.own = 0, 0.0, 0.0
        self.recent: deque = deque(maxlen=WINDOW)

    def add(self, ms: float, own_ms: float) -> None:
        self.n += 1
        self.total += ms
        self.own += own_ms
        self.recent.append(ms)

    def row(self, own: bool) -> dict:
        v = np.fromiter(self.recent, float, len(self.recent))
        ranks = [nearest_rank(len(v), 0.5), nearest_rank(len(v), 0.95)]
        p50, p95 = np.partition(v, ranks)[ranks].tolist()
        out = {"n": self.n, "total_ms": self.total, "mean_ms": self.total / self.n,
               "p50_ms": p50, "p95_ms": p95}
        if own:
            out.update(self_total_ms=self.own, self_mean_ms=self.own / self.n)
        return out


class _Registry:
    def __init__(self):
        self.on = False
        self.ring: deque = deque(maxlen=RING)
        self.pending: deque = deque()  # (Span, start event, end event), in record order
        self.host: Dict[str, _Agg] = {}
        self.device: Dict[str, _Agg] = {}
        self.counters: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.threads: Dict[int, str] = {}  # native thread id: name, of threads that record

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            self.threads[threading.get_native_id()] = threading.current_thread().name
            return self.local.stack

    def record(self, sp: Span, own_ms: float) -> None:
        self.ring.append(sp)
        with self.lock:
            self.host.setdefault(sp.name, _Agg()).add(sp.ms, own_ms)
            if sp.device_ms is not None:
                self.device.setdefault(sp.name, _Agg()).add(sp.device_ms, sp.device_ms)

    def settle(self) -> None:
        """Read the device time of every pending device span whose end event
        has completed, oldest first (one stream completes in order)."""
        with self.lock:
            while self.pending and self.pending[0][2].query():
                sp, e0, e1 = self.pending.popleft()
                sp.device_ms = e0.elapsed_time(e1)
                self.device.setdefault(sp.name, _Agg()).add(sp.device_ms, sp.device_ms)


_reg = _Registry()


def enabled() -> bool:
    return _reg.on or _profiler._is_profiler_enabled


def enable(on: bool = True) -> None:
    """Turn tracing on (or off) for the process, with or without a profiler."""
    _reg.on = bool(on)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def discard(self) -> None:
        pass


NOOP = _Noop()


class _Open:
    """An open span on its thread's stack."""

    __slots__ = ("name", "req", "start_ns", "parent", "id", "keep", "child_ns")

    def __init__(self, name, req, start_ns):
        self.name, self.req, self.start_ns = name, req, start_ns
        self.keep = True
        self.child_ns = 0  # what the spans closed inside it covered

    def __enter__(self):
        stack = _reg.stack()
        self.parent = stack[-1].id if stack else None
        if self.req is None and stack:
            self.req = stack[-1].req
        self.id = next(_reg.ids)
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        stack.append(self)
        return self

    def _close(self, device: bool = False) -> Optional[Span]:
        """Pop the span and make its record; a host span's is recorded here,
        a device span's by its caller, once it has its device time."""
        end = time.time_ns()
        stack = _reg.stack()
        if stack and stack[-1] is self:
            stack.pop()
        if not self.keep:
            return None
        if stack:
            stack[-1].child_ns += end - self.start_ns
        sp = Span(self.name, self.start_ns, end, threading.get_native_id(), self.req,
                  self.parent, self.id)
        if not device:
            _reg.record(sp, max(0, end - self.start_ns - self.child_ns) / 1e6)
        return sp

    def __exit__(self, *exc):
        self._close()
        return False

    def discard(self) -> None:
        """Record nothing for this span (it turned out to hold no work)."""
        self.keep = False


class _OpenDevice(_Open):
    __slots__ = ("device", "events")

    def __init__(self, name, device):
        super().__init__(name, None, None)
        self.device = device
        self.events = None

    def __enter__(self):
        super().__enter__()
        if self.device is not None and self.device.type == "cuda":
            _reg.settle()
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
        sp = self._close(device=True)
        if sp is not None:
            if self.events is None:  # the CPU: the host interval
                sp.device_ms = sp.ms
            _reg.record(sp, max(0, sp.end_ns - sp.start_ns - self.child_ns) / 1e6)
            if self.events is not None:
                with _reg.lock:
                    _reg.pending.append((sp, self.events[0], self.events[1]))
        return False


def span(name: str, req: Optional[int] = None, start_ns: Optional[int] = None):
    """A host span (a context manager); `start_ns` backdates its start."""
    if not enabled():
        return NOOP
    return _Open(name, req, start_ns)


def device_span(name: str, device=None):
    """A host span whose enqueued work on `device` is also timed on the
    device (CUDA events on its current stream)."""
    if not enabled():
        return NOOP
    return _OpenDevice(name, device)


def handoff() -> Optional[Handoff]:
    """A new request's stamp for a span that crosses threads; None while
    tracing is off."""
    if not enabled():
        return None
    stack = _reg.stack()
    return Handoff(next(_reg.ids), stack[-1].id if stack else None, time.time_ns())


def leg(h: Optional[Handoff], name: str) -> None:
    """Record `name` from `h`'s last stamp to now under its request id and
    parent, and stamp `h` now.  Records whether or not tracing is still on:
    the request was stamped while it was."""
    if h is None:
        return
    _reg.stack()  # names this thread
    now = time.time_ns()
    _reg.record(Span(name, h.t_ns, now, threading.get_native_id(), h.req, h.parent,
                     next(_reg.ids), leg=True), (now - h.t_ns) / 1e6)
    h.t_ns = now


def count(name: str, n: int = 1) -> None:
    if not enabled():
        return
    with _reg.lock:
        _reg.counters[name] = _reg.counters.get(name, 0) + int(n)


def recorded() -> bool:
    """Whether any span or counter has been recorded since the last reset."""
    return bool(_reg.ring or _reg.counters)


def spans() -> List[Span]:
    """The raw records, oldest first (device times read where ready)."""
    _reg.settle()
    return list(_reg.ring)


def thread_names() -> Dict[int, str]:
    """The names of the threads that recorded, by native thread id."""
    return dict(_reg.threads)


def reset() -> None:
    with _reg.lock:
        _reg.ring.clear()
        _reg.pending.clear()
        _reg.host.clear()
        _reg.device.clear()
        _reg.counters.clear()


def nearest_rank(n: int, q: float) -> int:
    """The index of the q-quantile, by nearest rank, among n sorted values."""
    return max(0, math.ceil(q * n) - 1)


def snapshot() -> dict:
    """The aggregates of every name and the counters."""
    _reg.settle()
    with _reg.lock:
        return {"spans": {k: a.row(True) for k, a in _reg.host.items()},
                "device": {k: a.row(False) for k, a in _reg.device.items()},
                "counters": dict(_reg.counters)}
