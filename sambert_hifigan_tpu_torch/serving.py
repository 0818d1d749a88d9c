"""Dynamic-batching TTS serving: the port's own copy of the JAX package's
`DynamicBatcher`, the same scheduling over the port's `TTSPipeline`.

* **One batch, one call.**  `TTSPipeline.synthesize_batch` pads every
  request of a batch to one (phoneme, frame, batch) bucket, so the batch
  shares one K1 launch (the rows of a cluster share one weight stream) and
  one vocode.
* **Micro-batching window.**  Requests arriving within `max_wait_ms` of each
  other are fused into one call.  Under load the batcher runs back-to-back
  full batches (the wait applies only when the queue is drained); at idle a
  lone request pays at most `max_wait_ms` extra.
* **Grouping by prosody controls.**  A batch shares one set of
  (duration_scale, pitch_shift, energy_scale); requests with other controls
  land in other batches.
* **Streaming, interleaved at chunk granularity.**  `synthesize_stream`
  exposes `TTSPipeline.stream` through the same worker: each active stream
  advances by ONE chunk per scheduling round and at most one fused batch
  runs in between, so a long stream cannot hold back queued `/tts` requests
  and batch bursts cannot stall a live stream.  Stream requests never fuse
  with batch requests; concurrent streams round-robin within the rounds.

Threading model: callers submit from any thread and block on a per-request
event (batch) or a per-request chunk queue (stream); ONE worker thread calls
the pipeline, so one thread feeds the card.  A pipeline over several cards
(`TTSPipeline(devices=...)`) splits each fused batch over them itself, from
this same thread.  PyTorch's grad mode is per
thread: the pipeline's entry points turn it off themselves, so the worker's
outputs never carry autograd state.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class _Request:
    text: str
    controls: Tuple[Tuple[str, float], ...]
    done: threading.Event = field(default_factory=threading.Event)
    wav: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    cancelled: bool = False  # set by a timed-out caller; worker drops it


@dataclass
class _StreamRequest:
    """A streaming synthesis request: the worker drives `pipeline.stream`
    and pushes ('chunk', wav) / ('error', exc) / ('done', None) tuples;
    the caller's generator drains them."""

    text: str
    controls: Tuple[Tuple[str, float], ...]
    stream_kwargs: Dict[str, Any]
    chunks: "queue.Queue" = field(default_factory=queue.Queue)
    cancelled: bool = False  # caller gone (timeout / generator closed)


_SHUTDOWN = object()  # _take_batch's translation of the close() sentinel


class DynamicBatcher:
    """Fuses concurrent synthesis requests into device-sized batches.

    `pipeline` needs one method: `synthesize_batch(texts, **controls) ->
    List[np.ndarray]` (TTSPipeline provides it; tests inject stubs).
    """

    def __init__(
        self,
        pipeline,
        max_batch: int = 16,
        max_wait_ms: float = 20.0,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._leftover = None  # worker-held non-fusing request; leads next batch
        self.batches_run = 0
        self.requests_served = 0
        self.streams_served = 0
        self.stream_chunks = 0
        self.batches_interleaved = 0  # fused batches run while a stream was live
        self._active_streams = 0
        self._worker = threading.Thread(
            target=self._run, name="tts-batcher", daemon=True
        )
        self._worker.start()

    # ---- client side ---------------------------------------------------------

    def synthesize(
        self,
        text: str,
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        """Blocking submit; safe from any thread.  Raises whatever the
        pipeline raised for this request's batch."""
        req = _Request(
            text=text,
            controls=(
                ("duration_scale", float(duration_scale)),
                ("pitch_shift", float(pitch_shift)),
                ("energy_scale", float(energy_scale)),
            ),
        )
        self._queue.put(req)
        if not req.done.wait(timeout):
            # Mark abandoned so the worker drops it instead of synthesizing
            # audio nobody will read (under overload, serving dead requests
            # would keep the device saturated and the backlog would never
            # clear).  Benign race: a request already inside a running batch
            # still completes.
            req.cancelled = True
            raise TimeoutError(f"TTS request timed out after {timeout}s")
        if req.error is not None:
            raise req.error
        assert req.wav is not None
        return req.wav

    def synthesize_stream(
        self,
        text: str,
        chunk_frames: int = 32,
        context_frames: int = 16,
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
        timeout: Optional[float] = None,
    ):
        """Streaming submit: yields waveform chunks as the device produces
        them (`TTSPipeline.stream` underneath — first audio after ~one chunk
        of decode instead of the full utterance).  The stream runs on the
        same single worker thread that owns the device, interleaved with
        batch traffic at chunk granularity (one chunk per active stream per
        scheduling round, at most one fused batch in between).  `timeout`
        bounds the wait for EACH chunk; a timed-out or closed consumer marks
        the request cancelled and the worker drops the stream instead of
        decoding audio nobody reads."""
        req = _StreamRequest(
            text=text,
            controls=(
                ("duration_scale", float(duration_scale)),
                ("pitch_shift", float(pitch_shift)),
                ("energy_scale", float(energy_scale)),
            ),
            stream_kwargs={
                "chunk_frames": int(chunk_frames),
                "context_frames": int(context_frames),
            },
        )
        self._queue.put(req)

        def gen():
            try:
                while True:
                    try:
                        kind, payload = req.chunks.get(timeout=timeout)
                    except queue.Empty:
                        raise TimeoutError(
                            f"TTS stream chunk timed out after {timeout}s"
                        ) from None
                    if kind == "chunk":
                        yield payload
                    elif kind == "error":
                        raise payload
                    else:  # "done"
                        return
            finally:
                # timeout, GeneratorExit, or normal end: flag the request so
                # the worker stops producing chunks for a gone consumer (a
                # no-op if the stream already finished)
                req.cancelled = True

        return gen()

    def close(self):
        """Drain and stop the worker (pending requests still complete)."""
        self._queue.put(None)
        self._worker.join()

    # ---- worker side ---------------------------------------------------------

    def _next_request(self, timeout=None):
        """Pop the next live request: the worker-held leftover first (FIFO —
        re-queueing it at the tail would let steady same-controls traffic
        starve a minority-controls request forever, and would lose it
        entirely if close()'s None sentinel were already queued), then the
        queue, dropping requests whose callers already timed out."""
        while True:
            if self._leftover is not None:
                req, self._leftover = self._leftover, None
            else:
                req = self._queue.get(timeout=timeout)  # may raise queue.Empty
            if req is not None and getattr(req, "cancelled", False):
                continue  # abandoned by a timed-out caller: skip, don't burn a batch slot
            return req

    def _take_batch(self, block: bool = True):
        """Pop the first request (blocking, or immediately raising
        queue.Empty when `block=False` — the worker polls between stream
        chunks), then fill the batch with whatever arrives within the wait
        window.  Only same-controls batch requests fuse; the first differing
        one is held by the worker and leads the NEXT batch.  Stream requests
        never fuse — one returns alone.  Returns _SHUTDOWN for close()'s
        sentinel."""
        first = self._next_request(timeout=None if block else 0)
        if first is None:
            return _SHUTDOWN
        if isinstance(first, _StreamRequest):
            return first
        batch = [first]
        deadline = _now() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - _now()
            if remaining <= 0:
                break
            try:
                req = self._next_request(timeout=remaining)
            except queue.Empty:
                break
            if req is None:  # close() while filling: finish, then stop
                self._queue.put(None)
                break
            if isinstance(req, _StreamRequest) or req.controls != first.controls:
                self._leftover = req
                break
            batch.append(req)
        return batch

    def _open_stream(self, req: _StreamRequest):
        """Create the stream iterator (no device work until the first
        advance)."""
        if req.cancelled:
            self._finish_stream()
            return None
        try:
            return iter(
                self.pipeline.stream(
                    req.text, **req.stream_kwargs, **dict(req.controls)
                )
            )
        except BaseException as e:  # noqa: BLE001 — routed to the caller
            req.chunks.put(("error", e))
            self._finish_stream()
            return None

    def _advance_stream(self, req: _StreamRequest, it) -> bool:
        """Produce ONE chunk for an active stream; False = stream finished
        (done / error / consumer gone) and must leave the active set."""
        if req.cancelled:
            it.close()  # consumer timed out or closed: stop decoding for it
            self._finish_stream()
            return False
        try:
            chunk = next(it)
        except StopIteration:
            req.chunks.put(("done", None))
            self._finish_stream()
            return False
        except BaseException as e:  # noqa: BLE001 — routed to the caller
            req.chunks.put(("error", e))
            self._finish_stream()
            return False
        req.chunks.put(("chunk", chunk))
        with self._stats_lock:
            self.stream_chunks += 1
        return True

    def _finish_stream(self):
        with self._stats_lock:
            self.batches_run += 1
            self.requests_served += 1
            self.streams_served += 1

    def _run_batch(self, batch: List[_Request], interleaved: bool):
        try:
            wavs = self.pipeline.synthesize_batch(
                [r.text for r in batch], **dict(batch[0].controls)
            )
            for r, w in zip(batch, wavs):
                r.wav = w
        except BaseException as e:  # noqa: BLE001 — routed to callers
            for r in batch:
                r.error = e
        with self._stats_lock:
            self.batches_run += 1
            self.requests_served += len(batch)
            if interleaved:
                self.batches_interleaved += 1
        for r in batch:
            r.done.set()

    def _run(self):
        """Worker scheduling loop.  With no streams live it blocks on the
        queue exactly like a plain batcher.  With streams live it runs
        rounds: poll the queue without blocking (admitting one fused batch
        or one new stream), advance every live stream by one chunk, then run
        the polled batch — so streams keep real-time cadence (a chunk of 32
        frames is ~372 ms of audio) while batch traffic makes progress
        between chunks instead of waiting for whole utterances."""
        streams: List[Tuple[_StreamRequest, Any]] = []
        closing = False
        while True:
            work = None
            if not closing:
                try:
                    work = self._take_batch(block=not streams)
                except queue.Empty:
                    pass  # nothing queued: just advance the live streams
            if work is _SHUTDOWN:
                # close(): everything queued before the sentinel is already
                # popped; drain live streams, then stop
                closing = True
                work = None
            if isinstance(work, _StreamRequest):
                it = self._open_stream(work)
                if it is not None:
                    streams.append((work, it))
                work = None
            streams = [s for s in streams if self._advance_stream(*s)]
            with self._stats_lock:
                self._active_streams = len(streams)
            if work:
                self._run_batch(work, interleaved=bool(streams))
            if closing and not streams:
                return

    # ---- observability -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return {
                "batches_run": self.batches_run,
                "requests_served": self.requests_served,
                "streams_served": self.streams_served,
                "mean_batch_size": (
                    self.requests_served / self.batches_run
                    if self.batches_run
                    else 0.0
                ),
                "queue_depth": self._queue.qsize(),
                "stream_chunks": self.stream_chunks,
                "batches_interleaved": self.batches_interleaved,
                "active_streams": self._active_streams,
            }


def _now() -> float:
    return time.monotonic()
