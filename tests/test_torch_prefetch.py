"""The port's Prefetcher and prefetch policy (data/prefetch.py), held to
the JAX package's contract (tests/test_prefetch.py, ported case by case):
order and exhaustion, `transfer` on the worker thread, exceptions of the
source and of `transfer` at the consumer, bounded lookahead, overlap,
prompt and idempotent close, the context manager, the 'auto' policy; and
the port's own: a batch moved by `batch_to_device` in the worker thread
arrives whole and in order, and the trainers' --prefetch flags.
"""

import argparse
import threading
import time

import numpy as np
import pytest
import torch

from sambert_hifigan_tpu_torch.config import TTSConfig
from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
from sambert_hifigan_tpu_torch.data.prefetch import (
    Prefetcher,
    add_prefetch_flags,
    want_prefetch,
)


def test_order_and_exhaustion():
    out = list(Prefetcher(iter(range(50))))
    assert out == list(range(50))
    p = Prefetcher(iter(range(3)))
    assert [next(p), next(p), next(p)] == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(p)
    with pytest.raises(StopIteration):  # stays exhausted
        next(p)


def test_transfer_runs_in_worker_thread():
    main = threading.get_ident()
    seen_threads = []

    def transfer(x):
        seen_threads.append(threading.get_ident())
        return x * 10

    out = list(Prefetcher(iter(range(5)), transfer=transfer))
    assert out == [0, 10, 20, 30, 40]
    assert all(t != main for t in seen_threads)


def test_source_exception_propagates_with_cause():
    def gen():
        yield 1
        yield 2
        raise ValueError("disk on fire")

    p = Prefetcher(gen())
    assert next(p) == 1
    assert next(p) == 2
    with pytest.raises(RuntimeError) as ei:
        # may need to drain queued items first — but the failure replaces
        # the stream immediately after the last good item
        next(p)
    assert isinstance(ei.value.__cause__, ValueError)
    with pytest.raises(StopIteration):  # terminal after failure
        next(p)


def test_transfer_exception_propagates():
    def transfer(x):
        if x == 3:
            raise KeyError("bad batch")
        return x

    p = Prefetcher(iter(range(6)), transfer=transfer)
    assert [next(p), next(p), next(p)] == [0, 1, 2]
    with pytest.raises(RuntimeError) as ei:
        next(p)
    assert isinstance(ei.value.__cause__, KeyError)


def test_bounded_lookahead():
    """With the consumer stalled, the worker produces at most depth items
    plus the one in its hands."""
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    p = Prefetcher(gen(), depth=2)
    time.sleep(0.3)  # worker runs free; consumer never pulls
    assert len(produced) <= 2 + 1
    p.close()


def test_overlap_beats_serial():
    """Producer and consumer each cost ~d per item; pipelined wall time must
    land well under the 2*N*d serial time."""
    d, n = 0.015, 12

    def gen():
        for i in range(n):
            time.sleep(d)
            yield i

    t0 = time.perf_counter()
    p = Prefetcher(gen(), depth=2)
    for _ in range(n):
        next(p)
        time.sleep(d)  # the "device step"
    wall = time.perf_counter() - t0
    serial = 2 * n * d
    assert wall < 0.85 * serial, f"no overlap: wall {wall:.3f}s vs serial {serial:.3f}s"


def test_close_unblocks_full_queue_promptly():
    def gen():
        i = 0
        while True:  # infinite producer
            yield i
            i += 1

    p = Prefetcher(gen(), depth=1)
    assert next(p) == 0
    t0 = time.perf_counter()
    p.close()
    assert time.perf_counter() - t0 < 2.0
    assert not p._worker.is_alive()
    p.close()  # idempotent


def test_context_manager():
    with Prefetcher(iter(range(4))) as p:
        assert next(p) == 0
    assert not p._worker.is_alive()


def test_want_prefetch_policy(monkeypatch):
    """'on'/'off' are absolute; 'auto' follows the AVAILABLE core count
    (affinity-aware: a container pinned to 1 CPU of a 64-core host must
    count as 1 — the measured contention regime in the module docstring)."""
    assert want_prefetch("on") is True
    assert want_prefetch("off") is False
    import sambert_hifigan_tpu_torch.data.prefetch as pf

    monkeypatch.setattr(pf.os, "sched_getaffinity", lambda pid: {0}, raising=False)
    assert want_prefetch("auto") is False
    monkeypatch.setattr(
        pf.os, "sched_getaffinity", lambda pid: set(range(8)), raising=False
    )
    assert want_prefetch("auto") is True

    # non-Linux fallback: sched_getaffinity missing -> os.cpu_count
    monkeypatch.delattr(pf.os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(pf.os, "cpu_count", lambda: 1)
    assert want_prefetch("auto") is False
    monkeypatch.setattr(pf.os, "cpu_count", lambda: 8)
    assert want_prefetch("auto") is True
    monkeypatch.setattr(pf.os, "cpu_count", lambda: None)
    assert want_prefetch("auto") is False


def test_batches_moved_on_the_worker_thread_arrive_in_order():
    cfg = TTSConfig()
    host = [synthetic_batch(cfg, 2, tph=8, tfrm=16, seed=i) for i in range(5)]
    with Prefetcher(iter(host), transfer=lambda b: batch_to_device(b, "cpu")) as p:
        got = list(p)
    assert len(got) == 5
    for h, d in zip(host, got):
        assert "frame_lengths" not in d and d["ph_ids"].dtype == torch.int64
        for k, v in d.items():
            np.testing.assert_array_equal(v.numpy(), h[k])


def test_prefetch_flags():
    p = argparse.ArgumentParser()
    add_prefetch_flags(p)
    assert p.parse_args([]).prefetch == "auto"
    assert p.parse_args(["--prefetch", "on"]).prefetch == "on"
    assert p.parse_args(["--no-prefetch"]).prefetch == "off"
    with pytest.raises(SystemExit):
        p.parse_args(["--prefetch", "maybe"])
