"""The readers of the program's spans in the live cell (`queue_wait.live`,
`first_chunk.live`, `encode_host.live`, `encode_device.live`,
`worker_busy.live`) on hand-built runs: each reads its number from
`DynamicBatcher.stats()["trace"]` as the live driver keeps it, and gives
nothing where the program recorded no spans (a program without them, or
a run without `--trace 1`)."""

from __future__ import annotations

import json
import os

import pytest

from bm_tiny import ROOT
from harness.record import Run
from harness.spec import load_cell, reader

NAMES = ["queue_wait.live", "first_chunk.live", "encode_host.live", "encode_device.live",
         "worker_busy.live"]


def _row(mean_ms, n=4):
    return {"n": n, "total_ms": mean_ms * n, "mean_ms": mean_ms, "p50_ms": mean_ms,
            "p95_ms": mean_ms, "self_total_ms": 0.0, "self_mean_ms": 0.0}


def _run(stats=None, wall_s=3.0):
    run = Run({}, {}, 1)
    run.traced_wall_s = wall_s
    if stats is not None:
        run.notes["stats"] = stats
    return run


TRACE = {"spans": {"batcher.queue_wait": _row(0.5), "stream.first_chunk": _row(30.0),
                   "stream.encode": _row(6.0), "batcher.round": _row(150.0, n=6)},
         "device": {"stream.encode": _row(4.5)},
         "counters": {"batcher.rounds": 6}}


@pytest.mark.parametrize("name,want", [
    ("queue_wait.live", 0.5), ("first_chunk.live", 30.0), ("encode_host.live", 6.0),
    ("encode_device.live", 4.5), ("worker_busy.live", 100.0 * 0.9 / 3.0)])
def test_reader_reads_the_programs_snapshot(name, want):
    stats = {"active_streams": 0, "trace": json.loads(json.dumps(TRACE))}
    assert reader(name)(_run(stats)) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_nothing_without_spans(name):
    read = reader(name)
    assert read(_run()) is None  # no stats at all
    assert read(_run({"active_streams": 0})) is None  # a program without tracing
    assert read(_run({"trace": {"spans": {}, "device": {}, "counters": {}}})) is None
    empty = {k: {n: dict(r, n=0) for n, r in v.items()} if k != "counters" else v
             for k, v in TRACE.items()}
    assert read(_run({"trace": empty})) is None


def test_worker_busy_needs_the_stretch_wall():
    assert reader("worker_busy.live")(_run({"trace": TRACE}, wall_s=0.0)) is None


def test_the_live_cell_alone_reports_them():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    rows = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = rows[name]
        assert (m["workloads"], m["moves"], m["source"]) == (["tts-live"], "ttfa_p95_ms",
                                                           "program_counter")
    assert set(NAMES) <= set(load_cell("tts-live").readers)
    assert not set(NAMES) & set(load_cell("tts-batch").readers)
