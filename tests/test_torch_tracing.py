"""The port's spans and counters (`sambert_hifigan_tpu_torch/tracing.py`): off,
nothing is recorded; on (by `enable` or under `torch.profiler`, on threads
started before it too), the batcher's and the pipeline's boundaries record
spans that share a request id and nest, on the profiler's clock; and
`profiling.py` merges them into its trace and labels its idle gaps.

This file imports only torch, numpy and the port (never JAX); its card test
runs without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""

import gzip
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sambert_hifigan_tpu_torch import config as c
from sambert_hifigan_tpu_torch import profiling, tracing
from sambert_hifigan_tpu_torch.pipeline import TTSPipeline
from sambert_hifigan_tpu_torch.serving import DynamicBatcher
from sambert_hifigan_tpu_torch.weights import random_acoustic_model, random_generator

STATS_KEYS = {"batches_run", "requests_served", "streams_served", "mean_batch_size",
              "queue_depth", "stream_chunks", "batches_interleaved", "active_streams"}
STREAM_SPANS = {"batcher.queue_wait", "batcher.round", "stream.first_chunk", "stream.chunk",
                "stream.frontend", "stream.encode", "stream.decode", "stream.vocode",
                "stream.fetch"}
STREAM_DEVICE = {"stream.encode", "stream.decode", "stream.vocode"}
BATCH_SPANS = {"batch.call", "batch.frontend", "batch.dispatch", "batch.acoustic",
               "batch.vocode", "batch.fetch"}
CHUNK, CONTEXT = 16, 8


@pytest.fixture(autouse=True)
def clean():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


class StubPipeline:
    """Three chunks a stream, a wav of the text's length a batch row."""

    def synthesize_batch(self, texts, **controls):
        return [np.zeros(len(t), np.float32) for t in texts]

    def stream(self, text, chunk_frames=32, context_frames=16, **controls):
        for i in range(3):
            with tracing.span("stub.part"):
                time.sleep(0.001)
            yield np.full(chunk_frames, float(i), np.float32)


def by_name(records):
    out = {}
    for sp in records:
        out.setdefault(sp.name, []).append(sp)
    return out


# ---- off ----------------------------------------------------------------------------


def test_off_returns_the_shared_noop_and_records_nothing():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.NOOP
    assert tracing.span("a", 3, 5) is tracing.NOOP
    assert tracing.device_span("a", torch.device("cpu")) is tracing.NOOP
    assert tracing.handoff() is None
    with tracing.span("a") as sp:
        sp.discard()
    tracing.count("c", 4)
    tracing.leg(None, "w")
    assert tracing.spans() == [] and not tracing.recorded()
    assert tracing.snapshot() == {"spans": {}, "device": {}, "counters": {}}


def test_off_reads_no_clock_and_makes_no_event_or_range(monkeypatch):
    """Tracing off: the batcher and the pipeline's boundaries read no clock
    of the tracer's, make no CUDA event and open no record_function range;
    `stats()` has exactly its keys."""

    def refuse(*a, **k):
        raise AssertionError("created while tracing is off")

    monkeypatch.setattr(tracing, "time", SimpleNamespace(time_ns=refuse))
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    b = DynamicBatcher(StubPipeline(), max_batch=4, max_wait_ms=1)
    try:
        assert len(list(b.synthesize_stream("abc", timeout=10))) == 3
        assert b.synthesize("hello", timeout=10).shape == (5,)
        assert set(b.stats()) == STATS_KEYS
    finally:
        b.close()
    assert not tracing.recorded()


def test_real_pipeline_off_records_nothing(tiny_pipe):
    b = DynamicBatcher(tiny_pipe, max_batch=2, max_wait_ms=1)
    try:
        list(b.synthesize_stream("你好", CHUNK, CONTEXT, timeout=60))
        b.synthesize("你好", timeout=60)
        assert set(b.stats()) == STATS_KEYS
    finally:
        b.close()
    assert not tracing.recorded()


# ---- on -----------------------------------------------------------------------------


def test_enable_nests_spans_and_passes_the_request_id():
    tracing.enable(True)
    with tracing.span("outer", req=7) as outer:
        with tracing.span("inner") as inner:
            pass
        with tracing.span("dropped") as sp:
            sp.discard()
    tracing.count("hits", 2)
    tracing.count("hits")
    got = by_name(tracing.spans())
    assert set(got) == {"outer", "inner"}
    (o,), (i,) = got["outer"], got["inner"]
    assert (i.parent, i.req, o.parent, o.req) == (outer.id, 7, None, 7) and inner.id == i.id
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert i.thread == o.thread == threading.get_native_id()
    assert tracing.snapshot()["counters"] == {"hits": 3}


def test_device_span_on_the_cpu_takes_the_host_interval():
    tracing.enable(True)
    with tracing.device_span("d", torch.device("cpu")):
        time.sleep(0.002)
    (sp,) = tracing.spans()
    assert sp.device_ms == sp.ms >= 2.0
    assert tracing.snapshot()["device"]["d"]["mean_ms"] == sp.ms


def test_profiler_turns_tracing_on_in_a_thread_started_before_it():
    go, done, seen = threading.Event(), threading.Event(), []

    def worker():
        # a first profiler start in a process with a card can take seconds
        seen.append((go.wait(120), tracing.enabled()))
        with tracing.span("worker.part"):
            torch.ones(4).add_(1)
        done.set()

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        go.set()
        assert done.wait(120)
    th.join(10)
    assert not th.is_alive() and seen == [(True, True)]
    assert not tracing.enabled()
    (sp,) = tracing.spans()
    assert sp.name == "worker.part" and sp.thread == th.native_id


def test_leg_records_across_threads_after_tracing_stops():
    tracing.enable(True)
    with tracing.span("client") as client:
        h = tracing.handoff()
    tracing.enable(False)
    t0 = h.t_ns
    tracing.leg(h, "wait")
    (_, wait) = tracing.spans()
    assert (wait.name, wait.req, wait.parent, wait.leg) == ("wait", h.req, client.id, True)
    assert wait.start_ns == t0 and wait.end_ns == h.t_ns


# ---- the batcher --------------------------------------------------------------------


def test_batcher_stream_spans_share_the_request_and_nest():
    tracing.enable(True)
    b = DynamicBatcher(StubPipeline(), max_batch=4, max_wait_ms=1)
    try:
        chunks = list(b.synthesize_stream("abc", chunk_frames=4, timeout=10))
        stats = b.stats()
    finally:
        b.close()
    assert len(chunks) == 3
    got = by_name(tracing.spans())
    (wait,), (first,) = got["batcher.queue_wait"], got["stream.first_chunk"]
    assert wait.req is not None and first.req == wait.req and wait.leg
    assert first.start_ns == wait.end_ns  # the first chunk runs from the pop
    rounds = {sp.id: sp for sp in got["batcher.round"]}
    outer = rounds[first.parent]
    assert outer.start_ns <= first.start_ns <= first.end_ns <= outer.end_ns
    assert len(got["stream.chunk"]) == 2 and all(sp.req == wait.req for sp in got["stream.chunk"])
    parts = got["stub.part"]
    assert len(parts) == 3 and all(p.req == wait.req for p in parts)
    assert parts[0].parent == first.id
    assert {p.parent for p in parts[1:]} == {sp.id for sp in got["stream.chunk"]}
    counters = stats["trace"]["counters"]
    assert counters["batcher.admitted"] == 1
    # a round for each chunk and the one that finds the generator's end
    assert counters["batcher.rounds"] == len(rounds) == 4
    assert set(stats) == STATS_KEYS | {"trace"}


def test_each_request_waits_once_a_leftover_too():
    """Requests of other controls: the held leftover's wait runs to the
    batch that takes it, and is recorded once."""
    tracing.enable(True)
    b = DynamicBatcher(StubPipeline(), max_batch=4, max_wait_ms=50)
    try:
        threads = [threading.Thread(target=b.synthesize, args=(t,), kwargs=dict(
            duration_scale=s, timeout=10)) for t, s in (("a", 1.0), ("bb", 2.0), ("ccc", 1.0))]
        for th in threads:
            th.start()
            time.sleep(0.005)
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)
    finally:
        b.close()
    waits = by_name(tracing.spans())["batcher.queue_wait"]
    assert len(waits) == 3 and len({w.req for w in waits}) == 3
    assert tracing.snapshot()["spans"]["batcher.queue_wait"]["n"] == 3


# ---- snapshot arithmetic ------------------------------------------------------------


class FakeClock:
    """tracing's clock, moved by hand (ms)."""

    def __init__(self):
        self.ns = 0

    def time_ns(self):
        return self.ns

    def at(self, ms):
        self.ns = int(ms * 1e6)


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(tracing, "time", fake)
    tracing.enable(True)
    return fake


def test_snapshot_nearest_rank_percentiles(clock):
    for i in range(20):  # 1 .. 20 ms, in a shuffled order
        ms = (7 * i) % 20 + 1
        clock.at(100 * i)
        with tracing.span("s"):
            clock.at(100 * i + ms)
    row = tracing.snapshot()["spans"]["s"]
    assert row["n"] == 20 and row["total_ms"] == pytest.approx(210.0)
    assert row["mean_ms"] == pytest.approx(10.5)
    assert row["p50_ms"] == pytest.approx(10.0) and row["p95_ms"] == pytest.approx(19.0)
    assert tracing.nearest_rank(1, 0.95) == 0 and tracing.nearest_rank(20, 0.95) == 18


def test_snapshot_self_time_subtracts_what_children_cover(clock):
    """A parent of 10 ms with children of 2 and 4 ms, a discarded one and a
    request's wait inside it: self time 4 ms; the leg is no child."""
    h = tracing.Handoff(5, None, 0)
    clock.at(0)
    with tracing.span("parent"):
        for start, end in ((1, 3), (4, 8)):
            clock.at(start)
            with tracing.span("child"):
                clock.at(end)
        with tracing.span("gone") as sp:
            clock.at(9)
            sp.discard()
        tracing.leg(h, "wait")
        clock.at(10)
    spans = tracing.snapshot()["spans"]
    assert spans["parent"]["total_ms"] == pytest.approx(10.0)
    assert spans["parent"]["self_total_ms"] == pytest.approx(4.0)
    assert spans["child"]["self_total_ms"] == pytest.approx(6.0)
    assert spans["child"]["self_mean_ms"] == pytest.approx(3.0)
    assert spans["wait"]["self_total_ms"] == pytest.approx(9.0) and "gone" not in spans


def test_the_ring_and_the_windows_are_bounded(clock):
    for i in range(tracing.RING + 25):
        clock.at(i)
        tracing.leg(tracing.Handoff(i, None, clock.ns - int(1e6) * (i % 2)), "x")
    kept = tracing.spans()
    assert len(kept) == tracing.RING and kept[0].req == 25 and kept[-1].req == tracing.RING + 24
    row = tracing.snapshot()["spans"]["x"]
    # count and total over every span; the percentiles over the last WINDOW
    assert row["n"] == tracing.RING + 25
    assert row["total_ms"] == pytest.approx((tracing.RING + 25) // 2)
    assert len(tracing._reg.host["x"].recent) == tracing.WINDOW


# ---- the real pipeline --------------------------------------------------------------


def _cfg():
    return c.TTSConfig(
        acoustic_model=c.AcousticModelConfig(
            d_model=32, encoder=c.EncoderConfig(n_layers=1, n_heads=4, d_ff=64),
            decoder=c.DecoderConfig(n_layers=1, n_heads=4, d_ff=64, max_len=256)),
        vocoder=c.VocoderConfig(generator=c.GeneratorConfig(
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),))),
        runtime=c.RuntimeConfig(phoneme_buckets=(8, 16), frame_buckets=(96, 160)),
    )


@pytest.fixture(scope="module")
def tiny_pipe():
    """~15 frames a phoneme (the duration bias raised): 你好 needs 76 frames,
    within the 96 its phoneme bucket estimates; 今天天气 needs 113 and
    overflows to 160."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    acoustic, generator = random_acoustic_model(cfg, gen), random_generator(cfg, gen)
    with torch.no_grad():
        lin = acoustic.variance_adaptor.duration_predictor.linear
        lin.bias.fill_(2.9)
        lin.weight.mul_(0.1)
    return TTSPipeline(cfg, acoustic.state_dict(), generator.state_dict(), device="cpu")


def test_real_stream_records_every_span_and_counter(tiny_pipe):
    tracing.enable(True)
    b = DynamicBatcher(tiny_pipe, max_batch=2, max_wait_ms=1)
    try:
        streams = {t: list(b.synthesize_stream(t, CHUNK, CONTEXT, timeout=60))
                   for t in ("你好", "今天天气")}
        snap = b.stats()["trace"]
    finally:
        b.close()
    assert STREAM_SPANS <= set(snap["spans"]) and STREAM_DEVICE <= set(snap["device"])
    hop = tiny_pipe.hop
    frames = sum(len(x) for chunks in streams.values() for x in chunks) // hop
    assert frames == 76 + 113
    counters = snap["counters"]
    assert counters["stream.frames_returned"] == frames
    assert counters["stream.overflow_restarts"] == 1  # 今天天气: 96 -> 160
    assert counters["batcher.admitted"] == 2 and counters["batcher.rounds"] >= 2
    # chunks of 16 up to each window's right context: 你好 80 of its 76
    # frames; 今天天气 32 at 96, then 128 of its 113 at 160
    assert counters["stream.k1_steps"] == 80 + 32 + 128
    assert snap["spans"]["stream.first_chunk"]["n"] == 2
    assert snap["spans"]["batcher.queue_wait"]["n"] == 2
    # the parts of a first chunk nest in it and carry its request
    got = by_name(tracing.spans())
    for first in got["stream.first_chunk"]:
        kids = {sp.name for sp in tracing.spans() if sp.parent == first.id}
        assert {"stream.frontend", "stream.encode", "stream.decode", "stream.vocode",
                "stream.fetch"} <= kids
        assert all(sp.req == first.req for sp in tracing.spans() if sp.parent == first.id)
    assert snap["device"]["stream.encode"]["mean_ms"] <= snap["spans"]["stream.first_chunk"][
        "mean_ms"]


def test_real_synthesize_batch_counts_padding_frames_and_the_rerun(tiny_pipe):
    tracing.enable(True)
    wavs = tiny_pipe.synthesize_batch(["你好", "今天天气", "abc"])
    snap = tracing.snapshot()
    assert BATCH_SPANS <= set(snap["spans"])
    assert {"batch.acoustic", "batch.vocode"} <= set(snap["device"])
    counters = snap["counters"]
    returned = sum(len(w) for w in wavs) // tiny_pipe.hop
    assert counters["batch.frames_returned"] == returned == 76 + 113 + 93
    assert counters["batch.rows_padded"] == 1  # 3 texts in the batch bucket of 4
    assert counters["batch.overflow_reruns"] == 1
    assert counters["batch.frames_decoded"] == 4 * 96 + 4 * 160
    assert snap["spans"]["batch.dispatch"]["n"] == 2 == snap["spans"]["batch.fetch"]["n"]
    assert snap["spans"]["batch.call"]["n"] == 1


@pytest.mark.parametrize("replicas,steps", [(1, [96, 113]), (2, [96 + 93, 113 + 93])],
                         ids=["one-replica", "two-replicas"])
def test_batch_k1_steps_count_each_replicas_longest_row_within_the_bucket(tiny_pipe, replicas,
                                                                           steps):
    """Per pass, each replica's K1 runs to min(its longest total, bucket):
    the first pass at 96 (今天天气's 113 past it), the overflow re-run at
    160.  Two replicas take rows [你好, 今天天气] and [abc, abc] (93)."""
    pipe = tiny_pipe
    if replicas > 1:
        pipe = TTSPipeline(tiny_pipe.cfg, tiny_pipe.acoustic.state_dict(),
                           tiny_pipe.generator.state_dict(), devices=["cpu"] * replicas)
    tracing.enable(True)
    pipe.synthesize_batch(["你好", "今天天气", "abc"])
    counters = tracing.snapshot()["counters"]
    assert counters["batch.overflow_reruns"] == 1
    assert counters["batch.k1_steps"] == sum(steps)
    assert counters["batch.frames_decoded"] == 4 * 96 + 4 * 160


# ---- the clock and profiling.py ---------------------------------------------------


def test_a_span_contains_its_operator_on_the_profiler_axis():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("around"):
            torch.ones(8) * 2
    (mul,) = [e for e in prof.events() if e.name == "aten::mul"]
    ((s, e, sp),) = profiling.program_spans(prof)
    assert sp.name == "around"
    assert s <= mul.time_range.start <= mul.time_range.end <= e


def test_export_merges_every_threads_spans(tmp_path):
    go, done, woke = threading.Event(), threading.Event(), []

    def worker():
        woke.append(go.wait(120))
        with tracing.span("worker.part"):
            time.sleep(0.002)
        done.set()

    th = threading.Thread(target=worker, name="tts-batcher", daemon=True)
    th.start()

    def fn():
        with tracing.span("main.part"):
            h = tracing.handoff()
            torch.ones(8) * 2
        go.set()
        done.wait(120)
        tracing.leg(h, "batcher.queue_wait")

    prof, _, _ = profiling.capture(fn, cuda=False)
    th.join(10)
    assert woke == [True] and not th.is_alive()
    profiling.export(prof, tmp_path / "trace.json.gz")
    with gzip.open(tmp_path / "trace.json.gz", "rt") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program"]
    x = {e["name"]: e for e in ours if e["ph"] == "X"}
    assert set(x) == {"main.part", "worker.part"}
    assert x["worker.part"]["tid"] == th.native_id
    assert x["main.part"]["tid"] == threading.get_native_id()
    assert sorted(e["ph"] for e in ours if e["name"] == "batcher.queue_wait") == ["b", "e"]
    names = {e["tid"]: e["args"]["name"] for e in events if e.get("name") == "thread_name"}
    assert names[th.native_id].startswith("tts-batcher")
    mul = next(e for e in events if e.get("name") == "aten::mul")
    main = x["main.part"]
    assert main["ts"] <= mul["ts"] and mul["ts"] + mul["dur"] <= main["ts"] + main["dur"] + 1e-3


def _event(name, start, end, device=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(
        start=start, end=end, elapsed_us=lambda: end - start))


def test_idle_gaps_take_the_innermost_program_span_then_the_host_operator():
    """Kernels at 0-10, 110-120, 170-180 and 200-210 us: gaps of 100, 50 and
    20 us.  A program span and a wider one over the first gap's middle, a
    request's wait alone over the second's, nothing over the third's."""
    base = 1_000_000_000
    events = [_event("k", a, b, device=True) for a, b in ((0, 10), (110, 120), (170, 180),
                                                           (200, 210))]
    events += [_event("cudaStreamSynchronize", 20, 100), _event("aten::copy_", 185, 188)]
    prof = SimpleNamespace(events=lambda: events, profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(trace_start_ns=lambda: base)))
    tracing._reg.ring.extend([
        tracing.Span("batcher.round", base + 5_000, base + 130_000, 1, None, None, 1),
        tracing.Span("stream.decode", base + 40_000, base + 90_000, 1, None, 1, 2),
        tracing.Span("batcher.queue_wait", base + 30_000, base + 160_000, 1, 9, None, 3,
                     leg=True),
    ])
    assert profiling.idle_gaps(prof, 3) == [("stream.decode", 0.1), ("batcher.queue_wait", 0.05),
                                            ("after aten::copy_", 0.02)]
    summary = profiling.summarize(prof, wall_ms=1.0)
    assert summary["busy_ms"] == pytest.approx(0.04)
    assert summary["idle_gaps"][0] == ("stream.decode", 0.1)


# ---- the card ----------------------------------------------------------------------


def k1_span_on_card() -> dict:
    """A span around one ar_decode_chunk and its fetch, and that launch's
    ar_decode_kernel, in a profiling.py capture: both intervals on the
    capture's axis (us)."""
    from sambert_hifigan_tpu_torch import kernels
    from sambert_hifigan_tpu_torch.models.ar_decoder import ar_decode_chunk
    from sambert_hifigan_tpu_torch.pipeline import _StreamRun

    kernels.build_all()
    cfg = _cfg()
    pipe = TTSPipeline(cfg, random_acoustic_model(cfg, torch.Generator().manual_seed(0))
                       .state_dict(), random_generator(cfg, torch.Generator().manual_seed(1))
                       .state_dict(), device="cuda")
    _, args = pipe._frontend_args(["你好"])
    run = _StreamRun(pipe, args, (1.0, 0.0, 1.0), 96, CHUNK, CONTEXT)

    def one_chunk():
        with tracing.span("decode+fetch"):
            _, mel = ar_decode_chunk(pipe.decode_weights, run.memory, run.carry, 0, CHUNK)
            mel.cpu()

    one_chunk()  # the first launch
    torch.cuda.synchronize()
    prof, _, _ = profiling.capture(one_chunk)
    k1 = [(e.time_range.start, e.time_range.end) for e in profiling.kernel_events(prof)
          if "ar_decode_kernel" in e.name]
    span = [(s, e) for s, e, sp in profiling.program_spans(prof) if sp.name == "decode+fetch"]
    return {"k1": k1, "span": span}


@pytest.mark.cuda
def test_a_decode_span_contains_its_k1_launch_on_card():
    """On the card: a span around one ar_decode_chunk and its fetch holds
    that launch's ar_decode_kernel interval in a profiling.py capture.  In
    a process of its own: run after this file's other tests in one process
    (torch 2.11, CUDA 12.8), the capture recorded no kernel at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", "import json, tests.test_torch_tracing as t; "
         "print(json.dumps(t.k1_span_on_card()))"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ((k_start, k_end),), ((s, e),) = got["k1"], got["span"]
    assert s <= k_start <= k_end <= e
