"""The port's serving layer: its own DynamicBatcher and HTTP handler.

The cases of tests/test_serving.py, with the same stub pipeline and the same
timing margins, run against `sambert_hifigan_tpu_torch.serving` and
`sambert_hifigan_tpu_torch.serve`; then the port's batcher over the real
pipeline on the CPU (small config), through HTTP, and the server's command
line.
"""

import contextlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from sambert_hifigan_tpu_torch.serving import DynamicBatcher


class StubPipeline:
    """Returns a wav encoding (text length, controls) so tests can verify
    routing; records every batch it was called with."""

    def __init__(self, delay_s: float = 0.0, fail_on: str = None):
        self.calls = []
        self.delay_s = delay_s
        self.fail_on = fail_on
        self.lock = threading.Lock()

    def synthesize_batch(self, texts, **controls):
        with self.lock:
            self.calls.append((list(texts), dict(controls)))
        if self.fail_on is not None and self.fail_on in texts:
            raise RuntimeError(f"stub failure for {self.fail_on}")
        if self.delay_s:
            time.sleep(self.delay_s)
        return [
            np.full(len(t), controls["duration_scale"], np.float32)
            for t in texts
        ]

    def stream(self, text, chunk_frames=32, context_frames=16, **controls):
        """One chunk per character, value = its index (ordering check)."""
        with self.lock:
            self.calls.append(("stream", text, dict(controls)))
        if self.fail_on is not None and self.fail_on in text:
            raise RuntimeError(f"stub stream failure for {self.fail_on}")
        for i in range(len(text)):
            if self.delay_s:
                time.sleep(self.delay_s)
            yield np.full(chunk_frames, float(i), np.float32)


class TestDynamicBatcher:
    def test_single_request_roundtrip(self):
        b = DynamicBatcher(StubPipeline(), max_batch=4, max_wait_ms=1)
        wav = b.synthesize("hello")
        assert wav.shape == (5,)
        b.close()

    def test_concurrent_requests_fuse_into_batches(self):
        """8 requests released together against a slow first batch must NOT
        run as 8 singleton batches."""
        stub = StubPipeline(delay_s=0.05)
        b = DynamicBatcher(stub, max_batch=8, max_wait_ms=30)
        results = {}

        def worker(i):
            results[i] = b.synthesize(f"text-{i:02d}")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        b.close()
        assert len(results) == 8
        for i, wav in results.items():
            assert wav.shape == (len(f"text-{i:02d}"),)
        st = {"batches": len(stub.calls)}
        assert st["batches"] < 8, f"no fusion happened: {stub.calls}"
        assert sum(len(c[0]) for c in stub.calls) == 8

    def test_max_batch_respected(self):
        stub = StubPipeline(delay_s=0.02)
        b = DynamicBatcher(stub, max_batch=3, max_wait_ms=50)
        threads = [
            threading.Thread(target=lambda i=i: b.synthesize(f"t{i}"))
            for i in range(7)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        b.close()
        assert max(len(c[0]) for c in stub.calls) <= 3

    def test_different_controls_never_share_a_batch(self):
        stub = StubPipeline(delay_s=0.02)
        b = DynamicBatcher(stub, max_batch=8, max_wait_ms=40)
        outs = {}

        def worker(i):
            outs[i] = b.synthesize("abc", duration_scale=1.0 + (i % 2))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        b.close()
        for _, controls in stub.calls:
            assert controls["duration_scale"] in (1.0, 2.0)
        # every request got ITS controls' output back
        for i, wav in outs.items():
            assert wav[0] == 1.0 + (i % 2)

    def test_error_propagates_to_all_callers_in_batch(self):
        b = DynamicBatcher(StubPipeline(fail_on="bad"), max_batch=2, max_wait_ms=1)
        with pytest.raises(RuntimeError, match="stub failure"):
            b.synthesize("bad")
        # batcher survives the failure
        assert b.synthesize("ok").shape == (2,)
        b.close()

    def test_timeout(self):
        b = DynamicBatcher(StubPipeline(delay_s=0.5), max_batch=1, max_wait_ms=1)
        with pytest.raises(TimeoutError):
            b.synthesize("x", timeout=0.05)
        b.close()

    def test_timed_out_requests_are_not_synthesized(self):
        """An abandoned (timed-out) request must be dropped by the worker,
        not burned as dead device work — under overload the server has to
        shed load, not saturate the chip with audio nobody reads."""
        stub = StubPipeline(delay_s=0.2)
        b = DynamicBatcher(stub, max_batch=1, max_wait_ms=1)
        with pytest.raises(TimeoutError):
            b.synthesize("first", timeout=0.05)  # occupies the worker
        with pytest.raises(TimeoutError):
            b.synthesize("dead", timeout=0.05)  # abandoned while queued
        assert b.synthesize("live").shape == (4,)
        b.close()
        texts = [t for call in stub.calls for t in call[0]]
        assert "dead" not in texts
        assert "live" in texts

    def test_leftover_is_served_next_not_requeued(self):
        """A non-fusing (minority-controls) request leads the NEXT batch
        instead of going to the queue tail, so steady same-controls traffic
        cannot starve it, and close() cannot strand it behind the shutdown
        sentinel."""
        stub = StubPipeline(delay_s=0.05)
        b = DynamicBatcher(stub, max_batch=8, max_wait_ms=60)
        results = {}

        def worker(i, scale):
            results[i] = b.synthesize(f"t{i}", duration_scale=scale)

        # one minority request submitted among majority traffic
        threads = [
            threading.Thread(target=worker, args=(i, 1.0)) for i in range(4)
        ] + [threading.Thread(target=worker, args=(99, 2.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        b.close()
        assert results[99][0] == 2.0  # served, with ITS controls
        # the minority batch ran immediately after the batch that popped it
        # (no unbounded deferral): 3 batches in the tightest schedule, +1
        # margin for staggered thread starts on a loaded 1-core CI host
        assert len(stub.calls) <= 4, stub.calls

    def test_stats(self):
        b = DynamicBatcher(StubPipeline(), max_batch=4, max_wait_ms=1)
        b.synthesize("abcd")
        b.synthesize("ef")
        st = b.stats()
        b.close()
        assert st["requests_served"] == 2
        assert st["batches_run"] >= 1
        assert st["mean_batch_size"] >= 1.0


class TestStreaming:
    def test_chunks_arrive_in_order(self):
        b = DynamicBatcher(StubPipeline(), max_batch=4, max_wait_ms=1)
        got = list(b.synthesize_stream("abc", chunk_frames=8))
        b.close()
        assert len(got) == 3
        for i, c in enumerate(got):
            assert c.shape == (8,)
            assert c[0] == float(i)

    def test_chunks_are_incremental_not_buffered(self):
        """With a per-chunk delay, the first chunk must arrive well before
        the stream completes (the worker pushes as it synthesizes)."""
        stub = StubPipeline(delay_s=0.05)
        b = DynamicBatcher(stub, max_batch=4, max_wait_ms=1)
        t0 = time.monotonic()
        it = b.synthesize_stream("abcdefgh", timeout=5.0)
        first_at = None
        n = 0
        for _ in it:
            if first_at is None:
                first_at = time.monotonic() - t0
            n += 1
        total = time.monotonic() - t0
        b.close()
        assert n == 8
        assert first_at < total / 2, (first_at, total)

    def test_stream_error_propagates(self):
        b = DynamicBatcher(StubPipeline(fail_on="bad"), max_batch=2, max_wait_ms=1)
        with pytest.raises(RuntimeError, match="stub stream failure"):
            list(b.synthesize_stream("bad"))
        # batcher survives and still serves both kinds
        assert b.synthesize("ok").shape == (2,)
        assert len(list(b.synthesize_stream("ok"))) == 2
        b.close()

    def test_streams_never_fuse_with_batches(self):
        stub = StubPipeline(delay_s=0.01)
        b = DynamicBatcher(stub, max_batch=8, max_wait_ms=30)
        results = {}

        def batch_worker(i):
            results[f"b{i}"] = b.synthesize(f"tx{i}")

        def stream_worker(i):
            results[f"s{i}"] = list(b.synthesize_stream("xyz"))

        threads = [threading.Thread(target=batch_worker, args=(i,)) for i in range(3)]
        threads += [threading.Thread(target=stream_worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = b.stats()
        b.close()
        assert st["streams_served"] == 2
        assert st["requests_served"] == 5
        for i in range(3):
            assert results[f"b{i}"].shape == (3,)
        for i in range(2):
            assert len(results[f"s{i}"]) == 3
        # no stub call mixes stream and batch texts
        for call in stub.calls:
            if call[0] == "stream":
                assert call[1] == "xyz"
            else:
                assert all(t.startswith("tx") for t in call[0])

    def test_chunk_timeout(self):
        b = DynamicBatcher(StubPipeline(delay_s=0.5), max_batch=1, max_wait_ms=1)
        with pytest.raises(TimeoutError):
            list(b.synthesize_stream("xy", timeout=0.05))
        b.close()

    def test_long_stream_does_not_block_batch_requests(self):
        """A long-running stream must interleave with queued batch traffic
        at chunk granularity: batch latency stays bounded by ~a chunk time,
        not the whole stream; the stream still completes."""
        stub = StubPipeline(delay_s=0.05)  # 40-chunk stream = 2 s total
        b = DynamicBatcher(stub, max_batch=8, max_wait_ms=1)
        stream_chunks = []
        stream_done = threading.Event()

        def stream_worker():
            for c in b.synthesize_stream("x" * 40, timeout=10.0):
                stream_chunks.append(time.monotonic())
            stream_done.set()

        t = threading.Thread(target=stream_worker)
        t.start()
        while not stream_chunks:  # stream is live and producing
            time.sleep(0.005)
        # batch requests submitted MID-stream must complete long before the
        # stream does (pre-interleaving they waited for the full 2 s drive)
        t0 = time.monotonic()
        wav = b.synthesize("hello", timeout=5.0)
        batch_latency = time.monotonic() - t0
        assert wav.shape == (5,)
        assert not stream_done.is_set(), "stream finished too fast to test"
        assert batch_latency < 1.0, batch_latency  # ~1 chunk (50ms) + margin
        t.join()
        st = b.stats()
        b.close()
        assert len(stream_chunks) == 40
        assert st["batches_interleaved"] >= 1
        assert st["stream_chunks"] == 40

    def test_cancelled_stream_is_dropped_by_worker(self):
        """A consumer that times out (or closes the generator) must stop the
        worker from decoding further chunks for it."""
        stub = StubPipeline(delay_s=0.05)
        b = DynamicBatcher(stub, max_batch=1, max_wait_ms=1)
        it = b.synthesize_stream("x" * 50, timeout=5.0)
        next(it)
        it.close()  # consumer walks away after one chunk
        # worker must go idle: a batch request is served promptly and the
        # dropped stream stops consuming rounds
        assert b.synthesize("ok", timeout=5.0).shape == (2,)
        time.sleep(0.3)
        st = b.stats()
        b.close()
        assert st["streams_served"] == 1  # finished (as cancelled), not leaked
        assert st["stream_chunks"] < 50, st["stream_chunks"]

    def test_two_streams_round_robin(self):
        stub = StubPipeline(delay_s=0.01)
        b = DynamicBatcher(stub, max_batch=4, max_wait_ms=1)
        results = {}

        def worker(name, text):
            results[name] = list(b.synthesize_stream(text, timeout=5.0))

        ts = [
            threading.Thread(target=worker, args=("a", "abcdefgh")),
            threading.Thread(target=worker, args=("b", "12345678")),
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = b.stats()
        b.close()
        assert len(results["a"]) == 8 and len(results["b"]) == 8
        assert st["streams_served"] == 2
        assert st["stream_chunks"] == 16


class TestSoak:
    @pytest.mark.slow
    def test_sustained_mixed_load(self):
        """Minutes-scale soak: concurrent batch requests (mixed controls),
        streams (some abandoned mid-flight), and aggressive timeouts, all
        racing.  Asserts the boundaries the one-shot tests touch once each:
        no leak of cancelled/abandoned requests, queue drains to empty,
        worker stays alive, and throughput holds steady across the run."""
        import gc

        stub = StubPipeline(delay_s=0.002)
        b = DynamicBatcher(stub, max_batch=8, max_wait_ms=2)
        stop_at = time.monotonic() + 60.0
        errors = []
        counts = {"ok": 0, "timeout": 0, "stream_ok": 0, "stream_drop": 0}
        lock = threading.Lock()
        window_marks = []  # (t, requests_served) for steadiness check

        def batch_client(i):
            k = 0
            while time.monotonic() < stop_at:
                k += 1
                scale = 1.0 + (k % 3) * 0.5  # rotate controls
                # every 7th request gets a timeout designed to fire under
                # burst load; the rest get a generous one
                tmo = 0.001 if k % 7 == 0 else 5.0
                try:
                    wav = b.synthesize(f"text{i}", duration_scale=scale,
                                       timeout=tmo)
                    assert wav.shape == (len(f"text{i}"),)
                    assert wav[0] == scale
                    with lock:
                        counts["ok"] += 1
                except TimeoutError:
                    with lock:
                        counts["timeout"] += 1
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    return

        def stream_client(i):
            k = 0
            while time.monotonic() < stop_at:
                k += 1
                try:
                    it = b.synthesize_stream("streamtxt", timeout=5.0)
                    if k % 3 == 0:  # abandon a third of streams mid-flight
                        next(it)
                        it.close()
                        with lock:
                            counts["stream_drop"] += 1
                    else:
                        chunks = list(it)
                        assert len(chunks) == 9
                        with lock:
                            counts["stream_ok"] += 1
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    return

        threads = [
            threading.Thread(target=batch_client, args=(i,)) for i in range(4)
        ] + [threading.Thread(target=stream_client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        while time.monotonic() < stop_at:
            time.sleep(5)
            window_marks.append((time.monotonic(), b.stats()["requests_served"]))
        for t in threads:
            t.join()
        # let the worker drain whatever the clients left queued
        deadline = time.monotonic() + 10
        while b.stats()["queue_depth"] > 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        st = b.stats()
        assert not errors, errors[:3]
        assert st["queue_depth"] == 0
        assert st["active_streams"] == 0
        # the worker is still alive and serving after the storm
        assert b.synthesize("alive", timeout=5.0).shape == (5,)
        b.close()
        # work actually happened, including every boundary
        assert counts["ok"] > 100, counts
        assert counts["timeout"] > 0, counts  # timeouts really fired
        assert counts["stream_ok"] > 5 and counts["stream_drop"] > 2, counts
        # steadiness: per-5s-window served counts never collapse (>25% of
        # the per-window mean — generous for a 1-core CI host under GC)
        rates = [
            (window_marks[i + 1][1] - window_marks[i][1])
            / (window_marks[i + 1][0] - window_marks[i][0])
            for i in range(len(window_marks) - 1)
        ]
        mean_rate = sum(rates) / len(rates)
        assert all(r > 0.25 * mean_rate for r in rates), rates
        # no leaked request objects: after the clients are gone and the
        # queue is drained, no _Request/_StreamRequest survives a full GC
        from sambert_hifigan_tpu_torch import serving as serving_mod

        gc.collect()
        leaked = [
            o for o in gc.get_objects()
            if isinstance(o, (serving_mod._Request, serving_mod._StreamRequest))
        ]
        assert not leaked, f"{len(leaked)} request objects leaked"


class TestHTTPServer:
    @pytest.fixture()
    def server(self):
        from http.server import ThreadingHTTPServer

        from sambert_hifigan_tpu_torch.serve import make_handler

        stub = StubPipeline()
        batcher = DynamicBatcher(stub, max_batch=4, max_wait_ms=1)
        httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), make_handler(batcher, 22050, request_timeout=10.0)
        )
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        yield httpd, stub
        httpd.shutdown()
        httpd.server_close()
        batcher.close()

    def test_tts_roundtrip_wav(self, server):
        httpd, _ = server
        port = httpd.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tts",
            data=json.dumps({"text": "hello"}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "audio/wav"
            body = resp.read()
        import io
        import wave

        with wave.open(io.BytesIO(body)) as w:
            assert w.getframerate() == 22050
            assert w.getnframes() == 5  # stub wav length == len("hello")

    def test_healthz(self, server):
        httpd, _ = server
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as resp:
            payload = json.loads(resp.read())
        assert payload["ok"] is True
        assert "requests_served" in payload

    def test_bad_request_400(self, server):
        httpd, _ = server
        port = httpd.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tts", data=b'{"no_text": 1}'
        )
        try:
            urllib.request.urlopen(req)
            assert False, "expected HTTPError"
        except urllib.error.HTTPError as e:
            assert e.code == 400

    def test_tts_stream_roundtrip(self, server):
        """/tts/stream returns a live WAV: unknown-length RIFF header followed
        by PCM16 chunks, message delimited by connection close."""
        httpd, _ = server
        port = httpd.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tts/stream",
            data=json.dumps({"text": "hello", "chunk_frames": 4}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "audio/wav"
            assert resp.headers.get("Content-Length") is None
            body = resp.read()  # close-delimited
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        # 44-byte header + 5 chunks (one per char) of 4 samples of int16
        pcm = np.frombuffer(body[44:], "<i2")
        assert pcm.shape == (5 * 4,)
        # stub chunk i is constant i/32767-ish after int16 quantization
        got = pcm.reshape(5, 4)[:, 0]
        assert list(got) == [min(i * 32767, 32767) for i in range(5)]


class TestPortPipelineOverHTTP:
    """The port's batcher and server over the real pipeline on the CPU."""

    @pytest.fixture(scope="class")
    def pipe(self):
        from sambert_hifigan_tpu_torch import config as pcfg
        from sambert_hifigan_tpu_torch.pipeline import build_pipeline_from_random_init
        from tests.test_torch_pipeline import _small_cfg

        return build_pipeline_from_random_init(_small_cfg(pcfg), seed=0, device="cpu")

    def test_tts_and_stream_equal_the_pipeline(self, pipe, monkeypatch):
        """max_batch=1, so /tts runs the batch synthesize runs.  The
        pipeline runs in the batcher's worker thread, where grad mode is on:
        nothing it computes may carry autograd state."""
        import io
        import wave

        import torch

        from sambert_hifigan_tpu_torch import pipeline as pipeline_mod
        from sambert_hifigan_tpu_torch.serve import make_server, pcm16

        seen = []

        def spy(fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                mel = out[1] if isinstance(out, tuple) else out
                seen.append((torch.is_grad_enabled(), mel.requires_grad))
                return out
            return call

        monkeypatch.setattr(pipe.generator, "forward", spy(pipe.generator.forward))
        monkeypatch.setattr(pipeline_mod, "ar_decode_chunk", spy(pipeline_mod.ar_decode_chunk))
        text = "今天天气"
        want_wav = pipe.synthesize(text)
        want_pcm = b"".join(pcm16(c) for c in pipe.stream(text, chunk_frames=4))
        seen.clear()

        b = DynamicBatcher(pipe, max_batch=1, max_wait_ms=1)
        httpd = make_server(b, "127.0.0.1", 0, pipe.cfg.audio.sample_rate, 30.0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        port = httpd.server_address[1]
        try:
            outs = [b.synthesize(text), *b.synthesize_stream(text, chunk_frames=4)]
            for path, body in (("/tts", {"text": text}),
                               ("/tts/stream", {"text": text, "chunk_frames": 4})):
                req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                             data=json.dumps(body).encode())
                with urllib.request.urlopen(req, timeout=60) as resp:
                    outs.append(resp.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            b.close()
        direct, *chunks, tts, stream = outs
        with wave.open(io.BytesIO(tts)) as w:
            assert w.getframerate() == pipe.cfg.audio.sample_rate
            assert w.readframes(w.getnframes()) == pcm16(want_wav)
        assert stream[44:] == want_pcm
        np.testing.assert_array_equal(direct, want_wav)
        assert pcm16(np.concatenate(chunks)) == want_pcm
        assert all(isinstance(o, np.ndarray) for o in [direct, *chunks])
        # two vocodes of /tts, and for each stream its decode chunks and windows
        assert len(seen) > 4 and set(seen) == {(False, False)}, seen

    def test_serve_needs_a_card_unless_cpu(self, monkeypatch):
        import torch

        from sambert_hifigan_tpu_torch import serve

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--port", "0"])

    @staticmethod
    @contextlib.contextmanager
    def _serve_cli(tmp_path, *flags):
        """`python -m sambert_hifigan_tpu_torch.serve --device cpu` at narrow
        widths (a model config) with `flags`: yields its URL once it serves,
        then stops it with SIGINT and holds it to exit 0."""
        import signal
        import subprocess
        import sys
        from pathlib import Path

        repo = Path(__file__).resolve().parent.parent
        small = tmp_path / "model_config.yaml"
        small.write_text(
            "acoustic_model:\n  d_model: 32\n"
            "  encoder: {n_layers: 1, n_heads: 4, d_ff: 64}\n"
            "  decoder: {n_layers: 1, n_heads: 4, d_ff: 64}\n"
            "vocoder:\n  generator: {upsample_initial_channel: 32, resblock_kernel_sizes: [3],"
            " resblock_dilation_sizes: [[1, 3]]}\n")
        proc = subprocess.Popen(
            [sys.executable, "-m", "sambert_hifigan_tpu_torch.serve", "--device", "cpu",
             "--port", "0", "--max-wait-ms", "1", "--config", str(repo / "configs/config.yaml"),
             "--model-config", str(small), *flags],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            lines = []
            while not lines or "serving on" not in lines[-1]:
                line = proc.stdout.readline()
                assert line, "".join(lines)
                lines.append(line)
            yield lines[-1].split()[3]
        finally:
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=60)
        assert proc.returncode == 0

    def test_serve_command_line_on_cpu(self, tmp_path):
        """`python -m sambert_hifigan_tpu_torch.serve --device cpu` (narrow
        widths from a model config) answers /healthz and /tts, and stops on
        SIGINT; without --trace /healthz carries no "trace"."""
        with self._serve_cli(tmp_path) as url:
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
                health = json.loads(resp.read())
            assert health["ok"] is True
            req = urllib.request.Request(f"{url}/tts",
                                         data=json.dumps({"text": "你好"}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = resp.read()
            assert body[:4] == b"RIFF" and len(body) > 44
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
                assert "trace" not in json.loads(resp.read())

    def test_serve_trace_flag_puts_the_trace_in_healthz(self, tmp_path):
        """`serve --trace`: after a /tts and a /tts/stream, /healthz carries
        the batcher's, the stream's and the batch's spans and counters."""
        with self._serve_cli(tmp_path, "--trace") as url:
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
                assert "trace" not in json.loads(resp.read())  # nothing served yet
            for path in ("/tts", "/tts/stream"):
                req = urllib.request.Request(f"{url}{path}",
                                             data=json.dumps({"text": "你好"}).encode())
                with urllib.request.urlopen(req, timeout=120) as resp:
                    assert resp.read()[:4] == b"RIFF"
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
                trace = json.loads(resp.read())["trace"]
        assert {"batcher.queue_wait", "batcher.round", "batch.call", "stream.first_chunk",
                "stream.encode"} <= set(trace["spans"])
        assert trace["spans"]["batcher.queue_wait"]["n"] == 2
        assert trace["counters"]["batch.frames_returned"] > 0
        assert trace["counters"]["stream.frames_returned"] > 0
