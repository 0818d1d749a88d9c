"""TTS HTTP server with dynamic micro-batching.

  python -m sambert_hifigan_tpu_torch.serve [--acoustic-checkpoint checkpoints/acoustic] \
      [--vocoder-checkpoint checkpoints/vocoder] [--seed 0] [--port 8000] \
      [--max-batch 16] [--max-wait-ms 20] [--warmup] [--device cpu] [--trace]

Endpoints:
  POST /tts         {"text": "...", "duration_scale": 1.0, "pitch_shift": 0.0,
                     "energy_scale": 1.0}  ->  audio/wav bytes
  POST /tts/stream  same body (+ optional "chunk_frames") -> audio/wav
                    streamed as it is synthesized: the WAV header goes out
                    at once (unknown-length RIFF sizes) and PCM chunks
                    follow as the chunked AR decode produces them
  GET  /healthz     ->  {"ok": true, ...batcher stats, "trace": {...} with --trace}

Concurrent requests that arrive within the micro-batch window are fused into
one `synthesize_batch` call by `serving.DynamicBatcher`.  The HTTP layer is a
stdlib ThreadingHTTPServer: each connection thread blocks on its request
while the batcher's one worker thread drives the card.

--trace turns on the serving path's spans and counters (`tracing.py`) for
the server's life; /healthz then carries `tracing.snapshot()` under
"trace": per span name its count, total, mean, p50 and p95 ms and self
time ("spans"), the device time of the device spans ("device"), and the
counters ("counters"), over the last 100,000 spans.  The spans:

  batcher.queue_wait   a request's put to the worker's pop
  batcher.round        one pass of the worker's loop that had work
  stream.first_chunk   a stream's pop to its first chunk in the client's queue
  stream.chunk         each later chunk
  stream.frontend, stream.encode (device too), stream.decode (device too,
  each K1 chunk), stream.vocode (device too, each window), stream.fetch
                       the parts of a stream's chunks
  batch.call           one synthesize_batch (a fused /tts batch), with
  batch.frontend, batch.dispatch, batch.acoustic (device too),
  batch.vocode (device too), batch.fetch

and the counters batcher.rounds, batcher.admitted, stream.k1_steps,
stream.frames_returned, stream.overflow_restarts, batch.overflow_reruns,
batch.rows_padded, batch.frames_decoded and batch.frames_returned.
Without --trace nothing is recorded (one flag read at each boundary).

Runs on the CUDA card unless --device cpu is given.  The checkpoints are the
training directories of `train_acoustic` and `train_vocoder` (the latest
step, its EMA copy where it has one), as in `inference.py`; a model
without one has random weights made from --seed.  Importing this module
starts nothing.
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16(wav))
    return buf.getvalue()


def pcm16(wav: np.ndarray) -> bytes:
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_stream_header(sample_rate: int) -> bytes:
    """RIFF/WAVE header with unknown-length sizes (0xFFFFFFFF), the standard
    convention for live-streamed WAV: players and decoders read PCM until
    the connection closes."""
    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


def make_handler(batcher, sample_rate: int, request_timeout: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **batcher.stats()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/tts", "/tts/stream"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
                if not isinstance(text, str):
                    raise TypeError("'text' must be a string")
                controls = {
                    k: float(req.get(k, dflt))
                    for k, dflt in (("duration_scale", 1.0),
                                    ("pitch_shift", 0.0),
                                    ("energy_scale", 1.0))
                }
            # TypeError covers non-dict JSON bodies ('"x"'.__getitem__) and
            # non-numeric controls ({"pitch_shift": [1]}) — without it the
            # handler dies responseless and the client sees a reset socket
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            if self.path == "/tts/stream":
                self._stream(req, text, controls)
                return
            try:
                wav = batcher.synthesize(text, **controls, timeout=request_timeout)
            except TimeoutError:
                self._json(503, {"error": "request timed out in queue"})
                return
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(500, {"error": repr(e)})
                return
            body = wav_bytes(wav, sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, req: dict, text: str, controls: dict):
            """Incremental response: headers + WAV header at once, then one
            PCM write per synthesized chunk.  An error before any audio
            exists (frontend, encoder) becomes a JSON 500; once audio bytes
            have been sent the connection simply closes."""
            try:
                chunk_frames = int(req.get("chunk_frames", 32))
            except (ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            chunks = batcher.synthesize_stream(
                text, chunk_frames=chunk_frames, **controls, timeout=request_timeout,
            )
            try:
                first = next(chunks, None)
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(500, {"error": repr(e)})
                return
            # body length is unknown until synthesis ends: no Content-Length,
            # the response ends when the connection closes (HTTP/1.1 allows
            # this for close-delimited messages)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            try:
                self.wfile.write(wav_stream_header(sample_rate))
                if first is not None:
                    self.wfile.write(pcm16(first))
                    self.wfile.flush()
                for chunk in chunks:
                    self.wfile.write(pcm16(chunk))
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up; drain is the generator's problem
            except Exception:  # noqa: BLE001 — mid-stream: can only close
                pass

    return Handler


class Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 overflows under a burst of concurrent
    # connections (the batcher's whole point): clients would see resets
    request_queue_size = 128
    daemon_threads = True


def make_server(batcher, host: str, port: int, sample_rate: int,
                request_timeout: float = 120.0) -> Server:
    """An HTTP server over `batcher`, bound but not yet serving (port 0
    picks a free port: `server.server_address[1]`)."""
    return Server((host, port), make_handler(batcher, sample_rate, request_timeout))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--acoustic-checkpoint", type=str, default=None)
    p.add_argument("--vocoder-checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=20.0)
    p.add_argument("--request-timeout", type=float, default=120.0)
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run every bucket before accepting traffic")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    p.add_argument("--trace", action="store_true",
                   help="record the serving path's spans and counters; /healthz carries them")
    return p.parse_args(argv)


def main(argv=None):
    from . import tracing
    from .config import default_config, load_config
    from .pipeline import build_pipeline
    from .serving import DynamicBatcher

    args = parse_args(argv)
    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    pipe = build_pipeline(cfg, args.seed, args.device, args.acoustic_checkpoint,
                          args.vocoder_checkpoint)
    print(f"[serve] acoustic: {args.acoustic_checkpoint or f'random (seed {args.seed})'}, "
          f"vocoder: {args.vocoder_checkpoint or f'random (seed {args.seed})'}, "
          f"on {pipe.device}", flush=True)
    if args.warmup:
        print("[serve] warmup: kernels, bucket grid, streaming, batch sizes...", flush=True)
        pipe.warmup(streaming=True, batch_buckets=True)
        if args.max_batch > max(cfg.runtime.batch_buckets):
            pipe.synthesize_batch(["warmup"] * args.max_batch)
        print("[serve] warmup: done", flush=True)
    batcher = DynamicBatcher(pipe, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    if args.warmup:
        # the worker thread's own first calls cost more than later ones
        # (per-thread set-up in the libraries under torch): pay them here
        batcher.synthesize("warmup")
        for _ in batcher.synthesize_stream("warmup"):
            pass
    server = make_server(batcher, args.host, args.port, cfg.audio.sample_rate,
                         args.request_timeout)
    tracing.enable(args.trace)  # after the warm-up, so only served requests are recorded
    print(f"[serve] serving on http://{args.host}:{server.server_address[1]}  "
          f"(max_batch={args.max_batch}, wait={args.max_wait_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
