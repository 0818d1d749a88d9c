"""TTS HTTP server with dynamic micro-batching, over random weights made from
a seed.

  python -m sambert_hifigan_tpu_torch.serve [--seed 0] [--port 8000] \
      [--max-batch 16] [--max-wait-ms 20] [--warmup] [--device cpu]

Endpoints:
  POST /tts         {"text": "...", "duration_scale": 1.0, "pitch_shift": 0.0,
                     "energy_scale": 1.0}  ->  audio/wav bytes
  POST /tts/stream  same body (+ optional "chunk_frames") -> audio/wav
                    streamed as it is synthesized: the WAV header goes out
                    at once (unknown-length RIFF sizes) and PCM chunks
                    follow as the chunked AR decode produces them
  GET  /healthz     ->  {"ok": true, ...batcher stats}

Concurrent requests that arrive within the micro-batch window are fused into
one `synthesize_batch` call by `serving.DynamicBatcher`.  The HTTP layer is a
stdlib ThreadingHTTPServer: each connection thread blocks on its request
while the batcher's one worker thread drives the card.

Runs on the CUDA card unless --device cpu is given.  The weights are random,
from --seed, as in `inference.py`: loading trained checkpoints
(--acoustic-checkpoint, --vocoder-checkpoint) waits for the port of the
trainers and their CheckpointManager.  Importing this module starts nothing.
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
    return p.parse_args(argv)


def main(argv=None):
    from .config import default_config, load_config
    from .pipeline import build_pipeline_from_random_init
    from .serving import DynamicBatcher

    args = parse_args(argv)
    cfg = load_config(args.config, args.model_config) if args.config else default_config()
    pipe = build_pipeline_from_random_init(cfg, seed=args.seed, device=args.device)
    print(f"[serve] random weights (seed {args.seed}) on {pipe.device}", flush=True)
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
