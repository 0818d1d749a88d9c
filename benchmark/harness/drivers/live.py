"""Open loop of live streams: each arrival, at its due time, opens
`DynamicBatcher.synthesize_stream` on a client thread of its own and reads
the stream to its end.  The time to first audio runs from the due time to
the first chunk in the client's hands; a stream that fails or times out
counts as missing."""

from __future__ import annotations

import gc
import math
import threading
import time

import numpy as np
import torch

from reference import frontend
from reference.acoustic import wav_gaps
from reference.precision import ieee_f32, rounder

from .. import port, traffic
from ..common import devices_for, dtype_of, peak_bytes, sync
from ..record import Context, Run, log
from ..spec import model_of
from ..trace import capture

DRAIN_S = 60.0  # how long past the last arrival a stream may still finish
MISSING_MS = DRAIN_S * 1e3  # the time to first audio a missing stream counts as


def _open_loop(batcher, arrivals, tr, ctx: Context, samples=None):
    """Run the arrivals from now -> ([(ttfa seconds or None, chunks)], the
    latest any submission ran, the wall seconds until every stream ended)."""
    n = len(arrivals)
    results = [(None, [])] * n
    threads = []

    def client(i: int, due: float, text: str) -> None:
        chunks, first = [], None
        try:
            for chunk in batcher.synthesize_stream(text, tr["chunk_frames"], tr["context_frames"],
                                                   timeout=DRAIN_S):
                if first is None:
                    first = time.perf_counter()
                chunks.append(chunk)
            if ctx.fault == "answer_altered" and chunks:  # one sample of every stream
                chunks[0] = chunks[0].copy()
                chunks[0][len(chunks[0]) // 2] += 0.01
            results[i] = (first - due, chunks)
        except Exception as e:  # noqa: BLE001 -- a failed stream is counted as missing
            log(f"stream {i} failed: {e!r}")

    t0 = time.perf_counter()
    late = 0.0
    for i, (due, text) in enumerate(arrivals):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - (t0 + due))
        if samples is not None:
            samples.append(batcher.stats()["active_streams"])
        th = threading.Thread(target=client, args=(i, t0 + due, text), daemon=True)
        th.start()
        threads.append(th)
    deadline = time.perf_counter() + DRAIN_S
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    return results, late, time.perf_counter() - t0


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, ctx: Context) -> Run:
    c, tr = cell.config, cell.traffic
    out = Run(c, tr, cell.chips)
    model = model_of(cell)
    cfg = model.config(c)
    devs = devices_for(ctx, 1)
    if devs[0].type == "cuda":
        port.build_kernels()
    W = model.weights(c, cfg, seed, devs[0])
    pipe = model.pipeline(cfg, W, devs, dtype_of(c))
    batcher = port.batcher(pipe, tr["max_batch"], tr["max_wait_ms"])
    arrivals = traffic.arrivals(tr, seed, seconds, cell.laws_dir)
    warm = {}
    for _, text in arrivals:  # every bucket a stream of the mix meets, once
        warm.setdefault(frontend.pick_bucket(frontend.phoneme_count(text),
                                             c["phoneme_buckets"]), text)
    for text in warm.values():
        for _ in batcher.synthesize_stream(text, tr["chunk_frames"], tr["context_frames"]):
            pass
    sync(devs)
    if devs[0].type == "cuda":
        torch.cuda.reset_peak_memory_stats(devs[0])

    ctx.setup_done()
    samples = []
    results, late, wall = _open_loop(batcher, arrivals, tr, ctx, samples)
    out.window_s = wall
    out.attempted = len(arrivals)
    out.failed = sum(1 for ttfa, _ in results if ttfa is None)
    ttfa_ms = [MISSING_MS if t is None else t * 1e3 for t, _ in results]
    out.e2e["ttfa_p95_ms"] = p95(ttfa_ms)
    out.samples["active_streams"] = samples
    log(f"window: {len(arrivals)} streams over {arrivals[-1][0]:.3f} s, all ended after "
        f"{wall:.3f} s; submissions at most {late * 1e3:.3f} ms late; time to first audio "
        f"median {float(np.median(ttfa_ms)):.3f} ms, p95 {out.e2e['ttfa_p95_ms']:.3f} ms, "
        f"max {max(ttfa_ms):.3f} ms; {out.failed} failed")

    if trace:
        stretch = [a for a in arrivals if a[0] < tr["trace_seconds"]]
        walls = []

        def traced():
            walls.append(_open_loop(batcher, stretch, tr, Context(ctx.device))[2])
            sync(devs)
        out.trace = capture(traced, 1)
        out.traced_wall_s = walls[0]
    out.memory_peak_bytes = peak_bytes(devs)
    stats = batcher.stats()
    batcher.close()
    out.notes.update(stats=stats, launches=port.launches())
    del batcher, pipe
    gc.collect()
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check(out, arrivals, results, model, W, c, tr, seed, devs[0], "f32")
    log(f"set-up {ctx.setup_s:.3f} s, the comparison {time.perf_counter() - t_check:.3f} s")
    return out


def picks(arrivals, done, n: int, seed: int):
    """The streams a run compares: `n` of the finished ones drawn from the
    seed, the one of the longest text among them."""
    longest = max(done, key=lambda i: len(arrivals[i][1]))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng(seed)
    return [longest] + [int(i) for i in rng.choice(rest, min(n - 1, len(rest)), replace=False)]


def check(out: Run, arrivals, results, model, W, c, tr, seed, device, precision) -> None:
    """Compare a sample of the finished streams chunk by chunk with the
    model's reference stream over the weights `W` in `precision`: every
    chunk's length exactly, and the widest gap of any sample, each stream's
    chunks joined (as the one-shot cells do; the content's relative error
    is printed)."""
    done = [i for i, (t, _) in enumerate(results) if t is not None]
    mismatched, widest, worst = (0, 0.0, 0.0) if done else (1, 0.0, 0.0)
    if done:
        chosen = picks(arrivals, done, tr["check_streams"], seed)
        with ieee_f32():
            want = model.reference_stream(W, c, [arrivals[i][1] for i in chosen],
                                          tr["chunk_frames"], tr["context_frames"],
                                          rounder(precision), device)
        for i, w in zip(chosen, want):
            got = results[i][1]
            if [len(x) for x in got] != [len(x) for x in w]:
                mismatched += 1
                continue
            m, g, r = wav_gaps([np.concatenate(got)], [np.concatenate(w)])
            mismatched, widest, worst = mismatched + m, max(widest, g), max(worst, r)
    out.checks["length_mismatch"] = float(mismatched)
    out.checks["wav_max_abs_err"] = widest
    out.notes["wav_ac_rel_err"] = worst
