"""Closed loop of one-shot calls: `TTSPipeline.synthesize_batch` of the
mix's batches back to back, in whole cycles, for at least the run's
seconds; over several cards one pipeline splits each call over them."""

from __future__ import annotations

import gc
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

MAX_CYCLES = 32  # a 50-s window runs 8 on an H100


def _fault(ctx: Context, wavs):
    """The planted fault, for the tests and the calibration: every answer
    altered where it is made (one sample of each row moved by 0.01)."""
    if ctx.fault == "answer_altered":
        wavs = [w.copy() for w in wavs]
        for w in wavs:
            w[len(w) // 2] += 0.01
    elif ctx.fault is not None:
        raise ValueError(f"fault {ctx.fault!r} does not apply to one-shot calls")
    return wavs


def run(cell, seed: int, seconds: float, trace: bool, ctx: Context) -> Run:
    c, tr = cell.config, cell.traffic
    out = Run(c, tr, cell.chips)
    model = model_of(cell)
    cfg = model.config(c)
    devs = devices_for(ctx, cell.chips)
    if devs[0].type == "cuda":
        port.build_kernels()
    W = model.weights(c, cfg, seed, devs[0])
    pipe = model.pipeline(cfg, W, devs, dtype_of(c))
    cycles = traffic.batch_cycles(tr, seed, MAX_CYCLES, cell.laws_dir)
    hop, sr = c["hop_length"], c["sample_rate"]

    def tph(texts):
        return frontend.pick_bucket(max(frontend.phoneme_count(t) for t in texts),
                                    c["phoneme_buckets"])

    seen = {}
    for texts in cycles[0]:
        seen.setdefault(tph(texts), texts)
    for texts in seen.values():  # every bucket of the mix, once
        pipe.synthesize_batch(texts)
    sync(devs)
    for d in devs:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)

    results = []  # (cycle, index, texts, wavs)
    seconds_of = {}
    ctx.setup_done()
    t0 = time.perf_counter()
    n_cycles = 0
    for k, cyc in enumerate(cycles):
        for j, texts in enumerate(cyc):
            out.attempted += len(texts)
            t_call = time.perf_counter()
            try:
                wavs = _fault(ctx, pipe.synthesize_batch(texts))
            except Exception as e:  # noqa: BLE001 -- a failed call is counted, not fatal
                log(f"call {k}.{j} failed: {e!r}")
                out.failed += len(texts)
                continue
            results.append((k, j, texts, wavs))
            seconds_of[(k, j)] = time.perf_counter() - t_call
        n_cycles += 1
        if time.perf_counter() - t0 >= seconds:
            break
    out.window_s = time.perf_counter() - t0
    audio = sum(len(w) for *_, wavs in results for w in wavs) / sr
    out.e2e["audio_s_per_s"] = audio / out.window_s
    out.calls = [[(frontend.phoneme_count(t), len(w) // hop) for t, w in zip(texts, wavs)]
                 for _, _, texts, wavs in results]
    for k, j, texts, wavs in results[:len(cycles[0])]:
        frames = sum(len(w) // hop for w in wavs)
        bucket = frontend.initial_frames(tph(texts), c)
        log(f"call {k}.{j}: {len(texts)} texts, phoneme bucket {tph(texts)}, frame bucket "
            f"{bucket}, {frames} frames returned, fill {frames / (len(texts) * bucket):.4f}, "
            f"{seconds_of[(k, j)]:.4f} s")
    log(f"window: {n_cycles} cycles, {len(results)} calls, {audio:.3f} s of audio in "
        f"{out.window_s:.3f} s")

    if trace:
        def one_cycle():
            for texts in cycles[0]:
                pipe.synthesize_batch(texts)
            sync(devs)
        out.trace = capture(one_cycle, len(devs))
        out.traced_wall_s = out.window_s / n_cycles
        out.traced_calls = out.calls[:len(cycles[0])]
    out.memory_peak_bytes = peak_bytes(devs)
    out.notes["launches"] = port.launches()

    del pipe
    gc.collect()
    if devs[0].type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check(out, results, model, W, c, tr, seed, devs[0], "f32")
    log(f"set-up {ctx.setup_s:.3f} s, the comparison {time.perf_counter() - t_check:.3f} s")
    return out


def sample(results, n: int, seed: int):
    """`n` calls drawn from the seed, the one holding the longest text
    among them."""
    longest = max(range(len(results)), key=lambda i: max(len(t) for t in results[i][2]))
    rest = [i for i in range(len(results)) if i != longest]
    rng = np.random.default_rng(seed)
    return [longest] + [int(i) for i in rng.choice(rest, min(n - 1, len(rest)), replace=False)]


def check(out: Run, results, model, W, c, tr, seed, device, precision: str) -> None:
    """Compare the sampled calls' rows with the model's reference over the
    weights `W` in `precision`: every row's length exactly, and the widest
    gap of any sample.  The worst row's relative error with each wav's
    mean taken out (random weights give a wav that is mostly a constant
    offset) is printed, not compared: the fp8 control reads under three
    times sound runs on it (PERF.md)."""
    q = rounder(precision)
    mismatched, widest, worst = (0, 0.0, 0.0) if results else (1, 0.0, 0.0)
    with ieee_f32():
        for i in sample(results, tr["check_calls"], seed) if results else []:
            texts, wavs = results[i][2], results[i][3]
            want = model.reference_batch(W, c, texts, q, device)
            m, w, r = wav_gaps(wavs, want)
            mismatched, widest, worst = mismatched + m, max(widest, w), max(worst, r)
    out.checks["length_mismatch"] = float(mismatched)
    out.checks["wav_max_abs_err"] = widest
    out.notes["wav_ac_rel_err"] = worst
