"""Capture a torch.profiler trace of any hot surface.

  python -m sambert_hifigan_tpu_torch.profiling --surface e2e --output outputs/profile
  python -m sambert_hifigan_tpu_torch.profiling --surface train-vocoder --reps 3 --top-ops 20
  python -m sambert_hifigan_tpu_torch.profiling --surface decode --tiny --device cpu --reps 1

The counterpart of the JAX package's `scripts/profile.py` (this module is
not named `profile`: a module of that name on `sys.path` shadows the
standard library's, which `torch._dynamo` imports through cProfile).

Surfaces:
  e2e        text -> wav (`text_to_mel`, then `vocode`; default)
  decode     text -> mel (the AR decode path: K1 on the card)
  vocoder    mel -> wav (the generator: K2 on the card)
             (these three on the bf16 pipeline, as the JAX script profiles
             its `dtype=jnp.bfloat16` one)
  train-acoustic / train-vocoder   one train step on a synthetic batch
             (bf16 recipe; B = --batch, 48 phonemes x 384 frames, or
             32-frame adv_mel_fm segments)

Each surface is called twice before the capture starts, so the capture shows
steady-state work, not kernel builds or first-call allocation; then --reps
calls are timed without the profiler, whose tracing slows every launch: the
device's idle share is its busy time in the capture (the union of the
kernels' intervals) against that wall time.  The capture
records CPU operators and, on the card, CUDA kernels over `--reps` calls
ending in `torch.cuda.synchronize()`, and writes `trace.json.gz` in Chrome's
trace format, which Perfetto (ui.perfetto.dev) and chrome://tracing load
as they are (so the JAX script's `--perfetto` has no counterpart here).
`--top-ops N` ranks the kernels by total device time; on the CPU it ranks
CPU operators by self time and reports no device time.  `--tiny` shrinks
both models (a quick check of the capture path).  Runs on the CUDA card
unless --device cpu is given.

The program's own spans (`tracing.py`: on while the profiler runs, on
every thread, the batcher's worker included, whose host work the profiler
does not see) share the profiler's clock.  `export` writes them into the
trace, one track per thread beside the profiler's (a request's queue wait
as an async slice of its own); `summarize` labels the longest idle gaps of
the device with the innermost program span over each gap's middle, else
the host operator running then.

The readers here (`capture`, `kernel_events`, `busy_ms`, `summarize`,
`profile_step`, `program_spans`, `export`) are shared with
`bench_encode_split` and `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Callable, List, Tuple

SURFACES = ("e2e", "decode", "vocoder", "train-acoustic", "train-vocoder")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--surface", choices=SURFACES, default="e2e")
    p.add_argument("--output", type=str, default="outputs/profile")
    p.add_argument("--reps", type=int, default=5, help="iterations captured inside the trace")
    p.add_argument("--text", type=str, default="今天天气真好我们一起去公园散步吧")
    p.add_argument("--max-frames", type=int, default=512)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="shrink model configs (a quick check of the capture path)")
    p.add_argument("--top-ops", type=int, default=0, metavar="N",
                   help="print the N kernels with the largest total device time (on the "
                        "CPU: the N operators with the largest self time)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def tiny_config(cfg):
    """The JAX script's --tiny shapes: d_model 32, one encoder and one
    decoder layer of 4 heads, FFN 64; a 32-channel generator with one
    ResBlock of dilations (1, 3); discriminators at 1/16 width.  The
    decoder keeps its default positional capacity: the JAX script's 128
    frames cannot hold the train surface's 384-frame batch (a shape error
    there) or a 512-frame decode (JAX clamps the index)."""
    from .config import (AcousticModelConfig, DecoderConfig, DiscriminatorConfig,
                         EncoderConfig, GeneratorConfig, VocoderConfig)

    return dataclasses.replace(
        cfg,
        acoustic_model=AcousticModelConfig(
            d_model=32, encoder=EncoderConfig(n_layers=1, n_heads=4, d_ff=64),
            decoder=DecoderConfig(n_layers=1, n_heads=4, d_ff=64)),
        vocoder=VocoderConfig(
            generator=GeneratorConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                      resblock_dilation_sizes=((1, 3),)),
            discriminator=DiscriminatorConfig(channel_div=16)),
    )


def build_surface(args, device) -> Tuple[Callable, Callable]:
    """(fn, sync): fn() enqueues one iteration, sync(out) waits for its
    result and returns a float of it."""
    import numpy as np
    import torch

    from .config import default_config

    cfg = default_config()
    if args.tiny:
        cfg = tiny_config(cfg)

    if args.surface in ("e2e", "decode", "vocoder"):
        from .pipeline import build_pipeline_from_random_init

        pipe = build_pipeline_from_random_init(cfg, seed=args.seed, device=device,
                                               dtype=torch.bfloat16)

        def text_to_mel():
            return pipe.text_to_mel([args.text], max_frames=args.max_frames).mel_pred

        if args.surface == "e2e":
            fn = lambda: pipe.vocode(text_to_mel())  # noqa: E731
        elif args.surface == "decode":
            fn = text_to_mel
        else:
            mel = text_to_mel()
            fn = lambda: pipe.vocode(mel)  # noqa: E731
        return fn, lambda out: float(out.float().sum())

    if args.surface == "train-acoustic":
        from .data.dataset import batch_to_device, synthetic_batch
        from .training.acoustic_trainer import init_acoustic_state, make_acoustic_step
        from .weights import random_acoustic_model

        model = random_acoustic_model(cfg, torch.Generator().manual_seed(args.seed))
        state = init_acoustic_state(model.to(device), cfg)
        batch = batch_to_device(synthetic_batch(cfg, args.batch, 48, 384), device)
        step = make_acoustic_step(cfg)
        rng = torch.Generator().manual_seed(1)
        return (lambda: step(state, batch, rng)), lambda m: float(next(iter(m.values())))

    # train-vocoder
    from .training.vocoder_trainer import init_vocoder_state, make_vocoder_step

    state = init_vocoder_state(cfg, torch.Generator().manual_seed(args.seed), device)
    rng = np.random.default_rng(args.seed)
    n_mels, hop = cfg.audio.n_mels, cfg.audio.hop_length
    mel = torch.tensor(rng.standard_normal((args.batch, n_mels, 32)), dtype=torch.float32,
                       device=device)
    wav = torch.tensor(rng.standard_normal((args.batch, 1, 32 * hop)) * 0.1,
                       dtype=torch.float32, device=device)
    step = make_vocoder_step(cfg, loss_mode="adv_mel_fm")
    return (lambda: step(state, mel, wav)), lambda m: float(next(iter(m.values())))


# ---- reading a capture ----------------------------------------------------------


def capture(fn: Callable, reps: int = 1, sync: Callable = None, cuda: bool = True):
    """fn() `reps` times under torch.profiler (CPU operators and, with
    `cuda`, CUDA kernels), ending in sync(last output) and a device
    synchronize -> (the profiler, the window's wall ms on the host clock,
    the last sync value).  The profiler's own tracing adds to the wall
    time of every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn()
        value = sync(out) if sync is not None else None
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms, value


def kernel_events(prof) -> List:
    """The device events of a capture (kernels, copies, sets), without the
    ranges of user annotations, which are not kernels."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_ms(events) -> float:
    """The device's busy time over `events`: the union of their intervals
    (kernels on other streams overlap; a sum would count that twice)."""
    total, end = 0.0, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def ranked_kernels(events, n: int) -> List[Tuple[str, float, int]]:
    """The n kernel names with the largest total device time, as (name,
    ms, calls)."""
    by_name = {}
    for e in events:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return [(name, ms, calls) for name, (ms, calls) in ranked[:n]]


def ranked_cpu_ops(prof, n: int) -> List[Tuple[str, float, int]]:
    """The n CPU operators with the largest self time, as (name, ms, calls)."""
    rows = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)
    return [(k.key, k.self_cpu_time_total / 1e3, k.count) for k in rows[:n]]


def program_spans(prof) -> List[Tuple[float, float, object]]:
    """The program's spans (`tracing.spans()`) that end after the capture
    began, on its axis: (start_us, end_us, span), as `prof.events()` time
    them.  Tracing is on while the profiler runs, so these are the
    capture's, and those recorded since under `tracing.enable`."""
    from . import tracing

    t0 = prof.profiler.kineto_results.trace_start_ns()
    return [((sp.start_ns - t0) / 1e3, (sp.end_ns - t0) / 1e3, sp) for sp in tracing.spans()
            if sp.end_ns >= t0]


def idle_gaps(prof, n: int = 10) -> List[Tuple[str, float]]:
    """The n longest stretches between the device's merged busy intervals,
    longest first, as (label, ms): the innermost program span over the
    gap's middle (a thread's own span before a request's wait), else the
    innermost host operator over it, else "after" the last one begun."""
    import torch

    merged = []
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in kernel_events(prof)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((a[1], b[0]) for a, b in zip(merged, merged[1:])), key=lambda g: g[0] - g[1])
    spans = program_spans(prof)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) / 2
        over = [(sp.leg, t - u, sp.name) for u, t, sp in spans if u <= mid <= t]
        label = min(over)[2] if over else None
        if label is None:
            ops = [(t - u, name) for u, t, name in host if u <= mid <= t]
            before = [(u, name) for u, t, name in host if u <= mid]
            label = (min(ops)[1] if ops else f"after {max(before)[1]}" if before else "host")
        out.append((label, (e - s) / 1e3))
    return out


def export(prof, path) -> None:
    """`prof`'s Chrome trace at `path` (gzipped where it ends in .gz) with
    the program's spans of its window merged in: on their thread's track
    (named where the profiler saw no work of that thread), a request's
    queue wait as an async slice."""
    import gzip
    import json
    import os

    from . import tracing

    path = str(path)
    raw = path + ".profiler.json"
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        trace = json.load(f)
    os.remove(raw)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    named = {e.get("tid") for e in events if e.get("name") == "thread_name"}
    threads = set()
    for _, _, sp in program_spans(prof):
        ts, args = (sp.start_ns - base) / 1e3, {"req": sp.req, "id": sp.id, "parent": sp.parent,
                                                "device_ms": sp.device_ms}
        if sp.leg:
            common = dict(name=sp.name, cat="program", id=sp.id, pid=pid, tid=sp.thread)
            events += [dict(common, ph="b", ts=ts, args=args),
                       dict(common, ph="e", ts=(sp.end_ns - base) / 1e3)]
            continue
        threads.add(sp.thread)
        events.append(dict(ph="X", name=sp.name, cat="program", ts=ts,
                           dur=(sp.end_ns - sp.start_ns) / 1e3, pid=pid, tid=sp.thread,
                           args=args))
    names = tracing.thread_names()
    events += [dict(ph="M", name="thread_name", pid=pid, tid=t,
                    args={"name": f"{names.get(t, 'thread')} {t}"})
               for t in sorted(threads - named)]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(trace, f)


def summarize(prof, wall_ms: float, n: int = 10, calls: int = 1) -> dict:
    """A capture's device time per call: the summed kernel ms, the busy ms
    (union of intervals), the kernel count, the n kernels that took most,
    the window's wall ms and the device's idle share of it, and the n
    longest idle gaps labelled (`idle_gaps`, not per call)."""
    kernels = kernel_events(prof)
    busy = busy_ms(kernels)
    return dict(device_ms=sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls,
                busy_ms=busy / calls, kernels=len(kernels) // calls, wall_ms=wall_ms / calls,
                idle_share=1.0 - busy / wall_ms if wall_ms > 0 else None,
                top=[(name[:90], ms / calls, c) for name, ms, c in ranked_kernels(kernels, n)],
                idle_gaps=idle_gaps(prof, n))


def profile_step(fn: Callable, n: int = 10) -> dict:
    """Device time of one call of fn, under the profiler (`summarize`)."""
    prof, wall_ms, _ = capture(fn)
    return summarize(prof, wall_ms, n)


def print_top_ops(prof, n: int, cuda: bool) -> List[Tuple[str, float, int]]:
    rows = ranked_kernels(kernel_events(prof), n) if cuda else ranked_cpu_ops(prof, n)
    what = "kernels by total device time" if cuda else "CPU operators by self time (no device)"
    width = max((len(k) for k, _, _ in rows), default=10)
    print(f"\ntop {len(rows)} {what}:")
    for name, ms, count in rows:
        print(f"  {name:<{width}}  {ms:9.3f} ms  x{count}")
    return rows


def main(argv=None) -> dict:
    import torch

    from .kernels import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"device: {device} ({name})", file=sys.stderr)
    fn, sync = build_surface(args, device)
    sync(fn())  # kernel builds and first calls, outside the capture
    sync(fn())
    # the same calls without the profiler, whose tracing adds to every launch
    t0 = time.perf_counter()
    out = None
    for _ in range(args.reps):
        out = fn()
    sync(out)
    if cuda:
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    prof, wall_ms, _ = capture(fn, args.reps, sync, cuda)
    trace = out_dir / "trace.json.gz"
    export(prof, trace)
    print(f"trace written to {trace} ({args.reps} reps of {args.surface}, "
          f"{wall_ms:.1f} ms wall under the profiler, {plain_ms:.1f} ms without)")
    print("view: ui.perfetto.dev or chrome://tracing (load the file as it is)")
    result = dict(surface=args.surface, reps=args.reps, trace=str(trace),
                  wall_ms=plain_ms / args.reps, profiled_wall_ms=wall_ms / args.reps,
                  device=name)
    if cuda:  # busy time from the capture, against the wall time without the profiler
        result.update(summarize(prof, plain_ms, args.top_ops or 10, args.reps))
        print(f"device: {result['busy_ms']:.3f} ms busy of {result['wall_ms']:.3f} ms wall "
              f"per call ({result['profiled_wall_ms']:.3f} under the profiler), idle share "
              f"{result['idle_share']:.3f}, {result['kernels']} kernels")
    if args.top_ops:
        result["top_ops"] = print_top_ops(prof, args.top_ops, cuda)
    return result


if __name__ == "__main__":
    main()
