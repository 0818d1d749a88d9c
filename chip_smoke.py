#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `sambert_hifigan_tpu_torch/csrc`,
holds each kernel against its plain PyTorch version at the full default
width (K1 at B = 1, 4 and 16, at B = 16 over the largest frame bucket, which
takes two clusters, and at the main path's own shape: the texts' frame bucket
and each row's valid frames, from the pipeline; K2 also on a 5-frame
utterance, shorter than its halo), reports each K2 stage's TFLOP/s and share
of its bound and K1's per-step stream bound, then drives the one-shot text ->
wav path (`synthesize_batch`, `synthesize`) of a pipeline with random
weights made from a seed, and checks that every kernel of that path launched.
Phase 5 holds K1 launched chunk by chunk from its carry bit for bit against
the one-shot launch, then drives `stream` (time to first audio, ms per
chunk, RTF) and checks its wav and its launches; phase 6 serves the pipeline
through the port's HTTP entry point and `DynamicBatcher` (4 concurrent
`/tts`, one `/tts/stream`, `/healthz`).  Phase 7 trains the full-width
vocoder (bf16, adv_mel_fm, B = 16 segments of 32 frames: 2 warm-up and 10
timed steps, the device ms of each part of a step), holds one small f32
step on the card against the CPU, round-trips a checkpoint, and vocodes
through K2 with the trained generator.  Phase 8 trains the full-width
acoustic model (bf16, B = 16, 64 phonemes, a 512-frame bucket: 2 warm-up
and 10 timed steps, the device ms of forward, backward and optimizer, a
profiler ranking, peak memory), holds one small f32 step on the card
against the CPU, round-trips a checkpoint (a background save included),
runs the trained decoder through K1 against its plain version and
`synthesize_batch` with the trained model, then runs `train_acoustic
--synthetic 2` on the card and `inference --acoustic-checkpoint` on what it
wrote.  Phase 9 runs the data pipeline on the card: a toy corpus of 64
utterances (`make_toy_dataset`), every wav through the native decoder
bit-equal to the numpy reader, `TTSDataset` features on the card (cold and
warm utterances/s; 4 utterances against the CPU), `compute_alignments` (200
aligner steps), `train_acoustic --metadata` at full width (12 steps with
--prefetch on, then off; a profiled step and the device's idle share) and
`train_vocoder --metadata` (6 steps), then `build_pipeline` from the two
checkpoints: `synthesize_batch` of 4 corpus texts through K1 and K2, and
mel-MAE and MCD of a copy synthesis.  Phase 10 trains across processes:
both trainers under `torch.distributed.run --nproc-per-node 1` (nccl), then
`multiprocess_dp` with 2 ranks on the one card (gloo) at full width, the
acoustic model (B = 16, 4 steps) and the vocoder (B = 16, 3 steps) each
against a single-process control on the card with bit-equal replicas, then
the torchrun checkpoints through K1 and K2 and the offline tools
(`copy_synth`, `eval_vocoder_waveform`, `eval_teacher_forced`).  Phase 11
runs the tooling: `profiling` over its five surfaces (top kernels, busy
against wall ms, the device's idle share; K1 and K2 read back from the
exported traces where they run and nowhere else), `bench_encode_split`
(wall and device ms of the encode, the decode and both),
`bench_decode_modes` (K1 against the plain decode, checksums within
phase 2's tolerance), `bench_scaling` at d = 256, 512, 1024, `utils/debug`
on a pipeline tensor, `plot_audio`'s panel arrays on the card against the
CPU, `make_demo_dataset` and `eval_demo_run` through K1 and K2, both demos,
and `dryrun_multichip(2)` over gloo.  Phase 12 trains tensor-parallel
(`--model-parallel`): `multiprocess_dp` with 2 ranks on the one card laid
out as data 1 x model 2, at full width in bf16 (the acoustic model at
phase 8's shape, the vocoder at phase 7's, 3 steps each), bit-equal to a
single-process control, with each rank's persistent state, step and
gather ms and peak memory; both trainers under torchrun `--model-parallel
2` and their checkpoints through K1 and K2; and `dryrun_multichip(4)`,
whose "dp x tp" stage runs data 2 x model 2.  Phase 13 serves data-parallel
over a device list (`TTSPipeline(devices=...)`): the default config at full
width with the main path's weights split over two replicas on the one card
(and over every visible card where there are more), each replica's rows
bit-equal to a direct call on them, one frame bucket for a batch whose last
replica alone overflows, `text_to_mel`, `vocode`, `stream`, `warmup` and a
`DynamicBatcher` over the split pipeline, warm ms against one device, and
the launches of one split call.  Phase 14 runs bf16 inference
(`TTSPipeline(dtype=torch.bfloat16)`, the JAX `dtype=jnp.bfloat16`) on the
main path's weights: `synthesize_batch` and `stream` through K1 and K2
(launches, lengths, the stream against `synthesize`), each wav against the
f32 pipeline's within a bound PERF.md predicted, warm ms of both in turns,
K1 and K2 at the bf16 path's inputs against their plain versions (chained
K1 bit for bit).  Any failed phase
raises and the script exits non-zero.  It imports nothing of JAX.

Output: one line per phase; before the last line, a JSON object with every
kernel's launches, error and times, and the card's name and power limit as
nvidia-smi gives them; last, `{"ok": true, "device": {...}}`.

Times come from CUDA events around repeated launches after a warm-up; bounds
are the larger of the bytes the function must move over the card's memory
rate and its operations over the bf16 tensor-core peak (NVIDIA H100 SXM data
sheet: 3.35 TB/s, 989 TFLOP/s dense; `sambert_hifigan_tpu_torch/flops.py`).
Device busy time and idle shares come from torch.profiler captures
(`sambert_hifigan_tpu_torch/profiling.py`: the union of the kernels'
intervals).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

# phase-2 tolerances of K1 against its plain version, on mels of mean |x| ~1
# (same bf16 rounding points; the orders of the f32 sums differ and the
# autoregressive feedback carries a flipped bf16 rounding on to later frames)
K1_TOL_MEAN, K1_TOL_MAX = 1e-2, 0.1
# K2 against its plain version, on outputs of mean |x| ~0.8: same bf16
# rounding points, f32 sums in another order; a rare flipped bf16 rounding
# of a conv input moves one sample by ~1e-3
K2_TOL_MAX = 5e-3

# streamed against one-shot audio: the JAX package's own bound
# (tests/test_pipeline.py), which tests/test_torch_stream.py holds on the CPU
STREAM_TOL_MAX = 5e-3
CHUNK, CONTEXT = 32, 16

TEXTS = [  # 40-60 characters each: phoneme bucket 64 -> frame bucket 1024
    "今天天气很好我们一起去公园散步然后在湖边的咖啡馆喝一杯咖啡再慢慢走回家吃晚饭",
    "语音合成系统把输入的文字转换成自然流畅的声音广泛用于导航播报和智能助手等场景之中",
    "the quick brown fox jumps over the lazy dog by the river",
    "自回归解码器一帧一帧地生成梅尔频谱然后由声码器把它变成波形输出",
]


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    from sambert_hifigan_tpu_torch.flops import BF16_FLOP_PER_S, HBM_BYTES_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- phase 2: K1 ------------------------------------------------------------

# (name, B, T = S, valid frames of the rows that have padding)
K1_SHAPES = (
    ("B1", 1, 1024, {0: 900}),
    ("B4-T256", 4, 256, {0: 200, 1: 120, 3: 64}),
    ("B4", 4, 1024, {0: 1000, 1: 700, 3: 300}),
    ("B16", 16, 1024, {}),
    ("B16-T2048", 16, 2048, {0: 1500, 5: 700}),  # the largest buckets: two clusters of 8 rows
)


def main_path_shape(pipe):
    """K1's shape on the main path (phase 4): B = len(TEXTS), T = S = the
    texts' frame bucket, and each row's valid memory frames."""
    mask = pipe.text_to_mel(TEXTS).frame_mask
    return ("main-path", mask.shape[0], mask.shape[1], dict(enumerate(mask.sum(dim=1).tolist())))


def k1_inputs(cfg, b: int, t: int, valid, gen, dev):
    import torch

    from sambert_hifigan_tpu_torch.models import ar_decoder as ard
    from sambert_hifigan_tpu_torch.models.layers import init_defaults_
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1

    am = cfg.acoustic_model
    dec = ard.PNCAARDecoder(am.d_model, am.n_mels, am.decoder)
    init_defaults_(dec, gen)
    dec.init_weights_(gen)
    dec = dec.to(dev).eval()
    w = ard.pack_decoder(dec, torch.bfloat16)
    mask = torch.zeros(b, t, dtype=torch.bool)
    for row, n in valid.items():  # rows not named keep every frame
        mask[row, n:] = True
    hvar = torch.randn(b, t, am.d_model, generator=gen) * (~mask)[:, :, None]
    mk, mv = ard.precompute_memory_packed(dec, hvar.to(dev))
    bias = torch.where(mask, k1.NEG_INF, 0.0).float().to(dev).contiguous()
    return w, mk.bfloat16().contiguous(), mv.bfloat16().contiguous(), bias


def k1_memory_rows(bias) -> int:
    """Memory frames the decode needs, summed over rows: the unmasked ones
    (a masked frame adds exactly 0 to every sum), or all of a row's frames
    when it has none (its softmax is uniform)."""
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1

    valid = (bias > k1.MASKED).sum(dim=1)
    return int(sum(n if n else bias.shape[1] for n in valid.tolist()))


def k1_work(w, mk, bias, t: int):
    """(bytes, flops) of one decode: every input it needs read once (the
    memory K/V of the frames the data leaves unmasked), the mel written once;
    dense products per step and row plus the attention over the cache and
    those frames."""
    L, b, s, d = mk.shape
    n_mels = w.mel_w.shape[1]
    weights = nbytes(*w.matrices, *w.vectors) - nbytes(w.pe) + t * d * 4
    rows = k1_memory_rows(bias)
    moved = weights + 2 * L * rows * d * mk.element_size() + b * s * 4 + b * t * n_mels * 4
    params = sum(m.numel() for m in w.matrices)
    attn = L * 4 * d * (b * t * (t + 1) // 2 + t * rows)
    return moved, b * 2 * params * t + attn


def k1_stream_ms(w, mk, bias, t: int) -> float:
    """What a step must read, weights once for all rows plus the needed
    memory K/V and the self-attention caches (t + 1 rows, averaged over the
    steps), over the card's memory rate, for the whole decode: the floor for
    a decode whose weights and K/V come from device memory at every step."""
    from sambert_hifigan_tpu_torch.flops import HBM_BYTES_PER_S

    L, b, s, d = mk.shape
    per_step = (nbytes(*w.matrices) + 2 * L * k1_memory_rows(bias) * d * mk.element_size()
                + 2 * L * b * (t + 1) / 2 * d * mk.element_size())
    return t * per_step / HBM_BYTES_PER_S * 1e3


def phase_k1(cfg, shapes, dev, gen):
    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1

    rows = {}
    for name, b, t, valid in shapes:
        w, mk, mv, bias = k1_inputs(cfg, b, t, valid, gen, dev)
        t0 = time.perf_counter()
        out = k1.ar_decode(w, mk, mv, bias, t)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = k1.ar_decode_plain(w, mk, mv, bias, k1.init_carry(w, b, t), 0, t)[1]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (out - ref).abs()
        finite = bool(torch.isfinite(out).all())
        ms = cuda_ms(lambda: k1.ar_decode(w, mk, mv, bias, t), reps=2)
        moved, flops = k1_work(w, mk, bias, t)
        bms, by = bound_ms(moved, flops)
        plan = k1.launch_plan(b, t, t, mk.shape[0], mk.shape[3], w.n_heads, w.w1.shape[-1],
                              w.mel_w.shape[1], w.pe.shape[0])
        row = dict(shape=name, B=b, T=t, valid=valid, max_abs_err=err.max().item(),
                   mean_abs_err=err.mean().item(), ref_mean_abs=ref.abs().mean().item(), ms=ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   stream_bound_ms=k1_stream_ms(w, mk, bias, t),
                   plan=dict(cluster=plan.cluster, rows=plan.rows, groups=plan.groups,
                             stages=plan.stages, smem=plan.smem),
                   first_call_s=first_s)
        log("[k1]", json.dumps(row))
        if not finite:
            raise AssertionError(f"K1 B={b} T={t}: non-finite output")
        if not (row["mean_abs_err"] < K1_TOL_MEAN and row["max_abs_err"] < K1_TOL_MAX):
            raise AssertionError(f"K1 B={b} T={t} outside tolerance: {row}")
        rows[name] = row
    return rows


# ---- phase 3: K2 ------------------------------------------------------------


def mrf_library(x, w):
    """The same MRF through F.conv1d in bf16 (cuDNN): a yardstick of what the
    library's convolutions take, never called by the port."""
    import torch
    import torch.nn.functional as F

    x0 = x.bfloat16()
    out, n = None, 0
    for k in w.kernel_sizes:
        y = x0
        for d in w.dilations:
            t1 = F.conv1d(F.leaky_relu(y, 0.1), w.weights[n], w.biases[n].bfloat16(),
                          padding=(k * d - d) // 2, dilation=d)
            y = y + F.conv1d(F.leaky_relu(t1, 0.1), w.weights[n + 1],
                             w.biases[n + 1].bfloat16(), padding=(k - 1) // 2)
            n += 2
        out = y if out is None else out + y
    return (out / len(w.kernel_sizes)).to(torch.float32)


def phase_k2(pipe, frames: int, batches, gen, dev, timed: bool = True):
    """K2 against its plain version at every generator stage for `frames`
    mel frames; with `timed`, also the kernel's, the plain version's and the
    library's times, the achieved TFLOP/s and the share of the bound."""
    import torch

    from sambert_hifigan_tpu_torch.ops import mrf as k2

    gcfg = pipe.cfg.vocoder.generator
    rows = {}
    t = frames
    for i, w in enumerate(pipe.mrf_weights):
        c = gcfg.upsample_initial_channel // (2 ** (i + 1))
        t *= gcfg.upsample_rates[i]
        for b in batches:
            x = torch.randn(b, c, t, generator=gen).to(dev)
            out = k2.mrf(x, w)
            ref = k2.mrf_plain(x, w)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            edge = torch.cat([err[..., :64], err[..., -64:]], dim=-1)
            row = dict(stage=i, C=c, B=b, T=t, max_abs_err=err.max().item(),
                       mean_abs_err=err.mean().item(), edge_max_abs_err=edge.max().item(),
                       ref_mean_abs=ref.abs().mean().item())
            if timed:
                ms = cuda_ms(lambda: k2.mrf(x, w), reps=3)
                flops = 2 * sum(2 * len(w.dilations) * k for k in w.kernel_sizes) * c * c * t * b
                bms, by = bound_ms(2 * nbytes(x) + nbytes(w.packed, w.biases), flops)
                row.update(ms=ms, plain_ms=cuda_ms(lambda: k2.mrf_plain(x, w), reps=2),
                           library_ms=cuda_ms(lambda: mrf_library(x, w), reps=3),
                           bound_ms=bms, bound_by=by, tflops=flops / ms * 1e-9,
                           share_of_bound=bms / ms)
            log("[k2]", json.dumps(row))
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"K2 stage {i} B={b} T={t}: non-finite output")
            if not (row["max_abs_err"] < K2_TOL_MAX and row["edge_max_abs_err"] < K2_TOL_MAX):
                raise AssertionError(f"K2 stage {i} B={b} T={t} outside tolerance: {row}")
            rows[(i, b)] = row
    return rows


# ---- phase 4: the pipeline --------------------------------------------------


def phase_pipeline(pipe):
    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.text.frontend import pick_bucket

    tph, _ = pipe._frontend_args(TEXTS)
    max_frames = pipe._initial_bucket(tph, 1.0)
    log(f"[pipeline] phoneme bucket {tph}, frame bucket {max_frames}")

    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    wavs = pipe.synthesize_batch(TEXTS)
    one = pipe.synthesize(TEXTS[0])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {"ar_decode": k1.launches, "mrf": k2.launches}
    log(f"[pipeline] launches on the main path: {launches} ({cold_s:.2f} s, first calls)")

    totals = pipe.text_to_mel(TEXTS).total_frames.cpu().numpy()
    if totals.max() > max_frames:
        max_frames = pick_bucket(min(int(totals.max()), max(pipe.cfg.runtime.frame_buckets)),
                                 pipe.cfg.runtime.frame_buckets)
    # one acoustic pass (two on a frame-bucket overflow) and one vocode of
    # four MRFs for each of the two calls
    n_stages = len(pipe.mrf_weights)
    if launches["ar_decode"] < 2 or launches["mrf"] != n_stages * launches["ar_decode"]:
        raise AssertionError(f"kernels not on the main path: {launches}")
    for wav, total in zip(wavs, totals):
        if not np.isfinite(wav).all():
            raise AssertionError("non-finite samples in the wav")
        want = min(int(total), max_frames) * pipe.hop
        if wav.shape != (want,):
            raise AssertionError(f"wav length {wav.shape} != {want}")
    if not np.isfinite(one).all() or one.size == 0 or one.size % pipe.hop:
        raise AssertionError(f"synthesize gave {one.shape} samples")
    same = one.shape == wavs[0].shape
    log(f"[pipeline] synthesize vs row 0 of synthesize_batch: same length {same}, max |diff| "
        f"{float(np.abs(one - wavs[0]).max()) if same else 'n/a'}")

    def warm():
        pipe.synthesize_batch(TEXTS)
        torch.cuda.synchronize()

    warm()
    t0 = time.perf_counter()
    warm()
    warm_s = time.perf_counter() - t0
    audio_s = sum(len(w) for w in wavs) / pipe.cfg.audio.sample_rate
    row = dict(B=len(TEXTS), frame_bucket=max_frames,
               totals=[int(x) for x in totals], audio_s=audio_s, warm_ms=warm_s * 1e3,
               rtf=warm_s / audio_s, rms=[float(np.sqrt(np.mean(w ** 2))) for w in wavs])
    log("[pipeline]", json.dumps(row))
    return launches, row


# ---- phase 5: streaming -----------------------------------------------------


def k1_chain(w, mk, mv, bias, t: int, chunk: int):
    """K1 launched chunk by chunk from a fresh carry -> mel [B, t, n_mels]."""
    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1

    carry = k1.init_carry(w, mk.shape[1], t)
    mels = []
    for pos in range(0, t, chunk):
        carry, mel = k1.ar_decode_chunk(w, mk, mv, bias, carry, pos, min(chunk, t - pos))
        mels.append(mel)
    return torch.cat(mels, dim=1)


def stream_launches(pipe, tph: int, need: int):
    """(K1, K2) launches that stream(TEXTS[0]) must make: a run per frame
    bucket it tries, each decoding chunk by chunk as far as its windows need,
    four MRFs per vocoded window."""
    from sambert_hifigan_tpu_torch.text.frontend import pick_bucket

    buckets = pipe.cfg.runtime.frame_buckets
    runs = [pipe._initial_bucket(tph, 1.0)]
    if need > runs[0] and runs[0] < max(buckets):
        runs.append(pick_bucket(min(need, max(buckets)), buckets))
    k1 = k2 = 0
    for i, t in enumerate(runs):
        total = min(need, t)
        last = i == len(runs) - 1
        k1 += math.ceil(max(min(CHUNK + CONTEXT, t), total if last else 0) / CHUNK)
        k2 += len(pipe.mrf_weights) * (math.ceil(total / CHUNK) if last else 1)
    return k1, k2


def first_chunk_breakdown(pipe, text: str):
    """Device ms of what the first stream chunk enqueues, each timed alone
    with CUDA events: the encode, the memory K/V, K1 up to the first
    window's right context (a fresh carry each time) and one window's
    vocode."""
    from sambert_hifigan_tpu_torch.models.ar_decoder import (
        ar_decode_chunk, decode_memory, init_packed_carry)

    tph, args = pipe._frontend_args([text])
    t = pipe._initial_bucket(tph, 1.0)
    controls = (1.0, 0.0, 1.0)
    va = pipe._encode(args, t, *controls)
    dec = pipe.acoustic.ar_decoder
    memory = decode_memory(dec, va.hvar, ~va.frame_mask, pipe.decode_weights)

    def k1_first():
        carry = init_packed_carry(pipe.decode_weights, 1, t)
        for pos in range(0, CHUNK + CONTEXT, CHUNK):
            carry, _ = ar_decode_chunk(pipe.decode_weights, memory, carry, pos, CHUNK)

    window = memory.mem_k.new_zeros(1, CHUNK + 2 * CONTEXT, pipe.cfg.audio.n_mels).float()
    return dict(
        encode_ms=cuda_ms(lambda: pipe._encode(args, t, *controls), reps=5),
        memory_ms=cuda_ms(lambda: decode_memory(dec, va.hvar, ~va.frame_mask,
                                                pipe.decode_weights), reps=5),
        k1_ms=cuda_ms(k1_first, reps=3),
        k1_steps=math.ceil((CHUNK + CONTEXT) / CHUNK) * CHUNK,
        vocode_window_ms=cuda_ms(lambda: pipe.vocode(window), reps=5))


def phase_stream(pipe, cfg, dev, gen, k1_shapes):
    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2

    # (a) chained K1 against one-shot K1, bit for bit, at full width
    for name, b, t, valid in k1_shapes:
        w, mk, mv, bias = k1_inputs(cfg, b, t, valid, gen, dev)
        one = k1.ar_decode(w, mk, mv, bias, t)
        for chunk in (CHUNK, 48):
            same = torch.equal(k1_chain(w, mk, mv, bias, t, chunk), one)
            log(f"[stream] K1 {name} (B={b}, T=S={t}) in chunks of {chunk}: "
                f"torch.equal to the one-shot launch {same}")
            if not same:
                raise AssertionError(f"chained K1 differs from one-shot K1 at {name}, "
                                     f"chunk {chunk}")

    # (b) a warm stream: the first one pays the first calls
    text = TEXTS[0]
    full = pipe.synthesize(text)
    list(pipe.stream(text, chunk_frames=CHUNK, context_frames=CONTEXT))
    torch.cuda.synchronize()
    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    chunks, at = [], []
    for c in pipe.stream(text, chunk_frames=CHUNK, context_frames=CONTEXT):
        chunks.append(c)
        at.append(time.perf_counter() - t0)
    launches = {"ar_decode": k1.launches, "mrf": k2.launches}
    wall = at[-1]
    streamed = np.concatenate(chunks)
    audio_s = len(streamed) / pipe.cfg.audio.sample_rate
    later = np.diff(at)
    # (c) the streamed wav against one-shot synthesize
    tph, _ = pipe._frontend_args([text])
    want = stream_launches(pipe, tph, len(full) // pipe.hop)
    diff = float(np.abs(streamed - full).max()) if streamed.shape == full.shape else None
    row = dict(text_chars=len(text), chunk=CHUNK, context=CONTEXT, chunks=len(chunks),
               frames=len(full) // pipe.hop, first_chunk_ms=at[0] * 1e3,
               later_chunk_ms=float(later.mean()) * 1e3 if len(later) else None,
               wall_ms=wall * 1e3, audio_s=audio_s, rtf=wall / audio_s,
               max_abs_diff_vs_synthesize=diff, launches=launches,
               expected_launches={"ar_decode": want[0], "mrf": want[1]},
               first_chunk_device=first_chunk_breakdown(pipe, text))
    log("[stream]", json.dumps(row))
    if streamed.shape != full.shape:
        raise AssertionError(f"streamed wav {streamed.shape} != synthesize {full.shape}")
    if not np.isfinite(streamed).all():
        raise AssertionError("non-finite samples in the streamed wav")
    if not diff <= STREAM_TOL_MAX:
        raise AssertionError(f"streamed wav departs from synthesize by {diff}")
    # (d) every decoded chunk went through K1, every window through K2
    if (launches["ar_decode"], launches["mrf"]) != want:
        raise AssertionError(f"stream launches {launches}, expected {want}")
    return launches, row


# ---- phase 6: serving -------------------------------------------------------


def phase_serving(pipe):
    import io
    import wave

    import numpy as np

    from sambert_hifigan_tpu_torch.serve import make_server
    from sambert_hifigan_tpu_torch.serving import DynamicBatcher

    lengths = {text: len(pipe.synthesize(text)) for text in TEXTS}
    calls = []  # (batch size, ms) of each synthesize_batch the worker runs

    class Timed:
        def synthesize_batch(self, texts, **controls):
            t0 = time.perf_counter()
            out = pipe.synthesize_batch(texts, **controls)
            calls.append((len(texts), (time.perf_counter() - t0) * 1e3))
            return out

        def stream(self, *args, **kwargs):
            return pipe.stream(*args, **kwargs)

    batcher = DynamicBatcher(Timed(), max_batch=4, max_wait_ms=50)
    httpd = make_server(batcher, "127.0.0.1", 0, pipe.cfg.audio.sample_rate, 300.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        t0 = time.perf_counter()
        req = urllib.request.Request(url + path, data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.read(), time.perf_counter() - t0

    def burst():
        """The four texts as concurrent /tts requests."""
        results = [None] * len(TEXTS)
        go = threading.Barrier(len(TEXTS))

        def client(i):
            go.wait()
            try:
                results[i] = post("/tts", {"text": TEXTS[i]})
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(TEXTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    try:
        results = burst()  # the worker thread's first calls
        fused = batcher.stats()
        again = burst()
        stream_body, stream_s = post("/tts/stream", {"text": TEXTS[0], "chunk_frames": CHUNK})
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join()
    latencies = []
    for r in results + again:
        if isinstance(r, Exception):
            raise AssertionError(f"/tts failed: {r!r}")
    for text, (body, secs) in zip(TEXTS * 2, results + again):
        with wave.open(io.BytesIO(body)) as w:
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), "<i2")
        latencies.append(secs * 1e3)
        if n != lengths[text] or pcm.size != n:
            raise AssertionError(f"/tts gave {n} samples, synthesize {lengths[text]}")
    stream_n = (len(stream_body) - 44) // 2
    row = dict(tts_ms=latencies[:len(TEXTS)], tts_ms_second_burst=latencies[len(TEXTS):],
               synthesize_batch_calls=calls, stream_ms=stream_s * 1e3, stream_samples=stream_n,
               batches_run=fused["batches_run"], requests_served=fused["requests_served"],
               mean_batch_size=fused["mean_batch_size"], healthz=health)
    log("[serving]", json.dumps(row))
    if stream_body[:4] != b"RIFF" or stream_n != lengths[TEXTS[0]]:
        raise AssertionError(f"/tts/stream gave {stream_n} samples, want {lengths[TEXTS[0]]}")
    if fused["requests_served"] != len(TEXTS) or fused["batches_run"] >= len(TEXTS):
        raise AssertionError(f"the batcher fused no batch of more than one request: {fused}")
    if health.get("ok") is not True:
        raise AssertionError(f"/healthz said {health}")
    return row


# ---- phase 7: vocoder training ----------------------------------------------

TRAIN_B, TRAIN_FRAMES, TRAIN_WARMUP, TRAIN_STEPS = 16, 32, 2, 10
# the JAX package's metric schema of an adv_mel_fm step (8 critics)
TRAIN_KEYS = sorted(["disc_loss", "d_grad_norm", "gen_mel_loss", "gen_adv_loss", "gen_fm_loss",
                     "gen_sc_loss", "gen_mag_loss", "gen_stft_loss", "gen_loss", "g_grad_norm",
                     "lr"] + [f"gen_fm_loss_disc_{i}" for i in range(8)])
MSD_PARAMS, MPD_PARAMS = 29_622_918, 41_105_770  # docs/coverage.md C16, C18
# one f32 step, card (TF32 off) against CPU from the same weights: every
# metric within 1e-3 (relative; the G grad norm's MR-STFT term divides by
# |X| in the smallest bins, which amplifies summation-order noise); every
# parameter within 2 lr (Adam's first step is ~lr sign(g)), and all but
# 1e-3 of them within 1e-5 (elements whose gradient is a near-cancelling
# sum may move either way)
TRAIN_TOL_METRIC, TRAIN_TOL_FLIPPED = 1e-3, 1e-3


def _small_train_cfg(cfg):
    import dataclasses

    voc = cfg.vocoder
    voc = dataclasses.replace(
        voc, generator=dataclasses.replace(voc.generator, upsample_initial_channel=64),
        discriminator=dataclasses.replace(voc.discriminator, channel_div=8))
    tr = dataclasses.replace(cfg.training.vocoder, mixed_precision=False)
    return dataclasses.replace(cfg, vocoder=voc,
                               training=dataclasses.replace(cfg.training, vocoder=tr))


def train_card_vs_cpu(cfg, dev):
    """One f32 adv_mel_fm step of a small vocoder (generator 64 channels,
    discriminators at channel_div 8, B = 2, 8 frames) on the card and on
    the CPU from the same seeded weights and batch."""
    import torch

    from sambert_hifigan_tpu_torch.train_vocoder import synthetic_pairs
    from sambert_hifigan_tpu_torch.training.metrics import to_host
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
        init_vocoder_state, make_vocoder_step)

    small = _small_train_cfg(cfg)
    step = make_vocoder_step(small)
    mel, wav = next(synthetic_pairs(2, 8, small.audio.hop_length, small.audio.n_mels, seed=1))
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        state = init_vocoder_state(small, torch.Generator().manual_seed(1), d)
        metrics = step(state, torch.from_numpy(mel).to(d), torch.from_numpy(wav).to(d))
        out[name] = (to_host(metrics), {k: v.detach().cpu() for k, v in
                                        state.model.state_dict().items()})
    (m_cpu, p_cpu), (m_card, p_card) = out["cpu"], out["card"]
    metric_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-8) for k in m_cpu)
    lr = small.training.vocoder.learning_rate
    diffs = [(p_card[k] - p_cpu[k]).abs() for k in p_cpu if "spectral" not in k]
    n = sum(d.numel() for d in diffs)
    row = dict(max_metric_rel_err=metric_err,
               max_param_abs_err=max(float(d.max()) for d in diffs),
               params_over_1e5=sum(int((d > 1e-5).sum()) for d in diffs), params=n,
               gen_loss_card=m_card["gen_loss"], gen_loss_cpu=m_cpu["gen_loss"])
    if sorted(m_card) != sorted(m_cpu) or metric_err > TRAIN_TOL_METRIC:
        raise AssertionError(f"card step departs from the CPU step: {row}")
    if row["max_param_abs_err"] > 2 * lr or row["params_over_1e5"] > TRAIN_TOL_FLIPPED * n:
        raise AssertionError(f"card step's parameters depart from the CPU step's: {row}")
    return row


def phase_train(pipe, dev):
    """Full-width vocoder training: the default config (generator 512
    channels, MSD 3 scales, MPD 2/3/5/7/11 at channel_div 1), adv_mel_fm,
    bf16 mixed precision with f32 masters, B = 16 segments of 32 frames,
    synthetic pairs from seed 0; 2 warm-up then 10 timed steps.  Then the
    checks: finite metrics at every step, the JAX key schema, the exact
    parameter counts, one small step on the card against the CPU, a
    checkpoint round trip, and the trained generator through K2."""
    import tempfile

    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import TTSPipeline
    from sambert_hifigan_tpu_torch.profiling import profile_step
    from sambert_hifigan_tpu_torch.train_vocoder import synthetic_pairs
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
    from sambert_hifigan_tpu_torch.training.metrics import to_host
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
        generator_for_inference, init_vocoder_state, make_vocoder_step)

    cfg = pipe.cfg
    hop = cfg.audio.hop_length
    tr = cfg.training.vocoder
    if not (tr.mixed_precision and cfg.vocoder.loss_mode == "adv_mel_fm"
            and tr.batch_size == TRAIN_B):
        raise AssertionError("the default config is no longer bf16 adv_mel_fm at B = 16")
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_vocoder_state(cfg, torch.Generator().manual_seed(0), dev)
    model = state.model
    counts = {name: sum(p.numel() for p in getattr(model, name).parameters())
              for name in ("generator", "msd", "mpd")}
    log(f"[train] parameters: {counts}")
    if (counts["msd"], counts["mpd"]) != (MSD_PARAMS, MPD_PARAMS):
        raise AssertionError(f"discriminator parameter counts {counts}")
    step = make_vocoder_step(cfg)
    pairs = synthetic_pairs(TRAIN_B, TRAIN_FRAMES, hop, cfg.audio.n_mels, seed=0)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in next(pairs))
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    k1.launches = 0
    k2.launches = 0
    all_metrics, step_ms = [], []
    for i, (mel, wav) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_metrics.append(step(state, mel, wav))
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)

    # the parts of one step, each from CUDA events recorded as it is enqueued
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    mel, wav = batches[-1]
    mark("start")
    step(state, mel, wav, mark=mark)
    torch.cuda.synchronize()
    names = ["start", "g_forward", "d_step", "g_step"]
    parts = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
    top = profile_step(lambda: step(state, mel, wav))

    host = [to_host(m) for m in all_metrics]
    bad = [(i, k) for i, m in enumerate(host) for k, v in m.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics (step, key): {bad[:10]}")
    if sorted(host[0]) != TRAIN_KEYS:
        raise AssertionError(f"metric keys {sorted(host[0])} != the JAX schema {TRAIN_KEYS}")
    if (k1.launches, k2.launches) != (0, 0):
        raise AssertionError(f"a kernel launched in a train step: K1 {k1.launches}, "
                             f"K2 {k2.launches}")
    med = sorted(step_ms)[len(step_ms) // 2]
    audio_s = TRAIN_B * TRAIN_FRAMES * hop / cfg.audio.sample_rate
    row = dict(B=TRAIN_B, frames=TRAIN_FRAMES, samples=TRAIN_FRAMES * hop,
               loss_mode=cfg.vocoder.loss_mode, mixed_precision=tr.mixed_precision,
               step_ms=step_ms, median_step_ms=med, min_step_ms=min(step_ms),
               steps_per_s=1e3 / med, audio_s_per_s=audio_s * 1e3 / med,
               device_ms=parts, peak_memory_gib=peak / 2 ** 30, params=counts,
               profile=top,
               first=host[0], last=host[-1])
    log("[train]", json.dumps(row))

    # card against CPU on a small config, f32
    row["card_vs_cpu"] = train_card_vs_cpu(cfg, dev)
    log("[train] card vs CPU", json.dumps(row["card_vs_cpu"]))

    # checkpoint round trip
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp, cfg.audio)
        t0 = time.perf_counter()
        ckpt.save(state.step, state)
        save_s = time.perf_counter() - t0
        fresh = init_vocoder_state(cfg, torch.Generator().manual_seed(1), dev)
        t0 = time.perf_counter()
        restored = ckpt.restore(fresh)
        restore_s = time.perf_counter() - t0
    same = restored == state.step == fresh.step and all(
        torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                          fresh.model.state_dict().values()))
    for ours, theirs in ((state.g_opt, fresh.g_opt), (state.d_opt, fresh.d_opt)):
        sa, sb = ours.adamw.state_dict()["state"], theirs.adamw.state_dict()["state"]
        same = same and ours.applied == theirs.applied and all(
            torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    log(f"[train] checkpoint of step {state.step}: saved in {save_s:.2f} s, restored in "
        f"{restore_s:.2f} s, torch.equal {same}")
    if not same:
        raise AssertionError("the restored train state differs from the saved one")
    del fresh

    # the trained generator, packed for K2, vocodes through the pipeline
    trained = generator_for_inference(state)
    vocoder = TTSPipeline(cfg, pipe.acoustic.state_dict(), trained.state_dict(), device=dev)
    mel = torch.randn(1, 64, cfg.audio.n_mels, generator=torch.Generator().manual_seed(2))
    mel = mel.to(dev)
    k2.launches = 0
    wav = vocoder.vocode(mel)
    torch.cuda.synchronize()
    launches = k2.launches
    with torch.no_grad():
        plain = trained(mel.transpose(1, 2))
    err = float((wav - plain).abs().max())
    row["vocode"] = dict(frames=64, samples=wav.shape[-1], k2_launches=launches,
                         max_abs_err=err, ref_mean_abs=float(plain.abs().mean()))
    log("[train] trained generator through K2", json.dumps(row["vocode"]))
    if wav.shape != (1, 1, 64 * hop) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"vocoded wav {tuple(wav.shape)}, want (1, 1, {64 * hop})")
    if launches != len(vocoder.mrf_weights) or err > K2_TOL_MAX:
        raise AssertionError(f"trained generator through K2: {row['vocode']}")
    return row


# ---- phase 8: acoustic training ---------------------------------------------

AC_B, AC_TPH, AC_FRAMES, AC_WARMUP, AC_STEPS = 16, 64, 512, 2, 10
AC_KEYS = sorted(["total_loss", "mel_loss", "dur_loss", "pitch_loss", "energy_loss",
                  "grad_norm", "lr"])
# one f32 step, card (TF32 off) against CPU from the same weights, dropout 0:
# every metric within 1e-4 (relative); every parameter within 2 lr, all but
# 1e-3 of them within 1e-5 (Adam's first step is ~lr sign(g))
AC_TOL_METRIC, AC_TOL_FLIPPED = 1e-4, 1e-3


def _small_acoustic_cfg(cfg):
    import dataclasses

    from sambert_hifigan_tpu_torch import config as c

    am = dataclasses.replace(
        cfg.acoustic_model, d_model=64,
        encoder=c.EncoderConfig(n_layers=2, n_heads=2, d_ff=128, dropout=0.0),
        variance_adaptor=c.VarianceAdaptorConfig(predictor_dropout=0.0),
        decoder=c.DecoderConfig(n_layers=2, n_heads=4, d_ff=128, dropout=0.0, max_len=128))
    tr = dataclasses.replace(cfg.training.acoustic, mixed_precision=False)
    return dataclasses.replace(cfg, acoustic_model=am,
                               training=dataclasses.replace(cfg.training, acoustic=tr))


def acoustic_card_vs_cpu(cfg, dev):
    """One f32 step of a small acoustic model (d 64, 2 + 2 layers, dropout
    0; B = 2, 16 phonemes, 64 frames) on the card and on the CPU from the
    same seeded weights and batch."""
    import torch

    from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
    from sambert_hifigan_tpu_torch.training.acoustic_trainer import (
        init_acoustic_state, make_acoustic_step)
    from sambert_hifigan_tpu_torch.training.metrics import to_host
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model

    small = _small_acoustic_cfg(cfg)
    step = make_acoustic_step(small)
    batch = synthetic_batch(small, 2, tph=16, tfrm=64, seed=1)
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = random_acoustic_model(small, torch.Generator().manual_seed(1)).to(d)
        state = init_acoustic_state(model, small)
        metrics = step(state, batch_to_device(batch, d), torch.Generator().manual_seed(2))
        out[name] = (to_host(metrics), {k: v.detach().cpu() for k, v in
                                        state.model.state_dict().items()})
    (m_cpu, p_cpu), (m_card, p_card) = out["cpu"], out["card"]
    metric_err = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-8) for k in m_cpu)
    lr = small.training.acoustic.learning_rate
    diffs = [(p_card[k] - p_cpu[k]).abs() for k in p_cpu]
    n = sum(x.numel() for x in diffs)
    row = dict(max_metric_rel_err=metric_err,
               max_param_abs_err=max(float(x.max()) for x in diffs),
               params_over_1e5=sum(int((x > 1e-5).sum()) for x in diffs), params=n,
               total_loss_card=m_card["total_loss"], total_loss_cpu=m_cpu["total_loss"])
    if sorted(m_card) != sorted(m_cpu) or metric_err > AC_TOL_METRIC:
        raise AssertionError(f"card acoustic step departs from the CPU step: {row}")
    if row["max_param_abs_err"] > 2 * lr or row["params_over_1e5"] > AC_TOL_FLIPPED * n:
        raise AssertionError(f"card acoustic step's parameters depart from the CPU's: {row}")
    return row


def acoustic_checkpoint_round_trip(cfg, state, step, batch, dev):
    """Save and restore into a fresh state, synchronously and from the
    background thread while the next step updates the state in place:
    every tensor `torch.equal` to the state at the save."""
    import tempfile

    import torch

    from sambert_hifigan_tpu_torch.training.acoustic_trainer import init_acoustic_state
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model

    def snapshot(s):
        opt = s.opt.adamw.state_dict()["state"]
        return ([v.clone() for v in s.model.state_dict().values()],
                [t.clone() for i in sorted(opt) for t in opt[i].values()], s.opt.applied, s.step)

    def same(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
                and all(torch.equal(x, y) for x, y in zip(a[1], b[1])) and a[2:] == b[2:])

    fresh = init_acoustic_state(
        random_acoustic_model(cfg, torch.Generator().manual_seed(1)).to(dev), cfg)
    row = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp, cfg.audio)
        saved = snapshot(state)
        t0 = time.perf_counter()
        ckpt.save(state.step, state)
        row["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.restore(fresh)
        row["restore_s"] = time.perf_counter() - t0
        row["sync_equal"] = same(saved, snapshot(fresh))
        saved = snapshot(state)
        t0 = time.perf_counter()
        ckpt.save(state.step, state, background=True)
        row["background_call_s"] = time.perf_counter() - t0
        step(state, batch, torch.Generator().manual_seed(7))  # updates the state in place
        ckpt.wait()
        row["background_total_s"] = time.perf_counter() - t0
        ckpt.restore(fresh)
        row["background_equal"] = same(saved, snapshot(fresh))
        row["background_differs_from_now"] = not same(snapshot(state), snapshot(fresh))
    if not (row["sync_equal"] and row["background_equal"]
            and row["background_differs_from_now"]):
        raise AssertionError(f"acoustic checkpoint round trip: {row}")
    return row


def phase_acoustic_train(pipe, dev):
    """Full-width acoustic training: the default config (encoder 6 x d256 x
    4 heads x FFN 1024, decoder 6 x 8 heads x FFN 2048, 80 mels), bf16
    mixed precision with f32 masters, the config's B = 16, synthetic
    batches of 64 phonemes in a 512-frame bucket (durations sum to at most
    448 frames) from seeds 0-11, weights from seed 0; 2 warm-up then 10
    timed steps.  Then the checks: finite metrics at every step, the JAX
    key schema, no kernel in a step, one small f32 step on the card against
    the CPU, a checkpoint round trip (background save included), the
    trained decoder through K1 against its plain version, synthesize_batch
    with the trained model, and the train_acoustic and inference entry
    points."""
    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
    from sambert_hifigan_tpu_torch.flops import BF16_FLOP_PER_S, acoustic_step_flops
    from sambert_hifigan_tpu_torch.models.ar_decoder import decode_memory
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import TTSPipeline
    from sambert_hifigan_tpu_torch.profiling import profile_step
    from sambert_hifigan_tpu_torch.training.acoustic_trainer import (
        acoustic_inference_params, init_acoustic_state, make_acoustic_step)
    from sambert_hifigan_tpu_torch.training.metrics import to_host
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model

    t_phase = time.perf_counter()
    cfg = pipe.cfg
    tr = cfg.training.acoustic
    if not (tr.mixed_precision and tr.batch_size == AC_B):
        raise AssertionError("the default config is no longer bf16 at B = 16")
    torch.cuda.reset_peak_memory_stats(dev)
    model = random_acoustic_model(cfg, torch.Generator().manual_seed(0)).to(dev)
    state = init_acoustic_state(model, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_acoustic_step(cfg)
    host_batches = [synthetic_batch(cfg, AC_B, tph=AC_TPH, tfrm=AC_FRAMES, seed=i)
                    for i in range(AC_WARMUP + AC_STEPS)]
    batches = [batch_to_device(b, dev) for b in host_batches]
    rng = torch.Generator().manual_seed(1)
    k1.launches = 0
    k2.launches = 0
    all_metrics, step_ms = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_metrics.append(step(state, batch, rng))
        torch.cuda.synchronize()
        if i >= AC_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)

    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    mark("start")
    step(state, batches[-1], rng, mark=mark)
    torch.cuda.synchronize()
    names = ["start", "forward", "backward", "optimizer"]
    parts = {b: events[a].elapsed_time(events[b]) for a, b in zip(names, names[1:])}
    top = profile_step(lambda: step(state, batches[-1], rng))

    host = [to_host(m) for m in all_metrics]
    bad = [(i, k) for i, m in enumerate(host) for k, v in m.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics (step, key): {bad[:10]}")
    if sorted(host[0]) != AC_KEYS:
        raise AssertionError(f"metric keys {sorted(host[0])} != the JAX schema {AC_KEYS}")
    med = sorted(step_ms)[len(step_ms) // 2]
    frames = [int(b["frame_lengths"].sum()) for b in host_batches[AC_WARMUP:]]
    flops = acoustic_step_flops(cfg, AC_B, AC_TPH, AC_FRAMES)
    row = dict(B=AC_B, tph=AC_TPH, frame_bucket=AC_FRAMES, params=n_params,
               mixed_precision=tr.mixed_precision, step_ms=step_ms, median_step_ms=med,
               min_step_ms=min(step_ms), steps_per_s=1e3 / med,
               frames_per_s=float(np.median(frames)) * 1e3 / med,
               bucket_frames_per_s=AC_B * AC_FRAMES * 1e3 / med,
               tflop_per_step=flops / 1e12, bound_ms=flops / BF16_FLOP_PER_S * 1e3,
               tflops=flops / med * 1e-9, device_ms=parts,
               peak_memory_gib=peak / 2 ** 30, profile=top, first=host[0], last=host[-1])
    log("[acoustic]", json.dumps(row))

    row["card_vs_cpu"] = acoustic_card_vs_cpu(cfg, dev)
    log("[acoustic] card vs CPU", json.dumps(row["card_vs_cpu"]))
    row["checkpoint"] = acoustic_checkpoint_round_trip(cfg, state, step, batches[0], dev)
    log("[acoustic] checkpoint", json.dumps(row["checkpoint"]))
    # every train step of the phase has run: 12 timed, the CUDA-event step, the
    # profiled step, the small card step and the step during the background save
    train_launches = (k1.launches, k2.launches)
    if train_launches != (0, 0):
        raise AssertionError(f"a kernel launched in an acoustic train step: {train_launches}")

    # the trained model: its decoder packed for K1, then the whole pipeline
    trained = acoustic_inference_params(state)
    tts = TTSPipeline(cfg, trained.state_dict(), pipe.generator.state_dict(), device=dev)
    tph, args = tts._frontend_args(TEXTS)
    bucket = tts._initial_bucket(tph, 1.0)
    va = tts._encode(args, bucket, 1.0, 0.0, 1.0)
    w = tts.decode_weights
    memory = decode_memory(tts.acoustic.ar_decoder, va.hvar, ~va.frame_mask, w)
    k1.launches = 0
    out = k1.ar_decode(w, *memory, bucket)
    direct = k1.launches
    ref = k1.ar_decode_plain(w, *memory, k1.init_carry(w, len(TEXTS), bucket), 0, bucket)[1]
    torch.cuda.synchronize()
    err = (out - ref).abs()
    k1.launches = 0
    k2.launches = 0
    wavs = tts.synthesize_batch(TEXTS)
    torch.cuda.synchronize()
    launches = {"ar_decode": k1.launches, "mrf": k2.launches}
    totals, want = expected_samples(tts, TEXTS)
    row["trained"] = dict(frame_bucket=bucket, k1_max_abs_err=err.max().item(),
                          k1_mean_abs_err=err.mean().item(),
                          ref_mean_abs=ref.abs().mean().item(), totals=totals,
                          wav_samples=[len(x) for x in wavs], synthesize_launches=launches,
                          launches={"ar_decode": direct + launches["ar_decode"],
                                    "mrf": launches["mrf"]})
    log("[acoustic] trained model through K1 and synthesize_batch", json.dumps(row["trained"]))
    if direct != 1 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"the trained decoder through K1: {direct} launches, finite "
                             f"{bool(torch.isfinite(out).all())}")
    if not (err.mean().item() < K1_TOL_MEAN and err.max().item() < K1_TOL_MAX):
        raise AssertionError(f"the trained decoder through K1 outside tolerance: {row['trained']}")
    for wav, n in zip(wavs, want):
        if wav.shape != (n,) or not np.isfinite(wav).all():
            raise AssertionError(f"trained synthesize_batch gave {wav.shape}, want {n}")
    n_stages = len(tts.mrf_weights)
    if launches["ar_decode"] < 1 or launches["mrf"] != n_stages * launches["ar_decode"]:
        raise AssertionError(f"kernels not on the trained model's path: {launches}")
    row["entry_points"] = acoustic_entry_points(cfg)
    log("[acoustic] train_acoustic, then inference --acoustic-checkpoint",
        json.dumps(row["entry_points"]))
    log(f"[acoustic] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return row


def batch_frame_bucket(tts, texts, totals) -> int:
    """The frame bucket tts.synthesize_batch(texts) runs in: the first guess
    unless a row's total overflowed it."""
    from sambert_hifigan_tpu_torch.text.frontend import pick_bucket

    bucket = tts._initial_bucket(tts._features(texts)[0], 1.0)
    buckets = tts.cfg.runtime.frame_buckets
    return bucket if max(totals) <= bucket else pick_bucket(min(max(totals), max(buckets)),
                                                            buckets)


def expected_samples(tts, texts):
    """(total_frames, each wav's length) of tts.synthesize_batch(texts):
    min(total_frames, the frame bucket the batch ran in) * hop."""
    totals = tts.text_to_mel(texts).total_frames.cpu().tolist()
    used = batch_frame_bucket(tts, texts, totals)
    return totals, [min(int(t), used) * tts.hop for t in totals]


def acoustic_entry_points(cfg):
    """`python -m sambert_hifigan_tpu_torch.train_acoustic --synthetic 2`
    with no --device (so on the card), then `inference
    --acoustic-checkpoint` on the checkpoint it wrote: the trained weights
    are what the inference pipeline loads, and its synthesis goes through
    K1 and K2."""
    import tempfile

    import torch

    from sambert_hifigan_tpu_torch import inference, train_acoustic
    from sambert_hifigan_tpu_torch.data.audio import load_wav
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state = train_acoustic.main(["--synthetic", "2", "--checkpoint-dir", f"{tmp}/ac",
                                     "--log-dir", f"{tmp}/logs"])
        train_s = time.perf_counter() - t0
        device = next(state.model.parameters()).device.type
        ckpt = sorted(Path(tmp, "ac").glob("step_*/state.pt"))
        ckpt_mb = ckpt[-1].stat().st_size / 1e6 if ckpt else None
        loaded = build_pipeline(cfg, acoustic_checkpoint=f"{tmp}/ac").acoustic.state_dict()
        same = all(torch.equal(v, loaded[k]) for k, v in state.model.state_dict().items())
        k1.launches = 0
        k2.launches = 0
        inference.main(["--text", TEXTS[0], "--output", f"{tmp}/a.wav",
                        "--acoustic-checkpoint", f"{tmp}/ac"])
        launches = {"ar_decode": k1.launches, "mrf": k2.launches}
        wav, sr = load_wav(f"{tmp}/a.wav")
    row = dict(device=device, steps=state.step, train_s=train_s,
               checkpoints=[c.parent.name for c in ckpt],
               checkpoint_mb=ckpt_mb,
               loaded_equal=same, inference_launches=launches, wav_samples=int(wav.size),
               sample_rate=sr)
    if device != "cuda" or state.step != 2 or len(ckpt) != 1 or not same:
        raise AssertionError(f"train_acoustic on the card and its checkpoint: {row}")
    if launches["ar_decode"] < 1 or launches["mrf"] != 4 * launches["ar_decode"] or not wav.size:
        raise AssertionError(f"inference --acoustic-checkpoint: {row}")
    return row


# ---- phase 9: the data pipeline ---------------------------------------------

DATA_UTTS, DATA_SEED, DATA_COMPARE, ALIGN_STEPS = 64, 0, 4, 200
DATA_AC_STEPS, DATA_VOC_STEPS, DATA_WARMUP = 12, 6, 2
# card against CPU features, as tests/test_torch_data.py holds the port to
# JAX on the CPU: the log-mel within 1e-3 where the CPU's log10 power is
# above -6, 1e-2 below (f32 rounding of two FFT libraries at the noise
# floor); energy within 1e-5; F0 within 1e-3 (relative) where both are
# voiced, at most 1% of voiced flags differing (an argmax near-tie);
# durations equal
DATA_MEL_TOL_LOUD, DATA_MEL_TOL, DATA_MEL_LOUD = 1e-3, 1e-2, -6.0
DATA_ENERGY_TOL, DATA_F0_REL, DATA_FLIP_SHARE = 1e-5, 1e-3, 0.01
DATA_PHASE_LIMIT_S = 240.0  # a hung phase fails; the aim is under 90 s


def median(xs):
    return sorted(xs)[len(xs) // 2]


class StepTimer:
    """Times every step an entry point's loop runs: wraps the trainer's
    step factory (`make_acoustic_step`, `make_vocoder_step`, looked up at
    the entry point's call) so each step is timed on the host clock from
    its call to a synchronize after it (step ms), and from one call to the
    next (loop ms: the step plus the loop's wait for its batch)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.real = module, name, getattr(module, name)
        self.starts, self.step_ms, self.shapes = [], [], set()

    def __enter__(self):
        import torch

        def make(*args, **kwargs):
            step = self.real(*args, **kwargs)

            def timed(state, batch, *rest, **kw):
                t0 = time.perf_counter()
                self.starts.append(t0)
                self.shapes.add(tuple(batch["mel_gt"].shape if isinstance(batch, dict)
                                      else batch.shape))
                out = step(state, batch, *rest, **kw)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed

        setattr(self.module, self.name, make)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def summary(self, warmup: int) -> dict:
        starts = self.starts[warmup:]
        loops = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
        return dict(steps=len(self.step_ms), median_step_ms=median(self.step_ms[warmup:]),
                    median_loop_ms=median(loops), step_ms=self.step_ms,
                    batch_shapes=sorted(self.shapes))


def native_decode_check(paths):
    """Every corpus wav decoded by the native C++ reader, one at a time and
    through its prefetcher, against the numpy reader, bit for bit."""
    import numpy as np

    from sambert_hifigan_tpu_torch.data import native_loader
    from sambert_hifigan_tpu_torch.data.audio import load_wav

    if not native_loader.native_available():
        raise AssertionError("the native WAV decoder did not build")
    t0 = time.perf_counter()
    native = [native_loader.load_wav_native(p) for p in paths]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    t0 = time.perf_counter()
    plain = [load_wav(p) for p in paths]
    numpy_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    unequal = [i for i, ((a, sa), (b, sb)) in enumerate(zip(native, plain))
               if sa != sb or a.shape != b.shape or not np.array_equal(a, b)]
    with native_loader.NativePrefetcher([str(p) for p in paths], n_threads=4) as pf:
        delivered = {i: w for i, w, _ in pf}
    prefetched_equal = sorted(delivered) == list(range(len(paths))) and all(
        np.array_equal(w, plain[i][0]) for i, w in delivered.items())
    row = dict(files=len(paths), unequal=unequal, prefetcher_equal=prefetched_equal,
               native_ms_per_file=native_ms, numpy_ms_per_file=numpy_ms,
               library=native_loader.library_path().name)
    if unequal or not prefetched_equal:
        raise AssertionError(f"native decode differs from the numpy reader: {row}")
    return row


def features_card_vs_cpu(card, cpu, utts):
    """Features of `utts` extracted on the card against the CPU's."""
    import numpy as np

    row = dict(utterances=len(utts), mel_max_abs=0.0, mel_max_abs_loud=0.0,
               energy_max_abs=0.0, f0_max_rel=0.0, voiced_flips=0, frames=0, dur_equal=True)
    for u in utts:
        a, b = card.load_features(u), cpu.load_features(u)
        d = np.abs(a["mel"] - b["mel"])
        loud = b["mel"] > DATA_MEL_LOUD
        both = a["voiced"] & b["voiced"]
        row["mel_max_abs"] = max(row["mel_max_abs"], float(d.max()))
        row["mel_max_abs_loud"] = max(row["mel_max_abs_loud"], float(d[loud].max()))
        row["energy_max_abs"] = max(row["energy_max_abs"],
                                    float(np.abs(a["energy"] - b["energy"]).max()))
        if both.any():
            rel = np.abs(a["f0"] - b["f0"])[both] / b["f0"][both]
            row["f0_max_rel"] = max(row["f0_max_rel"], float(rel.max()))
        row["voiced_flips"] += int((a["voiced"] != b["voiced"]).sum())
        row["frames"] += int(b["voiced"].size)
        row["dur_equal"] &= bool(np.array_equal(a["dur"], b["dur"]))
    row["voiced_flip_share"] = row["voiced_flips"] / row["frames"]
    if not (row["mel_max_abs"] <= DATA_MEL_TOL and row["mel_max_abs_loud"] <= DATA_MEL_TOL_LOUD
            and row["energy_max_abs"] <= DATA_ENERGY_TOL and row["f0_max_rel"] <= DATA_F0_REL
            and row["voiced_flip_share"] <= DATA_FLIP_SHARE and row["dur_equal"]):
        raise AssertionError(f"card features depart from the CPU's: {row}")
    return row


def phase_data(pipe, dev):
    """The data pipeline on the card, corpus to synthesis: a toy corpus of
    64 utterances (make_toy_dataset, seed 0); every wav decoded natively,
    bit-equal to the numpy reader; TTSDataset features on the card, cold
    (extracted, cache written) and warm (memo), 4 utterances against the
    CPU; compute_alignments on the card (200 aligner steps; the loss must
    fall, every duration sums to its frames and is >= 1); train_acoustic
    --metadata at the default config (full width and depth, bf16) for 12
    steps with --prefetch on, then off, and a profiled step on a corpus
    batch; train_vocoder --metadata for 6 steps; build_pipeline from the
    two checkpoints, synthesize_batch of 4 corpus texts through K1 and K2
    with exact lengths; mel-MAE and MCD of a copy synthesis against its
    recording (recorded, not gated)."""
    import tempfile

    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch import train_acoustic, train_vocoder
    from sambert_hifigan_tpu_torch.data import aligner, native_loader
    from sambert_hifigan_tpu_torch.data import dataset as data
    from sambert_hifigan_tpu_torch.data.audio import load_wav
    from sambert_hifigan_tpu_torch.data.features import uniform_durations
    from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline
    from sambert_hifigan_tpu_torch.profiling import profile_step
    from sambert_hifigan_tpu_torch.training import acoustic_trainer, vocoder_trainer
    from sambert_hifigan_tpu_torch.utils.eval_metrics import mcd, mel_mae

    t_phase = time.perf_counter()
    cfg = pipe.cfg
    row = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        meta = make_toy_dataset(tmp / "toy", n=DATA_UTTS, seed=DATA_SEED, verbose=False)
        make_s = time.perf_counter() - t0
        utts = data.read_metadata(str(meta))
        paths = [tmp / "toy" / u.wav_path for u in utts]
        secs = [load_wav(p)[0].shape[-1] / cfg.audio.sample_rate for p in paths]
        row["corpus"] = dict(utterances=len(utts), seed=DATA_SEED, make_s=make_s,
                             min_s=min(secs), max_s=max(secs), total_s=sum(secs))
        log("[data] corpus", json.dumps(row["corpus"]))
        row["native"] = native_decode_check(paths)
        log("[data] native decode", json.dumps(row["native"]))

        # features on the card: cold (extracted and cached), then warm (memo);
        # every wav must come through the native decoder
        decodes = {"native": 0, "numpy": 0}
        real = (native_loader.load_wav_native, data.load_wav)

        def counted(name, fn):
            def call(path):
                decodes[name] += 1
                return fn(path)
            return call

        native_loader.load_wav_native = counted("native", real[0])
        data.load_wav = counted("numpy", real[1])
        try:
            ds = data.TTSDataset(str(meta), cfg, device=dev)
            t0 = time.perf_counter()
            feats = [ds.load_features(u) for u in utts]
            cold_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for u in utts:
                ds.load_features(u)
            warm_s = time.perf_counter() - t0
        finally:
            native_loader.load_wav_native, data.load_wav = real
        frames = [f["mel"].shape[0] for f in feats]
        row["features"] = dict(cold_s=cold_s, cold_utt_per_s=len(utts) / cold_s, warm_s=warm_s,
                               warm_utt_per_s=len(utts) / warm_s, decodes=decodes,
                               min_frames=min(frames), max_frames=max(frames),
                               total_frames=sum(frames))
        log("[data] features on the card", json.dumps(row["features"]))
        if decodes != {"native": len(utts), "numpy": 0}:
            raise AssertionError(f"wavs not decoded natively: {decodes}")
        cpu = data.TTSDataset(str(meta), cfg, device="cpu", cache_dir=str(tmp / "cache_cpu"))
        row["card_vs_cpu"] = features_card_vs_cpu(ds, cpu, utts[:DATA_COMPARE])
        log("[data] features, card vs CPU", json.dumps(row["card_vs_cpu"]))

        # alignment on the card; the aligner's training timed apart from the Viterbi pass
        train_s = []
        real_train = aligner.train_ctc_aligner

        def timed_train(*args, **kwargs):
            t0 = time.perf_counter()
            out = real_train(*args, **kwargs)
            torch.cuda.synchronize()
            train_s.append(time.perf_counter() - t0)
            return out

        aligner.train_ctc_aligner = timed_train
        try:
            t0 = time.perf_counter()
            losses = ds.compute_alignments(steps=ALIGN_STEPS)
            align_s = time.perf_counter() - t0
        finally:
            aligner.train_ctc_aligner = real_train
        feats = [ds.load_features(u) for u in utts]
        broken = [u.wav_path for u, f in zip(utts, feats)
                  if f["dur"].sum() != f["mel"].shape[0] or (f["dur"] < 1).any()]
        changed = sum(not np.array_equal(f["dur"], uniform_durations(len(f["ph_ids"]),
                                                                     f["mel"].shape[0]))
                      for f in feats)
        row["align"] = dict(steps=ALIGN_STEPS, ms_per_step=train_s[0] * 1e3 / ALIGN_STEPS,
                            viterbi_s=align_s - train_s[0], total_s=align_s,
                            loss_first=losses[0], loss_last=losses[-1],
                            loss_min=min(losses), durations_changed=changed)
        log("[data] compute_alignments on the card", json.dumps(row["align"]))
        if broken or not losses[-1] < losses[0]:
            raise AssertionError(f"alignment: loss {losses[0]} -> {losses[-1]}, contract broken "
                                 f"by {broken}")

        # the host side of a batch, memo warm: collate, then the pinned copy
        b = cfg.training.acoustic.batch_size
        t0 = time.perf_counter()
        host_batches = list(ds.batches(b, seed=0))
        collate_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for hb in host_batches:
            data.batch_to_device(hb, dev)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)

        # train_acoustic --metadata, prefetch on and off; no kernel in a train step
        k1.launches = 0
        k2.launches = 0
        common = ["--metadata", str(meta), "--log-dir", str(tmp / "logs")]
        runs = {}
        for mode in ("on", "off"):
            with StepTimer(acoustic_trainer, "make_acoustic_step") as timer:
                state = train_acoustic.main([*common, "--steps", str(DATA_AC_STEPS),
                                             "--prefetch", mode,
                                             "--checkpoint-dir", str(tmp / f"ac_{mode}")])
            runs[mode] = dict(timer.summary(DATA_WARMUP), step=state.step)
        step = acoustic_trainer.make_acoustic_step(cfg)
        batch = data.batch_to_device(host_batches[0], dev)
        top = profile_step(lambda: step(state, batch, torch.Generator().manual_seed(5)))
        row["acoustic"] = dict(
            B=b, host_collate_ms=collate_ms, host_copy_ms=copy_ms, prefetch_on=runs["on"],
            prefetch_off=runs["off"], profiled_batch=list(batch["mel_gt"].shape),
            profile=top, device_idle_share=1 - top["busy_ms"] / runs["on"]["median_step_ms"],
            device=next(state.model.parameters()).device.type,
            checkpoints=sorted(p.parent.name for p in (tmp / "ac_on").glob("step_*/state.pt")))
        log("[data] train_acoustic --metadata", json.dumps(row["acoustic"]))
        if row["acoustic"]["device"] != dev.type or any(r["step"] != DATA_AC_STEPS
                                                         for r in runs.values()):
            raise AssertionError(f"train_acoustic --metadata: {row['acoustic']}")
        if row["acoustic"]["checkpoints"] != [f"step_{DATA_AC_STEPS:09d}"]:
            raise AssertionError(f"acoustic checkpoint: {row['acoustic']['checkpoints']}")

        with StepTimer(vocoder_trainer, "make_vocoder_step") as timer:
            vstate = train_vocoder.main([*common, "--steps", str(DATA_VOC_STEPS),
                                         "--prefetch", "on", "--save-precision", "bf16",
                                         "--checkpoint-dir", str(tmp / "voc")])
        row["vocoder"] = dict(timer.summary(DATA_WARMUP), step=vstate.step,
                              checkpoints=sorted(p.parent.name for p in
                                                 (tmp / "voc").glob("step_*/state.pt")))
        log("[data] train_vocoder --metadata", json.dumps(row["vocoder"]))
        if vstate.step != DATA_VOC_STEPS or len(row["vocoder"]["checkpoints"]) != 1:
            raise AssertionError(f"train_vocoder --metadata: {row['vocoder']}")
        if (k1.launches, k2.launches) != (0, 0):
            raise AssertionError(f"a kernel launched in a --metadata train step: "
                                 f"K1 {k1.launches}, K2 {k2.launches}")

        # the two checkpoints through the pipeline: K1 once per decode, K2 four times
        tts = build_pipeline(cfg, device=dev, acoustic_checkpoint=str(tmp / "ac_on"),
                             vocoder_checkpoint=str(tmp / "voc"))
        texts = [u.text for u in utts[:4]]
        k1.launches = 0
        k2.launches = 0
        wavs = tts.synthesize_batch(texts)
        torch.cuda.synchronize()
        synth = {"ar_decode": k1.launches, "mrf": k2.launches}
        totals, want = expected_samples(tts, texts)
        decodes_k1 = 1 if max(totals) <= tts._initial_bucket(tts._frontend_args(texts)[0],
                                                             1.0) else 2
        f = feats[0]
        k2.launches = 0
        with torch.no_grad():
            copy = tts.vocode(torch.tensor(f["mel"], device=dev)[None])[0, 0].cpu().numpy()
        copy_k2 = k2.launches
        row["synthesis"] = dict(
            texts=texts, totals=totals, wav_samples=[len(w) for w in wavs], want=want,
            launches=synth, copy_synthesis_k2=copy_k2,
            mel_mae=mel_mae(f["wav"], copy, cfg.audio, device=dev),
            mcd=mcd(f["wav"], copy, cfg.audio, device=dev))
        row["launches"] = {"ar_decode": synth["ar_decode"], "mrf": synth["mrf"] + copy_k2}
        log("[data] synthesis from the --metadata checkpoints", json.dumps(row["synthesis"]))
        for wav, n in zip(wavs, want):
            if wav.shape != (n,) or not np.isfinite(wav).all():
                raise AssertionError(f"synthesize_batch gave {wav.shape}, want {n}")
        n_stages = len(tts.mrf_weights)
        if synth != {"ar_decode": decodes_k1, "mrf": n_stages * decodes_k1} or copy_k2 != n_stages:
            raise AssertionError(f"kernels on the --metadata checkpoints' path: {row['synthesis']}")
        if copy.shape != (f["mel"].shape[0] * tts.hop,) or not np.isfinite(copy).all():
            raise AssertionError(f"copy synthesis gave {copy.shape}")
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[data] phase 9 took {row['phase_s']:.1f} s")
    if row["phase_s"] > DATA_PHASE_LIMIT_S:
        raise AssertionError(f"phase 9 took {row['phase_s']:.1f} s (limit {DATA_PHASE_LIMIT_S})")
    return row


# ---- phase 10: data-parallel training across processes ----------------------

DP_RANKS, DP_AC_STEPS, DP_VOC_STEPS, DP_B = 2, 4, 3, 16
DP_TOY_UTTS, DP_TIMEOUT_S = 4, 300
# a hung phase fails; measured 76-87 s on one H100 (PERF.md, PR 9), most of
# it the start of six processes (two torchrun agents and their workers,
# two gloo ranks) and the full-width models' first steps
DP_PHASE_LIMIT_S = 120.0


def phase_dp(pipe, dev):
    """Data-parallel training across processes on the card.  The NCCL leg:
    `train_acoustic --synthetic 4` and `train_vocoder --synthetic 4` under
    `torch.distributed.run --nproc-per-node 1` (world size 1, nccl), side
    by side.  The gloo leg: `multiprocess_dp` with 2 ranks on cuda:0 (nccl
    refuses two ranks on one card), at the default config's full width
    (`multiprocess_dp.comparable`: dropout 0, f32): the acoustic model at B = 16 global, synthetic_batch(tph
    64, tfrm 512), 4 steps, and the vocoder in adv_mel_fm at B = 16 x 32
    frames, 3 steps, each against a single-process control on the card and
    rank 0's lockstep, replicas bit-equal; step ms, the reduction's ms and
    each rank's peak memory.  Then the NCCL leg's checkpoints: synthesize_
    batch through K1 and K2 (`build_pipeline`), and on a fresh toy corpus
    `copy_synth` (K2), `eval_vocoder_waveform` and `eval_teacher_forced`."""
    import tempfile

    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch import multiprocess_dp as mp
    from sambert_hifigan_tpu_torch.copy_synth import copy_synthesize
    from sambert_hifigan_tpu_torch.eval_teacher_forced import teacher_forced_mel_l1
    from sambert_hifigan_tpu_torch.eval_vocoder_waveform import score_systems
    from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline

    t_phase = time.perf_counter()
    cfg = pipe.cfg
    row = {}
    k1.launches = 0
    k2.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the NCCL leg at world size 1, both trainers side by side
        t0 = time.perf_counter()
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "1", "-m"]
        common = ["--synthetic", "4", "--log-dir", str(tmp / "logs")]
        legs = mp.run_procs([
            [*torchrun, "sambert_hifigan_tpu_torch.train_acoustic", *common,
             "--checkpoint-dir", str(tmp / "ac"), "--sync-save"],
            [*torchrun, "sambert_hifigan_tpu_torch.train_vocoder", *common,
             "--checkpoint-dir", str(tmp / "voc"), "--save-precision", "bf16"]],
            [tmp / "ac.log", tmp / "voc.log"], DP_TIMEOUT_S)
        row["nccl"] = dict(wall_s=time.perf_counter() - t0, rcs=[rc for rc, _ in legs],
                           backend_lines=[line for _, out in legs for line in out.splitlines()
                                          if line.startswith("[dist]")],
                           checkpoints=[sorted(p.name for p in (tmp / d).glob("step_*"))
                                        for d in ("ac", "voc")])
        log("[dp] torchrun --nproc-per-node 1 (nccl)", json.dumps(row["nccl"]))
        for rc, out in legs:
            if rc != 0 or "backend nccl" not in out or "done at step 4" not in out:
                raise AssertionError(f"torchrun trainer (rc {rc}):\n{out[-3000:]}")
        if row["nccl"]["checkpoints"] != [["step_000000004"]] * 2:
            raise AssertionError(f"torchrun checkpoints: {row['nccl']['checkpoints']}")

        # the gloo leg: 2 ranks on cuda:0 against a control in this process,
        # every step of both held to the control (f32 at full width on the
        # card: the vocoder's trajectories do not part here as the tiny
        # config's do on the CPU, multiprocess_dp.gated_steps)
        dcfg = mp.comparable(cfg)
        runs = [mp.make_run("acoustic", dcfg, DP_AC_STEPS, DP_B, tph=64, tfrm=512),
                mp.make_run("vocoder", dcfg, DP_VOC_STEPS, DP_B, segment_frames=32,
                            loss_mode="adv_mel_fm", control_steps=DP_VOC_STEPS)]
        t0 = time.perf_counter()
        control = mp.run_plan(runs, dev)
        control_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = mp.launch(runs, DP_RANKS, "cuda", tmp / "dp", timeout=DP_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        bad, worst = mp.compare(runs, control, ranks)
        row["gloo"] = {"control_s": control_s, "launch_s": launch_s}
        log("[dp] multiprocess_dp wall", json.dumps(row["gloo"]))
        for i, run in enumerate(runs):
            res = [r[i] for r in ranks]
            row["gloo"][run["model"]] = dict(
                ranks=DP_RANKS, global_batch=DP_B, steps=run["steps"],
                step_ms=[r["step_ms"] for r in res],
                median_step_ms=[median(r["step_ms"][1:]) for r in res],
                control_step_ms=control[i]["step_ms"],
                control_median_step_ms=median(control[i]["step_ms"][1:]),
                reduce_ms=[r["reduce_ms"] for r in res],
                median_reduce_ms=[median(r["reduce_ms"][1:]) for r in res],
                reduce_mb_per_step=res[0]["reduce_mb_per_step"],
                peak_mib=[r["peak_mib"] for r in res], control_peak_mib=control[i]["peak_mib"],
                control_departure=worst[i], control_gated_steps=mp.gated_steps(run),
                lockstep_departure=[max(mp.departures(d, lk).items(), key=lambda kv: kv[1])
                                    for d, lk in zip(res[0]["history"], res[0]["lockstep"])],
                replicas_equal=len({r["digest"] for r in res}) == 1,
                final_loss=res[0]["history"][-1].get("total_loss",
                                                     res[0]["history"][-1].get("gen_loss")))
            log(f"[dp] multiprocess_dp {run['model']}, {DP_RANKS} ranks on {dev} (gloo)",
                json.dumps(row["gloo"][run["model"]]))
        if bad:
            raise AssertionError("multiprocess_dp against its controls:\n" + "\n".join(bad))

        # the NCCL leg's checkpoints through the kernels
        tts = build_pipeline(cfg, device=dev, acoustic_checkpoint=str(tmp / "ac"),
                             vocoder_checkpoint=str(tmp / "voc"))
        texts = TEXTS[:2]
        k1_0, k2_0 = k1.launches, k2.launches
        wavs = tts.synthesize_batch(texts)
        torch.cuda.synchronize()
        synth = {"ar_decode": k1.launches - k1_0, "mrf": k2.launches - k2_0}
        totals, want = expected_samples(tts, texts)
        row["synthesis"] = dict(texts=texts, totals=totals, wav_samples=[len(w) for w in wavs],
                                want=want, launches=synth)
        log("[dp] synthesis from the torchrun checkpoints", json.dumps(row["synthesis"]))
        for wav, n in zip(wavs, want):
            if wav.shape != (n,) or not np.isfinite(wav).all():
                raise AssertionError(f"synthesize_batch gave {wav.shape}, want {n}")
        if synth["ar_decode"] < 1 or synth["mrf"] != len(tts.mrf_weights) * synth["ar_decode"]:
            raise AssertionError(f"kernels on the torchrun checkpoints' path: {synth}")

        # the offline tools on a fresh toy corpus with the same checkpoints
        meta = make_toy_dataset(tmp / "toy", n=DP_TOY_UTTS, seed=DATA_SEED, verbose=False)
        k2_0 = k2.launches
        step, which, written = copy_synthesize(cfg, str(meta), str(tmp / "voc"),
                                               str(tmp / "copy"), device=dev)
        copy_k2 = k2.launches - k2_0
        scores = score_systems(cfg, tmp / "toy" / "wavs", [("dp", tmp / "copy")], device=dev)
        tf_step, tf_which, tf_vals = teacher_forced_mel_l1(cfg, str(meta), str(tmp / "ac"),
                                                            device=dev)
        row["tools"] = dict(copy_synth=dict(step=step, params=which, wavs=len(written),
                                            k2_launches=copy_k2),
                            eval_vocoder_waveform=scores["dp"],
                            eval_teacher_forced=dict(step=tf_step, params=tf_which,
                                                     mel_l1=[v for _, v in tf_vals]))
        log("[dp] copy_synth, eval_vocoder_waveform, eval_teacher_forced",
            json.dumps(row["tools"]))
        s = scores["dp"]
        if (len(written) != DP_TOY_UTTS or copy_k2 != len(tts.mrf_weights) * DP_TOY_UTTS
                or s["utterances"] != DP_TOY_UTTS
                or not all(np.isfinite(s[k]) for k in ("mel_mae", "mcd", "stft_mae"))
                or len(tf_vals) != DP_TOY_UTTS or not np.isfinite([v for _, v in tf_vals]).all()):
            raise AssertionError(f"offline tools: {row['tools']}")
    row["launches"] = {"ar_decode": k1.launches, "mrf": k2.launches}
    row["phase_s"] = time.perf_counter() - t_phase
    legs_s = row["nccl"]["wall_s"] + row["gloo"]["control_s"] + row["gloo"]["launch_s"]
    log(f"[dp] phase 10 took {row['phase_s']:.1f} s: torchrun {row['nccl']['wall_s']:.1f}, "
        f"control {row['gloo']['control_s']:.1f}, ranks {row['gloo']['launch_s']:.1f}, "
        f"synthesis and tools {row['phase_s'] - legs_s:.1f}")
    if row["phase_s"] > DP_PHASE_LIMIT_S:
        raise AssertionError(f"phase 10 took {row['phase_s']:.1f} s (limit {DP_PHASE_LIMIT_S})")
    return row


# ---- phase 11: the tooling --------------------------------------------------

# the kernels each profiler surface must show (and, on a train surface, none)
TOOL_SURFACES = {"e2e": {"K1", "K2"}, "decode": {"K1"}, "vocoder": {"K2"},
                 "train-acoustic": set(), "train-vocoder": set()}
# demangled names, e.g. "void (anonymous namespace)::ar_decode_kernel<256, 8, 16>(...)"
KERNEL_NAMES = {"K1": re.compile(r"(^|[\s:])ar_decode_kernel<"),
                "K2": re.compile(r"(^|[\s:])(chain|conv|operand)_kernel<")}
TOOLS_DEMO_UTTS, TOOLS_SCALING_DIMS = 8, (256, 512, 1024)
TOOLS_PHASE_LIMIT_S = 240.0  # a hung phase fails; the aim is under 90 s


def trace_kernels(path) -> dict:
    """{K1, K2: launches} read back from an exported Chrome trace's kernel
    events."""
    import gzip

    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat", "").lower() == "kernel"]
    return {k: sum(bool(rx.search(n)) for n in names) for k, rx in KERNEL_NAMES.items()}


def tools_profiling(tmp: Path) -> dict:
    """`python -m sambert_hifigan_tpu_torch.profiling` over the five surfaces
    at full width, 2 reps each: per call, the top kernels, the kernel count,
    busy ms against the wall ms without the profiler (and with it) and the
    device's idle share; K1 and K2 (read back from each exported trace)
    where they run, and only there."""
    from sambert_hifigan_tpu_torch import profiling

    rows = {}
    for surface, want in TOOL_SURFACES.items():
        res = profiling.main(["--surface", surface, "--reps", "2", "--top-ops", "5",
                              "--output", str(tmp / surface)])
        found = trace_kernels(res["trace"])
        rows[surface] = dict(busy_ms=res["busy_ms"], wall_ms=res["wall_ms"],
                             profiled_wall_ms=res["profiled_wall_ms"],
                             idle_share=res["idle_share"], kernels=res["kernels"],
                             device_ms=res["device_ms"], kernel_launches=found,
                             top=res["top"][:5])
        log(f"[tools] profiling {surface}", json.dumps(rows[surface]))
        if {k for k, n in found.items() if n} != want:
            raise AssertionError(f"profiling {surface}: kernels {found}, want {sorted(want)}")
    return rows


def tools_encode_split(dev) -> dict:
    """bench_encode_split: wall and device ms of enc, dec and full at B = 1;
    dec(enc()) against full()."""
    from sambert_hifigan_tpu_torch import bench_encode_split as split

    fns = split.build(device=dev)
    row = {}
    for name in ("enc", "dec", "full"):
        dev_row = split.device_ms(fns[name], inner=3)
        row[name] = dict(wall_ms=split.wall(fns[name], "cuda", reps=3, inner=5),
                         busy_ms=dev_row["busy_ms"], kernels=dev_row["kernels"],
                         profiled_wall_ms=dev_row["wall_ms"], top=dev_row["top"][:3])
    row["dec_of_enc_vs_full_max_abs"] = float(
        (fns["decode"](fns["enc"]()) - fns["full"]()).abs().max())
    log("[tools] bench_encode_split", json.dumps(row))
    if row["dec_of_enc_vs_full_max_abs"] > K1_TOL_MAX:
        raise AssertionError(f"dec(enc()) departs from full(): {row}")
    return row


def tools_decode_modes(dev) -> dict:
    """bench_decode_modes: K1 (2 reps) against the plain decode (1 rep after
    its warm-up) at B = 1, T = 512; the checksums (and every frame) within
    phase 2's K1 tolerance."""
    from sambert_hifigan_tpu_torch import bench_decode_modes as modes

    w, memory = modes.build(dev)
    kernel, out_k = modes.run_mode("kernel", w, memory, reps=2, inner=1)
    plain, out_p = modes.run_mode("plain", w, memory, reps=1, inner=1)
    err = (out_k - out_p).abs()
    row = dict(kernel=kernel, plain=plain, checksum_diff=abs(kernel["checksum"]
                                                             - plain["checksum"]),
               max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
               speedup=plain["ms"] / kernel["ms"])
    log("[tools] bench_decode_modes", json.dumps(row))
    if not (row["checksum_diff"] <= K1_TOL_MEAN * out_p.numel()
            and row["mean_abs_err"] < K1_TOL_MEAN and row["max_abs_err"] < K1_TOL_MAX):
        raise AssertionError(f"K1 against the plain decode: {row}")
    return row


def tools_scaling(dev) -> list:
    """bench_scaling at d = 256, 512, 1024, B = 16: a warm-up and 3 timed
    steps each."""
    from sambert_hifigan_tpu_torch import bench_scaling

    rows = bench_scaling.run(TOOLS_SCALING_DIMS, [16], device=dev, reps=1, k=3)
    log("[tools] bench_scaling", json.dumps(rows))
    if [r["d_model"] for r in rows] != list(TOOLS_SCALING_DIMS) or not all(
            math.isfinite(r["mfu"]) and r["mfu"] > 0 for r in rows):
        raise AssertionError(f"bench_scaling rows: {rows}")
    return rows


def tools_debug(pipe) -> dict:
    """utils/debug on a pipeline tensor on the card: assert_shape passes and
    raises, trace_shape prints once for two calls of one signature."""
    import contextlib
    import io
    import os

    from sambert_hifigan_tpu_torch.utils import debug

    mel = pipe.text_to_mel([TEXTS[0]]).mel_pred
    debug.assert_shape(mel, (1, None, pipe.cfg.audio.n_mels), "mel_pred")
    try:
        debug.assert_shape(mel, (2, None, pipe.cfg.audio.n_mels), "mel_pred")
        raised = None
    except AssertionError as e:
        raised = str(e)
    buf, saved = io.StringIO(), os.environ.get("DEBUG_SHAPES")
    os.environ["DEBUG_SHAPES"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            debug.trace_shape("phase11_mel_pred", mel)
            debug.trace_shape("phase11_mel_pred", mel)
    finally:
        if saved is None:
            del os.environ["DEBUG_SHAPES"]
        else:
            os.environ["DEBUG_SHAPES"] = saved
    lines = buf.getvalue().splitlines()
    row = dict(device=mel.device.type, raised=raised, trace_lines=lines)
    log("[tools] utils/debug", json.dumps(row))
    want = f"[trace-shape] phase11_mel_pred: {tuple(mel.shape)}:float32"
    if (mel.device.type != "cuda" or lines != [want]
            or raised != f"mel_pred: dim 0 expected 2, got 1 (shape {tuple(mel.shape)})"):
        raise AssertionError(f"utils/debug: {row}")
    return row


def tools_plot(pipe, dev) -> dict:
    """plot_audio's ten panel arrays of one synthesized wav on the card
    against the CPU: log-mel, F0 and energy within phase 9's bounds."""
    import numpy as np

    from sambert_hifigan_tpu_torch.plot_audio import ALL_PANELS, panel_arrays

    audio = pipe.cfg.audio
    wav = pipe.synthesize(TEXTS[0])[None]
    panels = ALL_PANELS.split(",")
    card = panel_arrays(wav, audio.sample_rate, panels, audio, dev)
    cpu = panel_arrays(wav, audio.sample_rate, panels, audio, "cpu")
    d = np.abs(card["mel"] - cpu["mel"])
    loud = cpu["mel"] > DATA_MEL_LOUD
    (f0_a, v_a), (f0_b, v_b) = card["f0"], cpu["f0"]
    both = v_a & v_b
    row = dict(samples=wav.shape[-1], panels=sorted(set(panels) & set(card)),
               mel_max_abs=float(d.max()), mel_max_abs_loud=float(d[loud].max()),
               energy_max_abs=float(np.abs(card["energy"] - cpu["energy"]).max()),
               f0_max_rel=float((np.abs(f0_a - f0_b)[both] / f0_b[both]).max())
               if both.any() else 0.0,
               voiced_flip_share=float((v_a != v_b).mean()), voiced_frames=int(v_b.sum()),
               frames=int(v_b.size))
    log("[tools] plot_audio panels, card vs CPU", json.dumps(row))
    if not (row["panels"] == sorted(panels) and row["mel_max_abs"] <= DATA_MEL_TOL
            and row["mel_max_abs_loud"] <= DATA_MEL_TOL_LOUD
            and row["energy_max_abs"] <= DATA_ENERGY_TOL and row["f0_max_rel"] <= DATA_F0_REL
            and row["voiced_flip_share"] <= DATA_FLIP_SHARE):
        raise AssertionError(f"plot_audio panels on the card depart from the CPU's: {row}")
    return row


def tools_demo_eval(tmp: Path) -> dict:
    """make_demo_dataset --n 8, checkpoints of its own (train_acoustic and
    train_vocoder --synthetic 2), then eval_demo_run on them: copy synthesis
    through K2, full TTS through K1 and K2."""
    import numpy as np

    from sambert_hifigan_tpu_torch import (eval_demo_run, make_demo_dataset, train_acoustic,
                                           train_vocoder)
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2

    meta = make_demo_dataset.main(["--output", str(tmp / "demo"), "--n",
                                   str(TOOLS_DEMO_UTTS)])
    logs = ["--log-dir", str(tmp / "logs")]
    train_acoustic.main(["--synthetic", "2", "--checkpoint-dir", str(tmp / "ac"), "--sync-save",
                         *logs])
    train_vocoder.main(["--synthetic", "2", "--checkpoint-dir", str(tmp / "voc"),
                        "--save-precision", "bf16", *logs])
    k1_0, k2_0 = k1.launches, k2.launches
    t0 = time.perf_counter()
    res = eval_demo_run.main(["--metadata", str(meta), "--acoustic-checkpoint", str(tmp / "ac"),
                              "--vocoder-checkpoint", str(tmp / "voc"), "--n",
                              str(TOOLS_DEMO_UTTS), "--output-dir", str(tmp / "eval")])
    launches = {"ar_decode": k1.launches - k1_0, "mrf": k2.launches - k2_0}
    row = dict(steps=res["steps"], avg=res["avg"], launches=launches,
               eval_s=time.perf_counter() - t0,
               wavs=len(list((tmp / "eval").glob("*.wav"))))
    log("[tools] make_demo_dataset, eval_demo_run", json.dumps(row))
    finite = all(np.isfinite(r[k]) for r in res["rows"]
                 for k in ("copy_mel_mae", "copy_mcd", "tts_mel_mae_dtw", "tts_mcd"))
    if (len(res["rows"]) != TOOLS_DEMO_UTTS or not finite or res["steps"] != (2, 2)
            or row["wavs"] != 2 * TOOLS_DEMO_UTTS or launches["ar_decode"] < TOOLS_DEMO_UTTS
            or launches["mrf"] != 4 * (TOOLS_DEMO_UTTS + launches["ar_decode"])):
        raise AssertionError(f"eval_demo_run: {row}")
    return row


def tools_demos() -> dict:
    """Both demos at the default config on the card."""
    from sambert_hifigan_tpu_torch import demo_ablation_modes, demo_feature_matching_loss

    modes = demo_ablation_modes.main([])
    loss, fm = demo_feature_matching_loss.main([])
    per_disc = [fm[f"gen_fm_loss_disc_{i}"] for i in range(8)]
    row = dict(ablation={m: {k: v for k, v in r.items()
                             if k in ("gen_loss", "disc_loss", "discriminators_trained")}
                         for m, r in modes.items()},
               fm_total=loss, gen_fm_loss=fm["gen_fm_loss"], gen_fm_loss_disc=per_disc)
    log("[tools] demo_ablation_modes, demo_feature_matching_loss", json.dumps(row))
    zero_mel_only = ("disc_loss", "d_grad_norm", "gen_adv_loss", "gen_fm_loss", "gen_stft_loss")
    ok = (sorted(k for k in modes["adv_mel_fm"] if k != "discriminators_trained") == TRAIN_KEYS
          and [modes[m]["discriminators_trained"] for m in modes] == [False, True, True]
          and all(modes["mel_only"][k] == 0.0 for k in zero_mel_only)
          and modes["adv_mel"]["gen_fm_loss"] == 0.0
          and all(math.isfinite(v) for r in modes.values() for v in r.values())
          and abs(fm["gen_fm_loss"] - sum(per_disc) / 8) <= 1e-5 * abs(fm["gen_fm_loss"])
          and math.isfinite(loss))
    if not ok:
        raise AssertionError(f"the demos: {row}")
    return row


def phase_tools(pipe, dev):
    """The port's tooling on the card: the profiler over every surface (with
    the device's idle share), the encode split, K1 against the plain decode
    (bench_decode_modes), width scaling of the acoustic step, shape
    debugging, plot panels against the CPU, a demo corpus evaluated through
    both kernels, both demos, and the 2-rank dryrun over gloo."""
    import tempfile

    from sambert_hifigan_tpu_torch.dryrun import dryrun_multichip
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2

    t_phase = time.perf_counter()
    k1.launches = 0
    k2.launches = 0
    row, secs = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        row[name] = fn(*args)
        secs[name] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        timed("profiling", tools_profiling, tmp / "profile")
        timed("encode_split", tools_encode_split, dev)
        timed("decode_modes", tools_decode_modes, dev)
        timed("scaling", tools_scaling, dev)
        timed("debug", tools_debug, pipe)
        timed("plot", tools_plot, pipe, dev)
        timed("demo_eval", tools_demo_eval, tmp)
        timed("demos", tools_demos)
        timed("dryrun", dryrun_multichip, 2)
    if row["dryrun"] is not True:
        raise AssertionError("dryrun_multichip(2): stage dp did not pass")
    row["launches"] = {"ar_decode": k1.launches, "mrf": k2.launches}
    row["seconds"] = secs
    row["phase_s"] = time.perf_counter() - t_phase
    log("[tools]", json.dumps(row))
    log(f"[tools] phase 11 took {row['phase_s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    if row["phase_s"] > TOOLS_PHASE_LIMIT_S:
        raise AssertionError(f"phase 11 took {row['phase_s']:.1f} s (limit {TOOLS_PHASE_LIMIT_S})")
    return row


# ---- phase 12: tensor parallelism -------------------------------------------

TP_RANKS, TP_MODEL, TP_STEPS, TP_B, TP_TIMEOUT_S = 2, 2, 3, 16, 300
# a hung phase fails; the aim is under 150 s
TP_PHASE_LIMIT_S = 300.0


def _tp_departure(res: dict, control: dict) -> dict:
    """How far a TP run's metrics and gathered parameters are from its
    control's: the largest relative departure of any metric at any step,
    the parameters' largest absolute one, and how many of each differ."""
    from sambert_hifigan_tpu_torch.multiprocess_dp import departures

    metric = [max(departures(d, c).values()) for d, c in zip(res["history"], control["history"])]
    diffs = {k: float((res["params"][k] - v).abs().max()) for k, v in control["params"].items()}
    return dict(metric_departure=metric, metrics_unequal=sum(
        d != c for d, c in zip(res["history"], control["history"])),
        param_max_abs=max(diffs.values()), params_unequal=sum(v != 0 for v in diffs.values()),
        params=len(diffs))


def phase_tp(pipe, dev):
    """Tensor parallelism over a model axis (`--model-parallel`).  The main
    leg: `multiprocess_dp` with 2 ranks on the one card (gloo) laid out as
    data 1 x model 2, at the default config's full width in its own mixed
    precision (bf16) with dropout on, the acoustic model (B = 16,
    synthetic_batch(tph 64, tfrm 512), phase 8's shape) and the vocoder
    (adv_mel_fm, B = 16 x 32 frames, phase 7's), 3 steps each, against a
    single-process control of the same batches in this process, both in
    deterministic mode.  The ranks see the control's rows and gather its
    whole weights, so every metric and the gathered parameters must be
    bit-equal (TP_BOUND); each rank's persistent state (parameters, Adam
    moments) against the control's, step and gather ms (two ranks on one
    card measure correctness and state size, not scaling), peak memory.
    Then both trainers under `torch.distributed.run --nproc-per-node 2
    --model-parallel 2` side by side (the vocoder saving in bf16), their
    checkpoints through K1 and K2 (`build_pipeline`, `synthesize_batch`),
    and the dryrun's "dp x tp" stage at 4 ranks (data 2 x model 2)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch import multiprocess_dp as mp
    from sambert_hifigan_tpu_torch.dryrun import dryrun_multichip
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline

    t_phase = time.perf_counter()
    cfg = pipe.cfg
    row, secs = {}, {}
    k1.launches = 0
    k2.launches = 0
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # the control's, as the ranks'
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = dict(model_parallel=TP_MODEL, params=True, deterministic=True)
        runs = [mp.make_run("acoustic", cfg, TP_STEPS, TP_B, tph=64, tfrm=512, **common),
                mp.make_run("vocoder", cfg, TP_STEPS, TP_B, segment_frames=32,
                            loss_mode="adv_mel_fm", **common)]
        t0 = time.perf_counter()
        control = mp.run_plan(runs, dev)
        secs["control"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = mp.launch(runs, TP_RANKS, "cuda", tmp / "tp", timeout=TP_TIMEOUT_S)
        secs["ranks"] = time.perf_counter() - t0
        bad, _ = mp.compare(runs, control, ranks)
        for i, run in enumerate(runs):
            res = [r[i] for r in ranks]
            ctl = control[i]
            dep = [_tp_departure(r, ctl) for r in res]
            row[run["model"]] = dict(
                ranks=TP_RANKS, data=TP_RANKS // TP_MODEL, model=TP_MODEL, global_batch=TP_B,
                steps=TP_STEPS, mixed_precision=getattr(cfg.training, run["model"]).mixed_precision,
                departure=dep,
                persistent_mib=[r["persistent_numel"] * 4 / 2 ** 20 for r in res],
                control_persistent_mib=ctl["persistent_numel"] * 4 / 2 ** 20,
                median_step_ms=[median(r["step_ms"][1:]) for r in res],
                median_gather_ms=[median(r["gather_ms"][1:]) for r in res],
                gather_mb_per_step=res[0]["gather_mb_per_step"],
                control_median_step_ms=median(ctl["step_ms"][1:]),
                peak_mib=[r["peak_mib"] for r in res], control_peak_mib=ctl["peak_mib"],
                nondeterministic=sorted(set(ctl["nondeterministic"]).union(
                    *[r["nondeterministic"] for r in res])),
                final=res[0]["history"][-1].get("total_loss",
                                                res[0]["history"][-1].get("gen_loss")))
            log(f"[tp] {run['model']}, data 1 x model {TP_MODEL} on one card (gloo) against "
                "one process", json.dumps(row[run["model"]]))
            for r, d in enumerate(dep):
                if d["metrics_unequal"] or d["params_unequal"]:
                    bad.append(f"{run['model']} rank {r}: {d} (bound: bit-equal)")
            if not all(r["persistent_numel"] < ctl["persistent_numel"] * 0.75 for r in res):
                bad.append(f"{run['model']}: per-rank state {row[run['model']]['persistent_mib']}"
                           f" MiB against the control's {row[run['model']]['control_persistent_mib']}")
        if bad:
            raise AssertionError("tensor parallelism against its controls:\n" + "\n".join(bad))

        # both trainers under torchrun at --model-parallel 2, then their
        # checkpoints through the kernels
        t0 = time.perf_counter()
        torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(TP_RANKS), "-m"]
        flags = ["--synthetic", "2", "--model-parallel", str(TP_MODEL), "--log-dir",
                 str(tmp / "logs")]
        legs = mp.run_procs([
            [*torchrun, "sambert_hifigan_tpu_torch.train_acoustic", *flags,
             "--checkpoint-dir", str(tmp / "ac")],
            [*torchrun, "sambert_hifigan_tpu_torch.train_vocoder", *flags,
             "--checkpoint-dir", str(tmp / "voc"), "--save-precision", "bf16"]],
            [tmp / "ac.log", tmp / "voc.log"], TP_TIMEOUT_S)
        secs["torchrun"] = time.perf_counter() - t0
        row["torchrun"] = dict(rcs=[rc for rc, _ in legs], checkpoints=[
            sorted(p.name for p in (tmp / d).glob("step_*")) for d in ("ac", "voc")])
        log("[tp] torchrun --model-parallel 2", json.dumps(row["torchrun"]))
        for rc, out in legs:
            if rc != 0 or out.count("(data 1 x model 2)") != TP_RANKS \
                    or "done at step 2" not in out:
                raise AssertionError(f"torchrun --model-parallel (rc {rc}):\n{out[-3000:]}")
        tts = build_pipeline(cfg, device=dev, acoustic_checkpoint=str(tmp / "ac"),
                             vocoder_checkpoint=str(tmp / "voc"))
        texts = TEXTS[:2]
        wavs = tts.synthesize_batch(texts)
        torch.cuda.synchronize()
        synth = {"ar_decode": k1.launches, "mrf": k2.launches}
        totals, want = expected_samples(tts, texts)
        row["synthesis"] = dict(totals=totals, wav_samples=[len(w) for w in wavs], want=want,
                                launches=synth)
        log("[tp] synthesis from the --model-parallel checkpoints", json.dumps(row["synthesis"]))
        for wav, n in zip(wavs, want):
            if wav.shape != (n,) or not np.isfinite(wav).all():
                raise AssertionError(f"synthesize_batch gave {wav.shape}, want {n}")
        if synth["ar_decode"] < 1 or synth["mrf"] != len(tts.mrf_weights) * synth["ar_decode"]:
            raise AssertionError(f"kernels on the TP checkpoints' path: {row['synthesis']}")

    t0 = time.perf_counter()
    row["dryrun"] = dryrun_multichip(4)
    secs["dryrun"] = time.perf_counter() - t0
    if row["dryrun"] is not True:
        raise AssertionError("dryrun_multichip(4): stage dp or dp x tp did not pass")
    row["launches"] = {"ar_decode": k1.launches, "mrf": k2.launches}
    row["seconds"] = secs
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase 12 took {row['phase_s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    if row["phase_s"] > TP_PHASE_LIMIT_S:
        raise AssertionError(f"phase 12 took {row['phase_s']:.1f} s (limit {TP_PHASE_LIMIT_S})")
    return row


# ---- phase 13: data-parallel serving over several replicas --------------------

MESH_PHASE_LIMIT_S = 90.0  # a hung phase fails; the aim is under 45 s
# the split batch against `pipe`'s B = 4 call: the stream's bound.  The
# replicas run B = 2 where `pipe` runs B = 4, so cuBLAS, cuDNN and K1's plan
# may sum in another order, and K1's bf16 feedback carries a flipped rounding
MESH_TOL_MAX = STREAM_TOL_MAX
MESH_WARM, MESH_REPS = 2, 5
# ~20 frames a phoneme (the duration predictor's bias raised, its kernel
# scaled by 0.1): in the order below, 33 and 40 phonemes fit the 1024-frame
# first bucket and 42 and 58 do not, so only the second replica overflows
MESH_DURATION_BIAS = 3.1
MESH_OVERFLOW_TEXTS = [TEXTS[3], TEXTS[0], TEXTS[1], TEXTS[2]]


@contextlib.contextmanager
def replica_calls(split, name: str):
    """Record the positional arguments of every call of each replica's
    `name` method while the block runs: [[args, ...] of each replica]."""
    calls = [[] for _ in split.replicas]
    for r, rep in enumerate(split.replicas):
        def call(*args, _real=getattr(rep, name), _r=r):
            calls[_r].append(args)
            return _real(*args)
        setattr(rep, name, call)
    try:
        yield calls
    finally:
        for rep in split.replicas:
            delattr(rep, name)


def synced(devices) -> None:
    import torch

    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def replica_bits(split, single, texts, wavs, bucket):
    """For each replica: whether its returned rows are the bits of
    single.synthesize_batch(its rows, max_frames=bucket)."""
    d = len(split.replicas)
    padded = list(texts) + [texts[-1]] * (-len(texts) % d)
    per = len(padded) // d
    out = []
    for r in range(d):
        rows = padded[r * per:(r + 1) * per]
        got = wavs[r * per:(r + 1) * per]  # the padding rows are not returned
        want = single.synthesize_batch(rows, max_frames=bucket)[:len(got)]
        out.append(all(a.shape == b.shape and (a == b).all() for a, b in zip(got, want)))
    return out


def mesh_leg(pipe, slow, devices, smi):
    """One card list: per-replica bits, one frame bucket, the other entry
    points, the batcher, warm times, launches."""
    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import TTSPipeline, build_pipeline_from_random_init
    from sambert_hifigan_tpu_torch.serving import DynamicBatcher

    bad = []
    split = build_pipeline_from_random_init(pipe.cfg, seed=0, devices=devices)
    d = len(split.replicas)
    row = dict(devices=[str(x) for x in split.devices], replicas=d)

    # the batch of the main path: lengths, each replica's bits, the B = 4 call
    totals, want = expected_samples(pipe, TEXTS)
    bucket = batch_frame_bucket(pipe, TEXTS, totals)
    wavs = split.synthesize_batch(TEXTS)
    ref = pipe.synthesize_batch(TEXTS)
    lengths = [len(w) for w in wavs]
    row["batch"] = dict(frame_bucket=bucket, lengths=lengths, want=want,
                        replica_bit_equal=replica_bits(split, pipe, TEXTS, wavs, bucket),
                        max_abs_vs_b4=max(float(np.abs(a - b).max()) for a, b in zip(wavs, ref)
                                          if a.shape == b.shape))
    if lengths != want or lengths != [len(w) for w in ref]:
        bad.append(f"lengths {lengths}, want {want}, pipe's {[len(w) for w in ref]}")
    if not all(row["batch"]["replica_bit_equal"]):
        bad.append(f"replica rows against direct calls: {row['batch']['replica_bit_equal']}")
    if not all(np.isfinite(w).all() for w in wavs):
        bad.append("non-finite samples")
    if row["batch"]["max_abs_vs_b4"] > MESH_TOL_MAX:
        bad.append(f"max |diff| against pipe's B = 4 call {row['batch']['max_abs_vs_b4']} "
                   f"> {MESH_TOL_MAX}")

    # one frame bucket: only the last replica's rows overflow the first one
    slow_split = TTSPipeline(slow.cfg, slow.acoustic.state_dict(), slow.generator.state_dict(),
                             devices=devices)
    texts = MESH_OVERFLOW_TEXTS
    padded = texts + [texts[-1]] * (-len(texts) % d)
    per = len(padded) // d
    full = slow.text_to_mel(padded, max_frames=max(slow.cfg.runtime.frame_buckets))
    totals_b = full.total_frames.cpu().tolist()
    first = slow._initial_bucket(slow._features(texts)[0], 1.0)
    second = batch_frame_bucket(slow, texts, totals_b)
    with replica_calls(slow_split, "_acoustic") as calls:
        wavs_b = slow_split.synthesize_batch(texts)
    ref_b = slow.synthesize_batch(texts)
    row["one_bucket"] = dict(
        totals=totals_b, first_bucket=first, new_bucket=second,
        replica_buckets=[[c[1] for c in cs] for cs in calls],
        lengths=[len(w) for w in wavs_b], pipe_lengths=[len(w) for w in ref_b],
        replica_bit_equal=replica_bits(slow_split, slow, texts, wavs_b, second))
    if not (max(totals_b[:per]) <= first < max(totals_b[-per:])):
        bad.append(f"overflow batch: totals {totals_b} do not overflow {first} in the last "
                   "replica only")
    if row["one_bucket"]["replica_buckets"] != [[first, second]] * d:
        bad.append(f"replica buckets {row['one_bucket']['replica_buckets']}, want "
                   f"{[[first, second]] * d}")
    if row["one_bucket"]["lengths"] != row["one_bucket"]["pipe_lengths"]:
        bad.append(f"overflow batch lengths {row['one_bucket']}")
    if not all(row["one_bucket"]["replica_bit_equal"]):
        bad.append(f"overflow batch rows against direct calls: {row['one_bucket']}")

    # text_to_mel: the padded row count, pipe's totals
    mel_out = split.text_to_mel(TEXTS[:3])
    padded_rows = 3 + (-3 % d)
    got_totals = mel_out.total_frames.cpu().tolist()
    pipe_totals = pipe.text_to_mel(TEXTS[:3]).total_frames.cpu().tolist()
    row["text_to_mel"] = dict(rows=mel_out.mel_pred.shape[0], want_rows=padded_rows,
                              totals=got_totals, pipe_totals=pipe_totals,
                              device=str(mel_out.mel_pred.device))
    if (mel_out.mel_pred.shape[0] != padded_rows or got_totals[:3] != pipe_totals
            or mel_out.mel_pred.device != split.device):
        bad.append(f"text_to_mel: {row['text_to_mel']}")

    # vocode: 2 rows a replica (split), then one row fewer (devices[0])
    mel = pipe.text_to_mel(TEXTS).mel_pred
    mel = mel[torch.arange(2 * d) % mel.shape[0]]
    with replica_calls(split, "_vocode") as calls:
        wav = split.vocode(mel)
    divisible = [bool(torch.equal(wav[2 * r:2 * r + 2], pipe.vocode(mel[2 * r:2 * r + 2])))
                 for r in range(d)]
    ran = [len(c) for c in calls]
    with replica_calls(split, "_vocode") as calls:
        wav_nd = split.vocode(mel[:-1])
    row["vocode"] = dict(rows=[2 * d, 2 * d - 1], replica_bit_equal=divisible,
                         replica_calls=[ran, [len(c) for c in calls]],
                         undivided_bit_equal=bool(torch.equal(wav_nd, pipe.vocode(mel[:-1]))),
                         device=str(wav.device))
    if not all(divisible) or ran != [1] * d or wav.device != split.device:
        bad.append(f"vocode of {2 * d} rows: {row['vocode']}")
    if not row["vocode"]["undivided_bit_equal"] or row["vocode"]["replica_calls"][1] != \
            [1] + [0] * (d - 1):
        bad.append(f"vocode of {2 * d - 1} rows: {row['vocode']}")

    # stream: unsplit on devices[0], pipe's bits
    got = list(split.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT))
    ref_s = list(pipe.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT))
    row["stream"] = dict(chunks=len(got), bit_equal=len(got) == len(ref_s) and all(
        a.shape == b.shape and (a == b).all() for a, b in zip(got, ref_s)))
    if not row["stream"]["bit_equal"]:
        bad.append(f"stream against pipe.stream: {row['stream']}")

    # warmup: every leg on every replica
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    with replica_calls(split, "_acoustic") as calls:
        split.warmup(max_frames=1024, batch_buckets=True)
    synced(split.devices)
    legs = len(pipe.cfg.runtime.phoneme_buckets) + len(pipe.cfg.runtime.batch_buckets)
    row["warmup"] = dict(s=time.perf_counter() - t0, replica_calls=[len(c) for c in calls],
                         launches={"ar_decode": k1.launches, "mrf": k2.launches})
    if row["warmup"]["replica_calls"] != [legs] * d:
        bad.append(f"warmup: {row['warmup']}, want {legs} acoustic passes on each replica")

    # the batcher: the 4 texts as concurrent requests
    batcher = DynamicBatcher(split, max_batch=4, max_wait_ms=50)
    results = [None] * len(TEXTS)
    go = threading.Barrier(len(TEXTS))

    def client(i):
        go.wait()
        try:
            results[i] = len(batcher.synthesize(TEXTS[i], timeout=300))
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = repr(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(TEXTS))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        batcher.close()
    row["batcher"] = dict(lengths=results, want=want, **{
        k: v for k, v in batcher.stats().items() if k in ("batches_run", "requests_served")})
    if results != want:
        bad.append(f"the batcher over the split pipeline: {row['batcher']}")

    # warm ms in turns, each call ending in a synchronize of every card
    def timed(tts):
        t0 = time.perf_counter()
        tts.synthesize_batch(TEXTS)
        synced(split.devices)
        return (time.perf_counter() - t0) * 1e3

    ms = {"split": [], "single": []}
    for i in range(MESH_WARM + MESH_REPS):
        for name, tts in (("split", split), ("single", pipe))[::1 if i % 2 else -1]:
            ms[name].append(timed(tts))
    row["warm_ms"] = {k: median(v[MESH_WARM:]) for k, v in ms.items()}

    # the launches of one split synthesize_batch
    synced(split.devices)
    k1.launches = k2.launches = 0
    split.synthesize_batch(TEXTS)
    synced(split.devices)
    row["launches"] = {"ar_decode": k1.launches, "mrf": k2.launches}
    if row["launches"] != {"ar_decode": d, "mrf": len(split.mrf_weights) * d}:
        bad.append(f"launches of one split synthesize_batch: {row['launches']}, want "
                   f"{d} and {len(split.mrf_weights) * d}")
    share = ("replicas share one card and its stream: a correctness leg, not scaling"
             if len(set(devices)) < d else "one replica a card")
    log(f"[mesh] devices {row['devices']} ({share}); {smi}:", json.dumps(row))
    if bad:
        raise AssertionError(f"phase 13 on {devices}:\n" + "\n".join(bad))
    return row


def phase_mesh(pipe, dev):
    """Data-parallel serving, `TTSPipeline(devices=...)`, the counterpart of
    the JAX pipeline's `mesh=`: the default config at full width and depth
    with `pipe`'s weights (seed 0), the four TEXTS.  The card lists: two
    replicas on the one card (["cuda:0", "cuda:0"]), then every visible card
    where there are more than one.  Each list: the batch's lengths equal
    `pipe`'s and each replica's rows bit-equal to a direct call on those
    rows at the batch's frame bucket, the max |diff| against `pipe`'s B = 4
    call within MESH_TOL_MAX; a batch whose last replica alone overflows the
    first frame bucket (MESH_DURATION_BIAS), every replica re-run at the one
    new bucket; `text_to_mel` (the padded row count, `pipe`'s totals);
    `vocode` at a row count the replicas divide and one they do not;
    `stream` bit-equal to `pipe.stream`; `warmup(max_frames=1024,
    batch_buckets=True)` on every replica; a DynamicBatcher answering the
    four texts as concurrent requests; warm ms of the split and the single
    call in turns, median of 5 after 2; the launches of one split call."""
    import torch

    from sambert_hifigan_tpu_torch.pipeline import TTSPipeline
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model, random_generator

    t_phase = time.perf_counter()
    cfg = pipe.cfg
    gen = torch.Generator().manual_seed(0)
    acoustic = random_acoustic_model(cfg, gen).state_dict()
    generator = random_generator(cfg, gen).state_dict()
    lin = "variance_adaptor.duration_predictor.linear."
    acoustic[lin + "bias"] = torch.full_like(acoustic[lin + "bias"], MESH_DURATION_BIAS)
    acoustic[lin + "weight"] = acoustic[lin + "weight"] * 0.1
    slow = TTSPipeline(cfg, acoustic, generator, device=dev)
    card_lists = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        card_lists.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    smi = nvidia_smi_line()
    row = {"legs": [mesh_leg(pipe, slow, devices, smi) for devices in card_lists]}
    row["launches"] = row["legs"][0]["launches"]
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 13 took {row['phase_s']:.1f} s over the card lists "
        f"{[leg['devices'] for leg in row['legs']]}")
    if row["phase_s"] > MESH_PHASE_LIMIT_S:
        raise AssertionError(f"phase 13 took {row['phase_s']:.1f} s (limit {MESH_PHASE_LIMIT_S})")
    return row


# ---- phase 14: bf16 inference ------------------------------------------------

BF16_PHASE_LIMIT_S = 180.0  # a hung phase fails; the aim is under 90 s
# the bf16 pipeline's wav against the f32 pipeline's on the same weights, max
# |diff| of each row: the bound PERF.md predicted before the first run (the
# CPU's plain versions at full width, f32 pipeline over bf16 kernel weights,
# gave 1.3e-3 to 2.4e-3, equal durations)
BF16_VS_F32_MAX = 1e-2


def mrf_inputs(tts, mel):
    """Each MRF's input and weights as tts.vocode(mel) hands them to K2's
    wrapper: [(x, weights)] in stage order."""
    from sambert_hifigan_tpu_torch.models import hifigan

    seen, real = [], hifigan.mrf

    def record(x, w):
        seen.append((x.clone(), w))
        return real(x, w)

    hifigan.mrf = record
    try:
        tts.vocode(mel)
    finally:
        hifigan.mrf = real
    return seen


def bf16_kernels(bf):
    """K1 and K2 at the bf16 path's own inputs against their plain versions,
    at phases 2 and 3's tolerances: K1 on the memory K/V of the four texts'
    bf16 encode (and chained in chunks, bit for bit), K2 on each MRF's input
    in the bf16 vocode of their bf16 mel."""
    import torch

    from sambert_hifigan_tpu_torch.models.ar_decoder import decode_memory
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2

    totals, _ = expected_samples(bf, TEXTS)
    t = batch_frame_bucket(bf, TEXTS, totals)
    _, args = bf._frontend_args(TEXTS)
    w = bf.decode_weights
    with torch.no_grad():
        va = bf._encode(args, t, 1.0, 0.0, 1.0)
        memory = decode_memory(bf.acoustic.ar_decoder, va.hvar, ~va.frame_mask, w)
    out = k1.ar_decode(w, *memory, t)
    t0 = time.perf_counter()
    ref = k1.ar_decode_plain(w, *memory, k1.init_carry(w, out.shape[0], t), 0, t)[1]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out - ref).abs()
    k1_row = dict(B=out.shape[0], T=t, hvar_dtype=str(va.hvar.dtype),
                  memory_dtype=str(memory.mem_k.dtype), max_abs_err=err.max().item(),
                  mean_abs_err=err.mean().item(), ms=cuda_ms(lambda: k1.ar_decode(w, *memory, t),
                                                             reps=2),
                  plain_ms=plain_ms,
                  chained_bit_equal=bool(torch.equal(k1_chain(w, *memory, t, CHUNK), out)))
    bad = []
    if not (torch.isfinite(out).all() and k1_row["mean_abs_err"] < K1_TOL_MEAN
            and k1_row["max_abs_err"] < K1_TOL_MAX):
        bad.append(f"K1 on the bf16 path's inputs: {k1_row}")
    if not k1_row["chained_bit_equal"]:
        bad.append("chained K1 differs from one-shot K1 on the bf16 path's inputs")
    mel = bf.text_to_mel(TEXTS).mel_pred
    k2_rows = []
    for i, (x, mw) in enumerate(mrf_inputs(bf, mel)):
        got, want = k2.mrf(x, mw), k2.mrf_plain(x, mw)
        e = (got - want).abs()
        row = dict(stage=i, C=x.shape[1], B=x.shape[0], T=x.shape[2],
                   input_is_bf16=bool(torch.equal(x, x.bfloat16().float())),
                   max_abs_err=e.max().item(), ms=cuda_ms(lambda: k2.mrf(x, mw), reps=3),
                   plain_ms=cuda_ms(lambda: k2.mrf_plain(x, mw), reps=1))
        k2_rows.append(row)
        if not (torch.isfinite(got).all() and row["max_abs_err"] < K2_TOL_MAX
                and row["input_is_bf16"]):
            bad.append(f"K2 on the bf16 path's inputs: {row}")
    return k1_row, k2_rows, bad


def phase_bf16(pipe):
    """bf16 inference, the JAX `TTSPipeline(dtype=jnp.bfloat16)`: `pipe`'s
    weights (seed 0) at full width in bf16.  `synthesize_batch(TEXTS)` and
    `stream(TEXTS[0])` with the counts set to 0 before each and read after
    (K1 and K2 must launch as the path needs); wav lengths from
    `total_frames`; the stream within STREAM_TOL_MAX of its `synthesize`;
    each row's wav against the f32 pipeline's within BF16_VS_F32_MAX (and
    equal lengths); warm ms of both pipelines' batch and first stream chunk
    in turns; K1 and K2 at the bf16 path's inputs against their plain
    versions (`bf16_kernels`)."""
    import numpy as np
    import torch

    from sambert_hifigan_tpu_torch.ops import ar_decode as k1
    from sambert_hifigan_tpu_torch.ops import mrf as k2
    from sambert_hifigan_tpu_torch.pipeline import TTSPipeline

    t_phase = time.perf_counter()
    bad = []
    bf = TTSPipeline(pipe.cfg, pipe.acoustic.state_dict(), pipe.generator.state_dict(),
                     device=pipe.device, dtype=torch.bfloat16)
    bf.synthesize_batch(TEXTS)  # first calls
    list(bf.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT))
    torch.cuda.synchronize()

    k1.launches = k2.launches = 0
    wavs = bf.synthesize_batch(TEXTS)
    torch.cuda.synchronize()
    batch_launches = {"ar_decode": k1.launches, "mrf": k2.launches}
    k1.launches = k2.launches = 0
    chunks = list(bf.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT))
    torch.cuda.synchronize()
    stream_launch = {"ar_decode": k1.launches, "mrf": k2.launches}

    totals, want = expected_samples(bf, TEXTS)
    runs = 1 if max(totals) <= bf._initial_bucket(bf._features(TEXTS)[0], 1.0) else 2
    if batch_launches != {"ar_decode": runs, "mrf": runs * len(bf.mrf_weights)}:
        bad.append(f"bf16 synthesize_batch launches {batch_launches}, want {runs} and "
                   f"{runs * len(bf.mrf_weights)}")
    lengths = [len(w) for w in wavs]
    if lengths != want or not all(np.isfinite(w).all() for w in wavs):
        bad.append(f"bf16 wav lengths {lengths}, want {want} (or non-finite samples)")
    full = bf.synthesize(TEXTS[0])
    streamed = np.concatenate(chunks)
    tph, _ = bf._frontend_args(TEXTS[:1])
    want_stream = stream_launches(bf, tph, len(full) // bf.hop)
    stream_diff = (float(np.abs(streamed - full).max()) if streamed.shape == full.shape
                   else None)
    if (stream_launch["ar_decode"], stream_launch["mrf"]) != want_stream:
        bad.append(f"bf16 stream launches {stream_launch}, want {want_stream}")
    if stream_diff is None or not stream_diff <= STREAM_TOL_MAX:
        bad.append(f"bf16 stream against its synthesize: {stream_diff} "
                   f"(shapes {streamed.shape} {full.shape})")

    ref = pipe.synthesize_batch(TEXTS)
    f32_totals = pipe.text_to_mel(TEXTS).total_frames.cpu().tolist()
    vs_f32 = [float(np.abs(a - b).max()) if a.shape == b.shape else None
              for a, b in zip(wavs, ref)]
    rel_rms = [float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))
               if a.shape == b.shape else None for a, b in zip(wavs, ref)]
    if totals != f32_totals or not all(v is not None and v <= BF16_VS_F32_MAX for v in vs_f32):
        bad.append(f"bf16 against f32: totals {totals} / {f32_totals}, max |diff| {vs_f32} "
                   f"(bound {BF16_VS_F32_MAX})")

    # warm ms of both pipelines in turns: the batch, and the stream's first chunk
    def batch_ms(tts):
        t0 = time.perf_counter()
        tts.synthesize_batch(TEXTS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def first_chunk_ms(tts):
        t0 = time.perf_counter()
        it = tts.stream(TEXTS[0], chunk_frames=CHUNK, context_frames=CONTEXT)
        next(it)
        ms = (time.perf_counter() - t0) * 1e3
        it.close()
        torch.cuda.synchronize()
        return ms

    ms = {k: [] for k in ("batch_bf16", "batch_f32", "ttfa_bf16", "ttfa_f32")}
    for i in range(4):
        for name, tts in (("bf16", bf), ("f32", pipe))[::1 if i % 2 else -1]:
            ms[f"batch_{name}"].append(batch_ms(tts))
            ms[f"ttfa_{name}"].append(first_chunk_ms(tts))
    audio_s = sum(lengths) / pipe.cfg.audio.sample_rate
    warm = {k: median(v[1:]) for k, v in ms.items()}

    k1_row, k2_rows, kernel_bad = bf16_kernels(bf)
    bad += kernel_bad
    row = dict(totals=totals, lengths=lengths, batch_launches=batch_launches,
               stream_launches=stream_launch, stream_max_abs_vs_synthesize=stream_diff,
               vs_f32_max_abs=vs_f32, vs_f32_rel_rms=rel_rms, warm_ms=warm,
               rtf_bf16=warm["batch_bf16"] / 1e3 / audio_s,
               rtf_f32=warm["batch_f32"] / 1e3 / audio_s, k1=k1_row, k2=k2_rows)
    row["phase_s"] = time.perf_counter() - t_phase
    log("[bf16]", json.dumps(row))
    if row["phase_s"] > BF16_PHASE_LIMIT_S:
        bad.append(f"phase 14 took {row['phase_s']:.1f} s (limit {BF16_PHASE_LIMIT_S})")
    if bad:
        raise AssertionError("phase 14:\n" + "\n".join(bad))
    row["launches"] = {k: batch_launches[k] + stream_launch[k] for k in batch_launches}
    return row


# ---- main -------------------------------------------------------------------


def main() -> int:
    repo = Path(__file__).resolve().parent
    if not (repo / "sambert_hifigan_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the sambert_hifigan_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from sambert_hifigan_tpu_torch import kernels
    from sambert_hifigan_tpu_torch.config import default_config
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline_from_random_init

    # phase 1: setup and build
    smi = nvidia_smi_line()
    log(f"[setup] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    build_logs = kernels.build_all()
    log(f"[setup] built {sorted(build_logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    dev = torch.device("cuda")
    cfg = default_config()
    gen = torch.Generator().manual_seed(0)
    pipe = build_pipeline_from_random_init(cfg, seed=0)
    main_shape = main_path_shape(pipe)
    k1_rows = phase_k1(cfg, K1_SHAPES + (main_shape,), dev, gen)
    if k1_rows["B16-T2048"]["plan"]["groups"] < 2:
        raise AssertionError("K1 at B=16, T=2048 ran on one cluster, not two")
    k2_rows = phase_k2(pipe, 1024, (1, 2, 4), gen, dev)
    # a short utterance: T = 40 at stage 0, under the k = 11 chain's halo
    phase_k2(pipe, 5, (1, 4), gen, dev, timed=False)
    launches, _ = phase_pipeline(pipe)
    stream_launch_counts, _ = phase_stream(pipe, cfg, dev, gen, (K1_SHAPES[0], main_shape))
    phase_serving(pipe)
    train_row = phase_train(pipe, dev)
    acoustic_row = phase_acoustic_train(pipe, dev)
    data_row = phase_data(pipe, dev)
    dp_row = phase_dp(pipe, dev)
    tools_row = phase_tools(pipe, dev)
    tp_row = phase_tp(pipe, dev)
    mesh_row = phase_mesh(pipe, dev)
    bf16_row = phase_bf16(pipe)

    k1_main = k1_rows["main-path"]
    k2_main = [k2_rows[(i, 4)] for i in range(len(pipe.mrf_weights))]
    kernels_line = {"kernels": [
        {"name": "ar_decode", "route": "cuda",
         "source": "sambert_hifigan_tpu_torch/csrc/ar_decode.cu",
         "replaces": "sambert_hifigan_tpu/ops/pallas/decode_kernel.py:396",
         "launches": launches["ar_decode"],
         "launches_stream": stream_launch_counts["ar_decode"], "launches_train": 0,
         "launches_acoustic_train": acoustic_row["trained"]["launches"]["ar_decode"],
         "launches_data_train": data_row["launches"]["ar_decode"],
         "launches_dp_train": dp_row["launches"]["ar_decode"],
         "launches_tools": tools_row["launches"]["ar_decode"],
         "launches_tp_train": tp_row["launches"]["ar_decode"],
         "launches_mesh": mesh_row["launches"]["ar_decode"],
         "launches_bf16": bf16_row["launches"]["ar_decode"],
         "max_abs_err": k1_main["max_abs_err"],
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None},
        {"name": "mrf", "route": "cuda",
         "source": "sambert_hifigan_tpu_torch/csrc/mrf.cu",
         "replaces": "sambert_hifigan_tpu/ops/pallas/mrf_kernel.py:183",
         "launches": launches["mrf"], "launches_stream": stream_launch_counts["mrf"],
         "launches_train": train_row["vocode"]["k2_launches"],
         "launches_acoustic_train": acoustic_row["trained"]["launches"]["mrf"],
         "launches_data_train": data_row["launches"]["mrf"],
         "launches_dp_train": dp_row["launches"]["mrf"],
         "launches_tools": tools_row["launches"]["mrf"],
         "launches_tp_train": tp_row["launches"]["mrf"],
         "launches_mesh": mesh_row["launches"]["mrf"],
         "launches_bf16": bf16_row["launches"]["mrf"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_main),
         "ms": sum(r["ms"] for r in k2_main), "plain_ms": sum(r["plain_ms"] for r in k2_main),
         "bound_ms": sum(r["bound_ms"] for r in k2_main),
         "bound_by": "operations" if all(r["bound_by"] == "operations" for r in k2_main)
         else "bytes",
         "library_ms": sum(r["library_ms"] for r in k2_main)},
    ]}
    log(f"[kernels] K1 at the main path's shape (B={k1_main['B']}, T=S={k1_main['T']}, "
        f"valid frames {list(k1_main['valid'].values())}); K2 summed over the four stages "
        "at B=4, T=1024 frames (one vocode of the main path); launches_stream: the "
        "launches of one stream(TEXTS[0]); launches_train: phase 7's (12 train steps, "
        "then one vocode of the trained generator); launches_acoustic_train: phase 8's "
        "(its 15 full-width train steps and the small card-vs-CPU step, none; then the trained decoder once through K1 and one "
        "synthesize_batch of the trained model); launches_data_train: phase 9's (the "
        "aligner and every --metadata train step, none; then one synthesize_batch of 4 "
        "corpus texts from the two checkpoints and one copy-synthesis vocode); "
        "launches_dp_train: phase 10's (the torchrun and multiprocess_dp train steps, none, "
        "and those run in processes of their own; then one synthesize_batch of 2 texts from "
        "the torchrun checkpoints and the text_to_mel that gives their lengths, and "
        "copy_synth of a 4-utterance toy corpus); launches_tools: phase 11's (the profiler's "
        "e2e, decode and vocoder surfaces, 2 warm-up and 2 captured calls each, its train "
        "surfaces none; the encode split; bench_decode_modes' kernel mode; the debug and "
        "plot pipelines; eval_demo_run over 8 utterances; the demos and the dryrun none); "
        "launches_tp_train: phase 12's (the tensor-parallel train steps in processes of their "
        "own, none; then one synthesize_batch of 2 texts from the --model-parallel torchrun "
        "checkpoints and the text_to_mel that gives their lengths; the dryrun none); "
        "launches_mesh: phase 13's, one synthesize_batch of the 4 texts split over two "
        "replicas on cuda:0 (one K1 launch and a vocode of four K2 launches a replica); "
        "launches_bf16: phase 14's, one synthesize_batch of the 4 texts and one "
        "stream(TEXTS[0]) of the bf16 pipeline")
    log(json.dumps(kernels_line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report and exit non-zero, no result line
        traceback.print_exc()
        sys.exit(1)
