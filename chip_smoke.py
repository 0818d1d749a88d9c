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
weights made from a seed, and checks that every kernel of that path launched.  Any failed phase raises and the
script exits non-zero.  It imports nothing of JAX.

Output: one line per phase; before the last line, a JSON object with every
kernel's launches, error and times, and the card's name and power limit as
nvidia-smi gives them; last, `{"ok": true, "device": {...}}`.

Times come from CUDA events around repeated launches after a warm-up; bounds
are the larger of the bytes the function must move over the card's memory
rate and its operations over the bf16 tensor-core peak (NVIDIA H100 SXM data
sheet: 3.35 TB/s, 989 TFLOP/s dense).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# phase-2 tolerances of K1 against its plain version, on mels of mean |x| ~1
# (same bf16 rounding points; the orders of the f32 sums differ and the
# autoregressive feedback carries a flipped bf16 rounding on to later frames)
K1_TOL_MEAN, K1_TOL_MAX = 1e-2, 0.1
# K2 against its plain version, on outputs of mean |x| ~0.8: same bf16
# rounding points, f32 sums in another order; a rare flipped bf16 rounding
# of a conv input moves one sample by ~1e-3
K2_TOL_MAX = 5e-3

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
        ref = k1.ar_decode_plain(w, mk, mv, bias, t)
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
    k1_rows = phase_k1(cfg, K1_SHAPES + (main_path_shape(pipe),), dev, gen)
    if k1_rows["B16-T2048"]["plan"]["groups"] < 2:
        raise AssertionError("K1 at B=16, T=2048 ran on one cluster, not two")
    k2_rows = phase_k2(pipe, 1024, (1, 2, 4), gen, dev)
    # a short utterance: T = 40 at stage 0, under the k = 11 chain's halo
    phase_k2(pipe, 5, (1, 4), gen, dev, timed=False)
    launches, _ = phase_pipeline(pipe)

    k1_main = k1_rows["main-path"]
    k2_main = [k2_rows[(i, 4)] for i in range(len(pipe.mrf_weights))]
    kernels_line = {"kernels": [
        {"name": "ar_decode", "route": "cuda",
         "source": "sambert_hifigan_tpu_torch/csrc/ar_decode.cu",
         "replaces": "sambert_hifigan_tpu/ops/pallas/decode_kernel.py:396",
         "launches": launches["ar_decode"], "max_abs_err": k1_main["max_abs_err"],
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None},
        {"name": "mrf", "route": "cuda",
         "source": "sambert_hifigan_tpu_torch/csrc/mrf.cu",
         "replaces": "sambert_hifigan_tpu/ops/pallas/mrf_kernel.py:183",
         "launches": launches["mrf"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_main),
         "ms": sum(r["ms"] for r in k2_main), "plain_ms": sum(r["plain_ms"] for r in k2_main),
         "bound_ms": sum(r["bound_ms"] for r in k2_main),
         "bound_by": "operations" if all(r["bound_by"] == "operations" for r in k2_main)
         else "bytes",
         "library_ms": sum(r["library_ms"] for r in k2_main)},
    ]}
    log(f"[kernels] K1 at the main path's shape (B={k1_main['B']}, T=S={k1_main['T']}, "
        f"valid frames {list(k1_main['valid'].values())}); K2 summed over the four stages "
        "at B=4, T=1024 frames (one vocode of the main path)")
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
