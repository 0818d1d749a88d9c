"""Acoustic train-step MFU against model width (or batch).

  python -m sambert_hifigan_tpu_torch.bench_scaling [--dims 256,512,1024]
  python -m sambert_hifigan_tpu_torch.bench_scaling --dims 256 --batches 16,32,64,128

The counterpart of the JAX package's `scripts/bench_scaling.py`.  It runs
the port's acoustic train step as it trains (bf16 recipe, dropout 0.1, f32
masters; B = 16, 48 phonemes, a 384-frame bucket) at each --dims width
(`scaled_cfg`: 4x FFN, heads of 64 channels from d 512 on, depth as the
default), with random weights from seed 0 and a synthetic batch, and
prints one JSON line: {"metric", "rows": [{d_model, batch, params_m,
ms_per_step, steps_per_s, utterances_per_s, gflop_per_step, tflops,
mfu}]}.

Step time: the min over 3 reps of the mean of 8 steps, on the host clock,
each rep ending in `torch.cuda.synchronize()`, after one warm-up step.
FLOPs: the analytic count of one step's matrix products
(`flops.acoustic_step_flops`; the JAX script took XLA's count); MFU is
against the H100's dense bf16 peak, 989 TFLOP/s (`flops.BF16_FLOP_PER_S`),
which assumes a 700 W power limit.  Runs on the CUDA card unless --device
cpu is given (no rate is reported there: `tflops` and `mfu` are device
metrics).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def scaled_cfg(d_model: int):
    """The default config with the transformer width scaled; depth, heads of
    64 channels (at least 4) and the 4x FFN ratio follow the usual scaling
    (head_dim stays 64 for d >= 512)."""
    from .config import TTSConfig

    base = TTSConfig()
    am = base.acoustic_model
    if d_model == am.d_model:
        return base  # the default shapes for the 256 row
    heads = max(4, d_model // 64)
    am = dataclasses.replace(
        am,
        d_model=d_model,
        encoder=dataclasses.replace(am.encoder, n_heads=heads, d_ff=4 * d_model),
        decoder=dataclasses.replace(am.decoder, n_heads=heads, d_ff=4 * d_model),
    )
    return dataclasses.replace(base, acoustic_model=am)


def measure_step_ms(step, state, batch, rng, cuda: bool, reps: int = 3, k: int = 8) -> float:
    """Min over reps of the mean ms of k back-to-back steps, after one
    warm-up step; each rep ends in a synchronize."""
    import torch

    def sync():
        if cuda:
            torch.cuda.synchronize()

    step(state, batch, rng)
    sync()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            step(state, batch, rng)
        sync()
        dt = (time.perf_counter() - t0) / k
        best = dt if best is None else min(best, dt)
    return best * 1e3


def run(dims, batches, tph: int = 48, tfrm: int = 384, device=None, reps: int = 3,
        k: int = 8, cfg_of=scaled_cfg) -> list:
    """One row per (width, batch)."""
    import torch

    from .data.dataset import batch_to_device, synthetic_batch
    from .flops import BF16_FLOP_PER_S, acoustic_step_flops
    from .kernels import resolve_device
    from .training.acoustic_trainer import init_acoustic_state, make_acoustic_step
    from .weights import random_acoustic_model

    device = resolve_device(device)
    cuda = device.type == "cuda"
    rows = []
    for d in dims:
        cfg = cfg_of(d)
        step = make_acoustic_step(cfg)
        for b in batches:
            model = random_acoustic_model(cfg, torch.Generator().manual_seed(0)).to(device)
            n_params = sum(p.numel() for p in model.parameters())
            state = init_acoustic_state(model, cfg)
            batch = batch_to_device(synthetic_batch(cfg, b, tph, tfrm), device)
            flops = acoustic_step_flops(cfg, b, tph, tfrm)
            t0 = time.perf_counter()
            ms = measure_step_ms(step, state, batch, torch.Generator().manual_seed(1), cuda,
                                 reps, k)
            log(f"d={d} B={b}: measured in {time.perf_counter() - t0:.1f}s "
                f"(incl. warm-up), params {n_params / 1e6:.1f}M")
            s = ms / 1e3
            row = {"d_model": d, "batch": b, "params_m": round(n_params / 1e6, 1),
                   "ms_per_step": round(ms, 2), "steps_per_s": round(1.0 / s, 2),
                   "utterances_per_s": round(b / s, 0), "gflop_per_step": round(flops / 1e9, 1)}
            if cuda:
                row["tflops"] = round(flops / s / 1e12, 1)
                row["mfu"] = round(flops / s / BF16_FLOP_PER_S, 3)
            rows.append(row)
            log(f"d={d} B={b}: {row}")
            del state, model
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dims", default="256,512,1024")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--batches", default=None,
                    help="comma list of batch sizes to sweep at a fixed width "
                         "(e.g. --dims 256 --batches 16,32,64,128): whether a "
                         "launch-bound step at B = 16 buys utterances/s nearly free")
    ap.add_argument("--tph", type=int, default=48)
    ap.add_argument("--tfrm", type=int, default=384)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    batches = [int(x) for x in args.batches.split(",")] if args.batches else [args.batch]
    rows = run([int(x) for x in args.dims.split(",")], batches, args.tph, args.tfrm,
               args.device)
    metric = "acoustic_train_mfu_vs_batch" if args.batches else "acoustic_train_mfu_vs_width"
    out = {"metric": metric, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
