"""Split text -> mel into its encode and its decode, in wall and device time.

  python -m sambert_hifigan_tpu_torch.bench_encode_split              # wall-clock split
  python -m sambert_hifigan_tpu_torch.bench_encode_split --trace enc  # device ms per call

The counterpart of the JAX package's `scripts/bench_encode_split.py`.  The
default acoustic model with random weights from seed 0, B = 1, 64 phonemes,
a 512-frame bucket, in bf16 as the JAX script's model and as
`TTSPipeline(dtype=torch.bfloat16)` runs it (the encoder, the variance
adaptor and the memory K/V in bf16, the decode through K1 over bf16 packed
weights and bf16-rounded biases):

  enc   embedding + encoder + variance adaptor (`SAMBERTAcousticModel.encode`)
  dec   the decode from that encode's output (memory K/V, then K1), masked
  full  `acoustic_inference`: both, as one call

so dec(enc()) is full() in the same operations.  The wall time is amortised:
the min over 5 reps of 10 back-to-back calls and one synchronize.  --trace
captures 10 calls under torch.profiler and reports the device's busy ms per
call (the union of the kernels' intervals, `profiling.busy_ms`), which
against the wall ms says how much of a surface is launches.  Runs on the
CUDA card unless --device cpu is given (no --trace there: the CPU has no
device time).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict


def build(tph: int = 64, tfrm: int = 512, device=None, cfg=None, seed: int = 0
          ) -> Dict[str, Callable]:
    """{"enc", "dec", "full"}: calls of one B = 1 utterance, and "decode":
    the decode as a function of an encode's output (dec is decode of one
    encode, made here)."""
    import numpy as np
    import torch

    from .config import default_config
    from .kernels import resolve_device
    from .models.acoustic_model import acoustic_inference
    from .models.ar_decoder import ar_decode, pack_decoder
    from .pipeline import _ieee_f32
    from .weights import random_acoustic_model

    device = resolve_device(device)
    cfg = cfg or default_config()
    model = random_acoustic_model(cfg, torch.Generator().manual_seed(seed)).to(device).eval()
    bf16 = torch.bfloat16
    w = pack_decoder(model.ar_decoder, bf16, bf16)
    rng = np.random.default_rng(seed)
    ph = torch.tensor(rng.integers(4, 100, (1, tph)), device=device)
    tone = torch.tensor(rng.integers(0, 5, (1, tph)), device=device)
    bnd = torch.tensor(rng.integers(0, 4, (1, tph)), device=device)
    mask = torch.ones(1, tph, dtype=torch.bool, device=device)

    @torch.no_grad()
    def enc():
        with _ieee_f32():
            return model.encode(ph, tone, bnd, tfrm, mask, 1.0, 0.0, 1.0, dtype=bf16)

    @torch.no_grad()
    def decode(va):
        with _ieee_f32():
            mel = ar_decode(model.ar_decoder, va.hvar, tfrm,
                            memory_key_padding_mask=~va.frame_mask, weights=w)
        return mel * va.frame_mask[:, :, None].to(mel.dtype)

    def full():
        with _ieee_f32():
            return acoustic_inference(model, ph, tone, bnd, tfrm, w, phoneme_mask=mask,
                                      dtype=bf16).mel_pred

    va = enc()
    return {"enc": enc, "dec": lambda: decode(va), "full": full, "decode": decode}


def _sync(device_type: str) -> None:
    import torch

    if device_type == "cuda":
        torch.cuda.synchronize()


def wall(f: Callable, device_type: str, reps: int = 5, inner: int = 10) -> float:
    """Amortised wall ms of one call: the min over reps of `inner` calls."""
    f()
    _sync(device_type)
    best = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            f()
        _sync(device_type)
        best.append((time.perf_counter() - t0) / inner)
    return min(best) * 1e3


def device_ms(f: Callable, inner: int = 10) -> dict:
    """Device time of `inner` calls under the profiler, per call
    (`profiling.summarize`: busy ms, summed kernel ms, kernels, wall ms)."""
    from .profiling import capture, summarize

    f()
    _sync("cuda")
    prof, wall_ms, _ = capture(f, inner)
    return summarize(prof, wall_ms, n=5, calls=inner)


def main(argv=None) -> dict:
    from .kernels import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", choices=["enc", "dec", "full"], default=None,
                    help="capture a trace of one surface and report its device ms per call")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.trace and device.type != "cuda":
        raise SystemExit("--trace reads device time: run on the card")
    fns = build(device=device)
    if args.trace:
        row = device_ms(fns[args.trace])
        print(f"{args.trace}: {row['busy_ms']:.3f} ms/call (device busy; {row['wall_ms']:.3f} "
              f"ms wall under the profiler, {row['kernels']} kernels)")
        return {args.trace: row}
    out = {}
    for name in ("full", "dec", "enc"):
        out[name] = wall(fns[name], device.type)
        print(f"{name}: {out[name]:.2f} ms (wall, amortized)")
    return out


if __name__ == "__main__":
    main()
