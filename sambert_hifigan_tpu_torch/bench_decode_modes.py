"""Time the AR decode two ways: kernel K1 against its plain PyTorch version.

  python -m sambert_hifigan_tpu_torch.bench_decode_modes [--device cuda]

The counterpart of the JAX package's `scripts/bench_decode_modes.py`, which
set its Pallas kernel against its XLA scan.  The default decoder (6 layers,
d 256, 8 heads, FFN 2048) with random weights from seed 0 decodes T = 512
frames at B = 1 from a random bf16 memory of 512 frames (the JAX script's
bf16 hvar, projected to bf16 K/V), over bf16 packed weights on either
device, as the bf16 pipeline packs them:

  kernel  K1 (`csrc/ar_decode.cu`), one launch per decode
  plain   `ops/ar_decode.ar_decode_plain`, the same arithmetic as a Python
          loop of launches per step (about 5 s a decode on an H100)

This is the one place outside the tests where the plain version runs on the
card: a comparison tool, not a path.  Each mode is warmed once (its value
gives the checksum, the sum of the mel), then timed as the min over `reps`
of the mean of `inner` decodes with one synchronizing copy after them.  K1
has no CPU form: with --device cpu the kernel mode raises.
"""

from __future__ import annotations

import argparse
import time

T = 512


def build(device, t: int = T, seed: int = 0):
    """(packed weights, decode memory) of the default decoder at B = 1."""
    import torch

    from .config import default_config
    from .models.ar_decoder import PNCAARDecoder, decode_memory, pack_decoder
    from .models.layers import init_defaults_

    am = default_config().acoustic_model
    gen = torch.Generator().manual_seed(seed)
    dec = PNCAARDecoder(am.d_model, am.n_mels, am.decoder)
    init_defaults_(dec, gen)
    dec.init_weights_(gen)
    dec = dec.to(device).eval()
    bf16 = torch.bfloat16
    w = pack_decoder(dec, bf16, bf16)
    hvar = torch.randn(1, t, am.d_model, generator=gen).to(device, bf16)
    return w, decode_memory(dec, hvar, None, w)


def decoder(mode: str, w, memory, t: int = T):
    """A callable that decodes t frames in `mode` -> mel [1, t, n_mels]."""
    from .ops import ar_decode as k1

    if mode == "kernel":
        if memory.mem_k.device.type != "cuda":
            raise RuntimeError("the kernel mode runs K1, which has no CPU form: "
                               "run on the card (--device cuda)")
        return lambda: k1.ar_decode(w, *memory, t)
    if mode == "plain":
        return lambda: k1.ar_decode_plain(w, *memory, k1.init_carry(w, 1, t), 0, t)[1]
    raise ValueError(f"unknown mode {mode!r}")


def run_mode(mode: str, w, memory, t: int = T, reps: int = 5, inner: int = 10):
    """(row, the warm-up's mel): ms per decode (min over reps), frames/s,
    checksum."""
    f = decoder(mode, w, memory, t)
    first = f()
    v = float(first.float().sum())  # warm + value
    best = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = f()
        float(out.float().sum())  # one copy waits for the device
        best.append((time.perf_counter() - t0) / inner)
    s = min(best)
    print(f"mode={mode}: {s * 1e3:.2f} ms / {t} frames ({t / s / 1e3:.1f}k frames/s), "
          f"checksum {v:.2f}")
    return dict(mode=mode, ms=s * 1e3, frames=t, frames_per_s=t / s, checksum=v,
                reps=reps, inner=inner), first


def main(argv=None):
    from .kernels import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' has the plain mode only)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    w, memory = build(device)
    return [run_mode(mode, w, memory)[0] for mode in ("kernel", "plain")]


if __name__ == "__main__":
    main()
