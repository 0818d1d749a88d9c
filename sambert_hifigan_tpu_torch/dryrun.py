"""A single-card forward check and a multi-process dryrun of both train steps.

  python -m sambert_hifigan_tpu_torch.dryrun [N] [--device cpu]

The counterpart of the JAX package's `__graft_entry__.py`.

entry()              -> (fn, args): the teacher-forced forward of the
                        SAM-BERT acoustic model at the default config
                        (B = 2, 32 phonemes, 128 frames), random weights
                        from seed 0; fn(*args) -> mel [2, 128, 80].
dryrun_multichip(n)  -> stage "dp": n ranks in one process group (gloo,
                        `multiprocess_dp.launch`, which spawns them with
                        `run_procs`), each on its rows of one global batch
                        of max(n, 2): one full acoustic AdamW step and one
                        HiFi-GAN two-optimizer GAN step (adv_mel_fm), on a
                        tiny config (d 64, 2 + 2 layers; generator 64
                        channels; all 8 critics at channel_div 8).  The
                        verdict: every rank finished, every metric is
                        finite, and every rank holds the same parameters.

The JAX dryrun's second stage, "dp x tp" (tensor-parallel parameter
sharding over a model axis), has no counterpart: each rank of the port
holds a whole replica, so there is no sharding to check, and no verdict
is printed for it.  Ranks run on the CUDA card (all on one card when there
are fewer cards than ranks) unless device='cpu' is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
from pathlib import Path


def entry(device=None):
    import numpy as np
    import torch

    from .config import default_config
    from .kernels import resolve_device
    from .weights import random_acoustic_model

    device = resolve_device(device)
    cfg = default_config()
    model = random_acoustic_model(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    b, tph, tfrm = 2, 32, 128
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=device)

    ph = t(rng.integers(4, 300, (b, tph)))
    tone = t(rng.integers(0, 10, (b, tph)))
    bound = t(rng.integers(0, 5, (b, tph)))
    dur = torch.full((b, tph), tfrm // tph, dtype=torch.int64, device=device)
    mel = t(rng.standard_normal((b, tfrm, cfg.audio.n_mels)).astype(np.float32))

    def fn(model, ph, tone, bound, mel, dur):
        return model(ph, tone, bound, mel, dur).mel_pred

    return fn, (model, ph, tone, bound, mel, dur)


def tiny_config():
    """The JAX dryrun's tiny-but-real config: the same step code at d 64."""
    from .config import (AcousticModelConfig, DecoderConfig, DiscriminatorConfig,
                         EncoderConfig, GeneratorConfig, VocoderConfig, default_config)

    return dataclasses.replace(
        default_config(),
        acoustic_model=AcousticModelConfig(
            d_model=64, encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=128),
            decoder=DecoderConfig(n_layers=2, n_heads=4, d_ff=128, max_len=128)),
        vocoder=VocoderConfig(
            generator=GeneratorConfig(upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                                      resblock_dilation_sizes=((1, 3),)),
            discriminator=DiscriminatorConfig(channel_div=8)),
    )


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> bool:
    """Stage "dp" on n_devices ranks; prints its verdict and returns it."""
    from . import multiprocess_dp as mp
    from .kernels import resolve_device

    device = resolve_device(device)
    cfg = tiny_config()
    batch = max(n_devices, 2)
    print(f"[dryrun] stage dp: {n_devices} ranks on {device.type} (gloo), global batch {batch}")
    runs = [mp.make_run("acoustic", cfg, 1, batch, tph=8, tfrm=16, lockstep=False),
            mp.make_run("vocoder", cfg, 1, batch, segment_frames=8, lockstep=False)]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.launch(runs, n_devices, device.type, Path(tmp), timeout=timeout)
    ok = True
    for i, name in enumerate(("acoustic", "vocoder GAN")):
        metrics = ranks[0][i]["history"][0]
        finite = all(math.isfinite(v) for r in ranks for v in r[i]["history"][0].values())
        same = len({r[i]["digest"] for r in ranks}) == 1
        shown = dict(list(metrics.items())[:6]) if i else metrics
        print(f"[dryrun] stage dp: {name} step {'ok' if finite and same else 'FAILED'}: "
              f"{shown} (finite {finite}, replicas equal {same})")
        ok = ok and finite and same
    print(f"[dryrun] stage dp: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks (default 2)")
    p.add_argument("--device", type=str, default=None,
                   help="cpu or cuda (default: cuda); every rank on this device type")
    args = p.parse_args(argv)
    return 0 if dryrun_multichip(args.n, args.device) else 1


if __name__ == "__main__":
    raise SystemExit(main())
