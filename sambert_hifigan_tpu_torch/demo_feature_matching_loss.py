"""The per-discriminator feature-matching loss of one generator loss.

  python -m sambert_hifigan_tpu_torch.demo_feature_matching_loss [--device cpu]

The counterpart of the JAX package's `scripts/demo_feature_matching_loss.py`.
One adv_mel_fm generator loss (`losses/vocoder.py`) of the default-config
HiFi-GAN with random weights from seed 0, on a random mel of 2 x 8 frames
and random "real" audio: prints the total generator loss, the FM loss (the
mean over the 8 discriminators) and its terms gen_fm_loss_disc_0..7 (3 MSD
scales, then MPD periods 2, 3, 5, 7, 11), the logging schema a metrics
dashboard reads.  Runs on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

NAMES = [f"MSD scale {i}" for i in range(3)] + [f"MPD period {p}" for p in (2, 3, 5, 7, 11)]


def fm_losses(cfg=None, model=None, device=None, frames: int = 8
              ) -> Tuple[float, Dict[str, float]]:
    """(total generator loss, its metrics as floats).  `model`: a HiFiGAN of
    cfg.vocoder (default: seeded random weights)."""
    import numpy as np
    import torch

    from .config import default_config
    from .kernels import resolve_device
    from .losses.vocoder import vocoder_generator_loss
    from .models.hifigan import HiFiGAN
    from .models.layers import init_defaults_
    from .training.metrics import to_host

    device = resolve_device(device)
    cfg = cfg or default_config()
    if model is None:
        model = HiFiGAN(cfg.vocoder)
        init_defaults_(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    rng = np.random.default_rng(0)
    mel = torch.tensor(rng.standard_normal((2, cfg.audio.n_mels, frames)), dtype=torch.float32,
                       device=device)
    with torch.no_grad():
        wav_fake = model.generator(mel)
        wav_real = torch.tensor(rng.standard_normal(tuple(wav_fake.shape)) * 0.1,
                                dtype=torch.float32, device=device)
        _, msd_rf, msd_fo, msd_ff, _, mpd_rf, mpd_fo, mpd_ff = model.discriminate(
            wav_real, wav_fake)
        loss, metrics = vocoder_generator_loss(
            wav_real, wav_fake, cfg.audio, loss_mode="adv_mel_fm",
            disc_fake_outputs=list(msd_fo) + list(mpd_fo),
            real_feature_maps=list(msd_rf) + list(mpd_rf),
            fake_feature_maps=list(msd_ff) + list(mpd_ff))
    return float(loss), to_host(metrics)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    loss, metrics = fm_losses(device=args.device)
    print(f"total generator loss: {loss:.4f}")
    print(f"feature-matching loss (mean over 8 discriminators): {metrics['gen_fm_loss']:.6f}")
    for i, name in enumerate(NAMES):
        print(f"  gen_fm_loss_disc_{i} ({name}): {metrics[f'gen_fm_loss_disc_{i}']:.6f}")
    return loss, metrics


if __name__ == "__main__":
    main()
