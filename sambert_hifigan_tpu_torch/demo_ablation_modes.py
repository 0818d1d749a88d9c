"""One GAN train step under each ablation loss mode.

  python -m sambert_hifigan_tpu_torch.demo_ablation_modes
      [--mode mel_only|adv_mel|adv_mel_fm|all] [--batch-size 2] [--segment-frames 8]
      [--device cpu]

The counterpart of the JAX package's `scripts/demo_ablation_modes.py`.  Runs
one vocoder train step (`training/vocoder_trainer.py`, the default config:
full width, bf16 recipe) on random audio and mels from seed 0 and prints the
whole metrics dict per mode, showing the per-mode bookkeeping: inactive
terms are zeros, and in mel_only the discriminators do not train.  Runs on
the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from typing import Dict

MODES = ("mel_only", "adv_mel", "adv_mel_fm")


def run_mode(mode: str, batch: int, frames: int, seed: int = 0, cfg=None,
             device=None, verbose: bool = True) -> Dict[str, float]:
    """One step of `mode` from seeded weights; the metrics as floats, and
    "discriminators_trained" (did the first discriminator weight move)."""
    import numpy as np
    import torch

    from .config import default_config
    from .kernels import resolve_device
    from .training.metrics import to_host
    from .training.vocoder_trainer import init_vocoder_state, make_vocoder_step

    device = resolve_device(device)
    cfg = cfg or default_config()
    if verbose:
        print(f"\n=== loss_mode = {mode} ===")
    state = init_vocoder_state(cfg, torch.Generator().manual_seed(seed), device)
    step = make_vocoder_step(cfg, loss_mode=mode)
    rng = np.random.default_rng(seed)
    mel = torch.tensor(rng.standard_normal((batch, cfg.audio.n_mels, frames)),
                       dtype=torch.float32, device=device)
    wav = torch.tensor(rng.standard_normal((batch, 1, frames * cfg.audio.hop_length)) * 0.1,
                       dtype=torch.float32, device=device)
    d0 = state.model.discriminator_parameters()[0]
    d_before = d0.detach().clone()
    host = dict(sorted(to_host(step(state, mel, wav)).items()))
    d_trained = not torch.equal(d_before, d0.detach())
    if verbose:
        for k, v in host.items():
            print(f"  {k}: {v:.6f}")
        print(f"  discriminators trained: {d_trained}")
    return dict(host, discriminators_trained=d_trained)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="all", choices=[*MODES, "all"])
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--segment-frames", type=int, default=8)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    modes = MODES if args.mode == "all" else (args.mode,)
    return {mode: run_mode(mode, args.batch_size, args.segment_frames, device=args.device) for mode in modes}


if __name__ == "__main__":
    main()
