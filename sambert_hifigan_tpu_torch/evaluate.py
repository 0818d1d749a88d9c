"""Objective comparison of two audio files (or two saved mels).

  python -m sambert_hifigan_tpu_torch.evaluate ref.wav synth.wav [--device cpu]
  python -m sambert_hifigan_tpu_torch.evaluate ref_mel.npy synth_mel.npy

Prints mel-MAE, DTW-aligned mel-MAE and MCD of two wavs (resampled to the
config's rate and downmixed to mono), or the mel-MAE of two .npy mels.  The
metrics use the shared log-mel op (utils/eval_metrics.py).  Runs on the
CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    import torch

    from .config import default_config
    from .data.audio import load_mel, load_wav
    from .kernels import resolve_device
    from .ops.mel import resample
    from .utils.eval_metrics import mcd, mel_mae, mel_mae_dtw, mel_mae_from_mels

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("reference")
    p.add_argument("candidate")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    cfg = default_config()

    if args.reference.endswith(".npy"):
        out = {"mel_mae": mel_mae_from_mels(load_mel(args.reference), load_mel(args.candidate))}
        print(f"mel-MAE: {out['mel_mae']:.6f}")
        return out
    device = resolve_device(args.device)

    def load(path):
        wav, sr = load_wav(path)
        if sr != cfg.audio.sample_rate:
            wav = resample(torch.from_numpy(wav).to(device), sr,
                           cfg.audio.sample_rate).cpu().numpy()
        return wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]

    a, b = load(args.reference), load(args.candidate)
    out = {"mel_mae": mel_mae(a, b, cfg.audio, device),
           "mel_mae_dtw": mel_mae_dtw(a, b, cfg.audio, device),
           "mcd": mcd(a, b, cfg.audio, device=device)}
    print(f"mel-MAE:     {out['mel_mae']:.6f}")
    print(f"dtw-mel-MAE: {out['mel_mae_dtw']:.6f}")
    print(f"MCD:         {out['mcd']:.3f} dB")
    return out


if __name__ == "__main__":
    main()
