"""Waveform-domain vocoder comparison from already-synthesized wavs.

  python -m sambert_hifigan_tpu_torch.eval_vocoder_waveform --gt-dir data/eval/wavs \
      --syn-dir mel_only=/tmp/copy_a --syn-dir adv_mel_fm=/tmp/copy_b [--suffix _copy] \
      [--n 12] [--device cpu]

The counterpart of the JAX package's `scripts/eval_vocoder_waveform.py`.
Matches each `utt_XXXX.wav` ground truth against `utt_XXXX{suffix}.wav` in
every synthesis directory (only utterances present in all of them) and
reports per system: mel-MAE, MCD, the fine-resolution STFT log-magnitude
MAE, F0-RMSE over frames voiced in both, and voicing F1
(utils/eval_metrics.py).  mel-L1 is the mel_only ablation's own training
objective, so the phase- and periodicity-sensitive metrics are the ones
that can tell whether adversarial training helps.  Runs on the CUDA card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--gt-dir", type=str, required=True)
    p.add_argument("--syn-dir", action="append", required=True,
                   help="label=dir; repeatable, one per system under comparison")
    p.add_argument("--suffix", type=str, default="_copy")
    p.add_argument("--n", type=int, default=None, help="cap utterance count")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def matched_utterances(gt_dir: Path, systems: Sequence[Tuple[str, Path]], suffix: str,
                       n: Optional[int] = None) -> List[str]:
    gts = sorted(Path(gt_dir).glob("utt_*.wav"))
    utts = [g.stem for g in gts
            if all((d / f"{g.stem}{suffix}.wav").exists() for _, d in systems)]
    utts = utts[:n] if n else utts
    if not utts:
        raise SystemExit(
            f"no matched utterances: {len(gts)} utt_*.wav under {gt_dir}, but none have "
            f"'<stem>{suffix}.wav' in every --syn-dir (wrong --suffix or directory?)")
    return utts


def score_systems(cfg, gt_dir, systems: Sequence[Tuple[str, Path]], suffix: str = "_copy",
                  n: Optional[int] = None, device=None) -> Dict[str, Dict[str, float]]:
    """{label: {mel_mae, mcd, stft_mae, f0_rmse (None where no frame is
    voiced in both), voicing_f1}}, each the mean over the matched
    utterances."""
    import numpy as np

    from .data.audio import load_wav
    from .kernels import resolve_device
    from .utils.eval_metrics import f0_metrics, mcd, mel_mae, stft_logmag_mae

    device = resolve_device(device)
    gt_dir = Path(gt_dir)
    utts = matched_utterances(gt_dir, systems, suffix, n)
    scores = {}
    for label, d in systems:
        mm, mc, sm, fr, vf = [], [], [], [], []
        for u in utts:
            gt = load_wav(gt_dir / f"{u}.wav")[0][0]
            syn = load_wav(Path(d) / f"{u}{suffix}.wav")[0][0]
            mm.append(mel_mae(gt, syn, cfg.audio, device))
            mc.append(mcd(gt, syn, cfg.audio, device=device))
            sm.append(stft_logmag_mae(gt, syn, device=device))
            f0m = f0_metrics(gt, syn, cfg.audio, device)
            if np.isfinite(f0m["f0_rmse_hz"]):
                fr.append(f0m["f0_rmse_hz"])
            vf.append(f0m["voicing_f1"])
        scores[label] = {"mel_mae": float(np.mean(mm)), "mcd": float(np.mean(mc)),
                         "stft_mae": float(np.mean(sm)),
                         "f0_rmse": float(np.mean(fr)) if fr else None,
                         "voicing_f1": float(np.mean(vf)), "utterances": len(utts)}
    return scores


def main(argv=None):
    from .config import default_config

    args = parse_args(argv)
    systems = []
    for spec in args.syn_dir:
        label, _, d = spec.partition("=")
        systems.append((label, Path(d)))
    scores = score_systems(default_config(), args.gt_dir, systems, args.suffix, args.n,
                           args.device)
    first = next(iter(scores.values()))
    print(f"{first['utterances']} matched utterances")
    print(f"{'system':>12} {'mel-MAE':>8} {'MCD dB':>8} {'stft-MAE':>9} {'F0-RMSE':>8} "
          f"{'voic-F1':>8}")
    for label, s in scores.items():
        f0_col = f"{s['f0_rmse']:8.2f}" if s["f0_rmse"] is not None else f"{'n/a':>8}"
        print(f"{label:>12} {s['mel_mae']:8.4f} {s['mcd']:8.3f} {s['stft_mae']:9.4f} "
              f"{f0_col} {s['voicing_f1']:8.4f}")
    return scores


if __name__ == "__main__":
    main()
