"""Evaluate trained demo checkpoints: copy-synthesis and full-TTS metrics.

  python -m sambert_hifigan_tpu_torch.eval_demo_run --metadata data/demo/metadata.csv \\
      --acoustic-checkpoint checkpoints/acoustic_demo \\
      --vocoder-checkpoint checkpoints/vocoder_demo \\
      [--acoustic-step S] [--vocoder-step S] [--n 4] [--output-dir outputs/demo_eval]
      [--device cpu]

The counterpart of the JAX package's `scripts/eval_demo_run.py`.  Restores
both checkpoints (`training/checkpoint.CheckpointManager`; the EMA copy
where a checkpoint has one, as `pipeline.build_pipeline` picks) into a
`TTSPipeline` and reports, per utterance and averaged over the first --n:

  * copy synthesis: the ground-truth mel (TTSDataset features) through the
    vocoder (every MRF through K2 on the card), then mel-MAE and MCD
    against the recording: the vocoder alone, length-preserving;
  * full TTS from the text (K1, then K2): DTW-aligned mel-MAE (predicted
    durations need not match the recording frame for frame), MCD over the
    shorter length, and DTW-aligned F0-RMSE and voicing F1.

Both wavs of each utterance go to --output-dir (`<stem>_copy.wav`,
`<stem>_tts.wav`).  Runs on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metadata", type=str, default="data/demo/metadata.csv")
    p.add_argument("--acoustic-checkpoint", type=str, required=True)
    p.add_argument("--vocoder-checkpoint", type=str, required=True)
    p.add_argument("--acoustic-step", type=int, default=None,
                   help="checkpoint step to restore (default: latest)")
    p.add_argument("--vocoder-step", type=int, default=None,
                   help="checkpoint step to restore (default: latest)")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--output-dir", type=str, default="outputs/demo_eval")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def evaluate_demo(cfg, metadata: str, acoustic_checkpoint: str, vocoder_checkpoint: str,
                  output_dir: str, n: int = 4, acoustic_step: Optional[int] = None,
                  vocoder_step: Optional[int] = None, device=None) -> dict:
    """{"steps", "rows": per utterance, "avg"}; prints the JAX script's lines."""
    import numpy as np
    import torch

    from .data.audio import load_wav, save_wav
    from .data.dataset import TTSDataset
    from .kernels import resolve_device
    from .pipeline import TTSPipeline
    from .training.acoustic_trainer import acoustic_params_from_tree
    from .training.checkpoint import CheckpointManager
    from .training.vocoder_trainer import generator_params_from_tree
    from .utils.eval_metrics import f0_metrics_dtw, mcd, mel_mae, mel_mae_dtw

    device = resolve_device(device)
    audio = cfg.audio
    ds = TTSDataset(metadata, cfg, device=device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    ac_tree, ac_step = CheckpointManager(acoustic_checkpoint, audio).restore_tree(
        step=acoustic_step)
    voc_tree, voc_step = CheckpointManager(vocoder_checkpoint, audio).restore_tree(
        step=vocoder_step)
    print(f"checkpoints: acoustic step {ac_step}, vocoder step {voc_step}")
    pipe = TTSPipeline(cfg, acoustic_params_from_tree(ac_tree),
                       generator_params_from_tree(voc_tree), device=device)

    def metric(fn, a, b):
        return fn(a, b, audio, device=device)

    rows = []
    for utt in ds.utterances[:n]:
        wav_gt = load_wav(ds.root / utt.wav_path)[0][0]
        feats = ds.load_features(utt)
        stem = Path(utt.wav_path).stem

        # copy synthesis: ground-truth mel -> vocoder -> wav
        mel = torch.tensor(feats["mel"], device=device)[None]
        wav_copy = pipe.vocode(mel)[0, 0].cpu().numpy()
        k = min(len(wav_gt), len(wav_copy))
        row = dict(wav_path=utt.wav_path, copy_mel_mae=metric(mel_mae, wav_gt[:k], wav_copy[:k]),
                   copy_mcd=metric(mcd, wav_gt[:k], wav_copy[:k]))
        save_wav(out / f"{stem}_copy.wav", wav_copy, audio.sample_rate)

        # full TTS from the text, DTW-aligned against the recording
        wav_tts = pipe.synthesize(utt.text)
        k = min(len(wav_gt), len(wav_tts))
        f0m = metric(f0_metrics_dtw, wav_gt, wav_tts)
        row.update(tts_mel_mae_dtw=metric(mel_mae_dtw, wav_gt, wav_tts),
                   tts_mcd=metric(mcd, wav_gt[:k], wav_tts[:k]),
                   tts_f0_rmse=f0m["f0_rmse_hz"], tts_voicing_f1=f0m["voicing_f1"],
                   tts_samples=len(wav_tts))
        save_wav(out / f"{stem}_tts.wav", wav_tts, audio.sample_rate)
        rows.append(row)
        print(f"{utt.wav_path}: copy mel-MAE {row['copy_mel_mae']:.4f} MCD "
              f"{row['copy_mcd']:.3f} dB | tts dtw-mel-MAE {row['tts_mel_mae_dtw']:.4f} MCD "
              f"{row['tts_mcd']:.3f} dB F0-RMSE {row['tts_f0_rmse']:.2f} Hz vF1 "
              f"{row['tts_voicing_f1']:.3f}")

    def col(key):
        return np.array([r[key] for r in rows], dtype=np.float64)

    avg = dict(copy_mel_mae=float(np.mean(col("copy_mel_mae"))),
               copy_mcd=float(np.mean(col("copy_mcd"))),
               tts_mel_mae_dtw=float(np.mean(col("tts_mel_mae_dtw"))),
               tts_mcd=float(np.mean(col("tts_mcd"))),
               tts_f0_rmse=float(np.nanmean(col("tts_f0_rmse"))),
               tts_voicing_f1=float(np.mean(col("tts_voicing_f1"))))
    print(f"AVG over {len(rows)}: copy mel-MAE {avg['copy_mel_mae']:.4f} "
          f"MCD {avg['copy_mcd']:.3f} dB | tts dtw-mel-MAE {avg['tts_mel_mae_dtw']:.4f} "
          f"MCD {avg['tts_mcd']:.3f} dB F0-RMSE {avg['tts_f0_rmse']:.2f} Hz "
          f"vF1 {avg['tts_voicing_f1']:.3f}")
    print(f"wavs in {out}")
    return dict(steps=(ac_step, voc_step), rows=rows, avg=avg)


def main(argv=None, cfg=None) -> dict:
    from .config import default_config

    args = parse_args(argv)
    return evaluate_demo(cfg or default_config(), args.metadata, args.acoustic_checkpoint,
                         args.vocoder_checkpoint, args.output_dir, args.n,
                         args.acoustic_step, args.vocoder_step, args.device)


if __name__ == "__main__":
    main()
