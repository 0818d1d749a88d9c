"""Held-out teacher-forced mel L1.

  python -m sambert_hifigan_tpu_torch.eval_teacher_forced --metadata eval/metadata.csv \
      --acoustic-checkpoint checkpoints/acoustic [--acoustic-step N] [--params ema|raw] \
      [--n 12] [--config c.yaml --model-config m.yaml] [--device cpu]

The counterpart of the JAX package's `scripts/eval_teacher_forced.py`.  Runs
the acoustic model's training forward (ground-truth durations and mel
feedback, predicted pitch and energy: the conditioning of the train step,
without dropout) on each of the first --n utterances of a held-out
metadata.csv, one utterance a batch padded to the config's buckets, and
reports the masked mel L1 the trainer logs as `mel_loss`.  It separates how
well the mel regression generalizes from duration-prediction error.  Runs
on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metadata", type=str, required=True)
    p.add_argument("--acoustic-checkpoint", type=str, required=True)
    p.add_argument("--acoustic-step", type=int, default=None)
    p.add_argument("--params", choices=["ema", "raw"], default="ema",
                   help="EMA weights when the checkpoint has them (default)")
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def teacher_forced_mel_l1(cfg, metadata: str, checkpoint: str, step: Optional[int] = None,
                          params: str = "ema", n: int = 12,
                          device=None) -> Tuple[int, str, List[Tuple[str, float]]]:
    """(checkpoint step, 'ema' or 'raw', [(wav path, teacher-forced mel L1)])."""
    import torch

    from .data.dataset import TTSDataset, batch_to_device, collate_acoustic
    from .kernels import resolve_device
    from .losses.acoustic import mel_l1_loss
    from .models.acoustic_model import SAMBERTAcousticModel
    from .training.checkpoint import CheckpointManager

    device = resolve_device(device)
    ds = TTSDataset(metadata, cfg, device=device)
    tree, step = CheckpointManager(checkpoint, cfg.audio).restore_tree(step=step)
    which = "ema" if params == "ema" and tree.get("ema") is not None else "raw"
    model = SAMBERTAcousticModel(cfg.acoustic_model)
    model.load_state_dict(tree["ema"] if which == "ema" else tree["model"])
    model.to(device).eval()
    vals = []
    with torch.no_grad():
        for utt in ds.utterances[:n]:
            batch = batch_to_device(collate_acoustic(
                [ds.load_features(utt)], cfg.runtime.phoneme_buckets,
                cfg.runtime.frame_buckets), device)
            out = model(batch["ph_ids"], batch["tone_ids"], batch["boundary_ids"],
                        batch["mel_gt"], batch["dur_gt"], batch["pitch_gt"],
                        batch["energy_gt"], batch["phoneme_mask"])
            # the trainer's mel term: the masked mean over valid frames x mels
            vals.append((utt.wav_path, float(mel_l1_loss(out.mel_pred.float(),
                                                          batch["mel_gt"], out.frame_mask))))
    return step, which, vals


def main(argv=None):
    import numpy as np

    from .config import default_config, load_config

    args = parse_args(argv)
    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    step, which, vals = teacher_forced_mel_l1(
        cfg, args.metadata, args.acoustic_checkpoint, args.acoustic_step, args.params,
        args.n, args.device)
    for path, v in vals:
        print(f"{path}: tf mel L1 {v:.4f}")
    mean = float(np.mean([v for _, v in vals]))
    print(f"[eval_teacher_forced] step {step} ({which} params), n={len(vals)}: "
          f"mean tf mel L1 {mean:.4f}")
    return {"step": step, "params": which, "values": vals, "mean": mean}


if __name__ == "__main__":
    main()
