"""Precompute a corpus's features (log-mel, F0, energy, durations).

  python -m sambert_hifigan_tpu_torch.preprocess --metadata data/train/metadata.csv \
      [--cache-dir DIR] [--aligner {uniform,ctc}] [--aligner-steps 400] [--device cpu]

Features are cached as .npz (the cache TTSDataset fills lazily, under the
JAX package's keys and field names); running this first takes extraction
off the training loop.  '--aligner ctc' (the default) trains the corpus CTC
aligner and Viterbi-aligns every utterance (data/aligner.py); 'uniform'
keeps the even-split bootstrap.  Runs on the CUDA card unless --device cpu
is given.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metadata", type=str, required=True)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--aligner", choices=["uniform", "ctc"], default="ctc",
                   help="duration targets: 'ctc' trains the corpus CTC aligner and "
                        "Viterbi-aligns every utterance; 'uniform' keeps the even split")
    p.add_argument("--aligner-steps", type=int, default=400)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    from .config import default_config, load_config
    from .data.dataset import TTSDataset

    args = parse_args(argv)
    cfg = load_config(args.config) if args.config else default_config()
    ds = TTSDataset(args.metadata, cfg, cache_dir=args.cache_dir, device=args.device)
    t0 = time.perf_counter()
    for i, utt in enumerate(ds.utterances):
        feats = ds.load_features(utt)
        print(f"[{i + 1}/{len(ds)}] {utt.wav_path}: {feats['mel'].shape[0]} frames, "
              f"{int(feats['voiced'].sum())} voiced")
    print(f"extracted on {ds.device} in {time.perf_counter() - t0:.1f}s; cache at "
          f"{ds.cache_dir}")
    if args.aligner == "ctc":
        t0 = time.perf_counter()
        losses = ds.compute_alignments(steps=args.aligner_steps)
        print(f"aligned {len(ds)} utterances in {time.perf_counter() - t0:.1f}s "
              f"(CTC loss {losses[0]:.3f} -> {losses[-1]:.3f})")
    return ds


if __name__ == "__main__":
    main()
