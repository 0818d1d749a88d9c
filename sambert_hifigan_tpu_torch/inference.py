"""Text -> WAV from the command line.

  python -m sambert_hifigan_tpu_torch.inference --text "你好世界" --output out.wav \
      [--acoustic-checkpoint checkpoints/acoustic] [--vocoder-checkpoint checkpoints/vocoder] \
      [--seed 0] [--duration-scale 1.0] [--pitch-shift 0.0] [--energy-scale 1.0] \
      [--stream] [--chunk-frames 32] [--benchmark] [--device cpu]

The checkpoints are the training directories of `train_acoustic` and
`train_vocoder`: the latest step of each is loaded, its EMA copy where it
has one.  A model without a checkpoint has random weights made from
--seed.  With --stream the wav is synthesized chunk by chunk
(`TTSPipeline.stream`) and the chunks are written out together.  Runs on
the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--text", type=str, required=True)
    p.add_argument("--output", type=str, default="outputs/out.wav")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--acoustic-checkpoint", type=str, default=None)
    p.add_argument("--vocoder-checkpoint", type=str, default=None)
    p.add_argument("--duration-scale", type=float, default=1.0)
    p.add_argument("--pitch-shift", type=float, default=0.0)
    p.add_argument("--energy-scale", type=float, default=1.0)
    p.add_argument("--stream", action="store_true")
    p.add_argument("--chunk-frames", type=int, default=32)
    p.add_argument("--benchmark", action="store_true",
                   help="synthesize twice and report the warm RTF")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np
    import torch

    from .config import default_config, load_config
    from .data.audio import save_wav
    from .pipeline import build_pipeline

    args = parse_args(argv)
    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    pipe = build_pipeline(cfg, args.seed, args.device, args.acoustic_checkpoint,
                          args.vocoder_checkpoint)
    print(f"[inference] acoustic: {args.acoustic_checkpoint or f'random (seed {args.seed})'}, "
          f"vocoder: {args.vocoder_checkpoint or f'random (seed {args.seed})'}, "
          f"on {pipe.device}")
    controls = dict(
        duration_scale=args.duration_scale,
        pitch_shift=args.pitch_shift,
        energy_scale=args.energy_scale,
    )

    def timed():
        t0 = time.perf_counter()
        if args.stream:
            chunks = []
            for i, chunk in enumerate(pipe.stream(args.text, args.chunk_frames, **controls)):
                chunks.append(chunk)
                print(f"[inference] chunk {i}: {chunk.shape[0]} samples "
                      f"(+{time.perf_counter() - t0:.3f}s)")
            wav = np.concatenate(chunks)
        else:
            wav = pipe.synthesize(args.text, **controls)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        return wav, time.perf_counter() - t0

    wav, wall = timed()
    dur = wav.shape[0] / cfg.audio.sample_rate
    print(f"[inference] {dur:.2f}s audio in {wall:.2f}s (RTF {wall / max(dur, 1e-9):.3f}, "
          "incl. kernel build)")
    if args.benchmark:
        wav, warm = timed()
        print(f"[inference] warm run: {warm * 1e3:.1f} ms (RTF {warm / max(dur, 1e-9):.4f})")
    save_wav(args.output, wav, cfg.audio.sample_rate)
    print(f"[inference] wrote {args.output}")


if __name__ == "__main__":
    main()
