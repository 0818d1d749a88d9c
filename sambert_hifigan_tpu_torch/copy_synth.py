"""Copy-synthesize a corpus with one vocoder checkpoint: ground-truth mel
-> wav.

  python -m sambert_hifigan_tpu_torch.copy_synth --metadata eval/metadata.csv \
      --vocoder-checkpoint checkpoints/vocoder [--vocoder-step 5000] \
      --output-dir /tmp/copy [--n 12] [--params auto|raw] [--config c.yaml \
      --model-config m.yaml] [--device cpu]

The counterpart of the JAX package's `scripts/copy_synth.py`.  Feeds each
utterance's ground-truth mel (TTSDataset features) through the HiFi-GAN
generator alone, every MRF through K2 on the card (its plain version on the
CPU), and writes `<stem>_copy.wav`; `eval_vocoder_waveform` scores them.
`--params auto` prefers the checkpoint's EMA generator when it has one.
Runs on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--metadata", type=str, required=True)
    p.add_argument("--vocoder-checkpoint", type=str, required=True)
    p.add_argument("--vocoder-step", type=int, default=None)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--params", choices=["auto", "raw"], default="auto",
                   help="auto = the checkpoint's EMA generator when it carries one; raw = "
                        "always the trained generator (for EMA-vs-raw comparisons)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def load_generator(cfg, checkpoint: str, step: Optional[int] = None, params: str = "auto",
                   device=None):
    """(generator in eval mode on `device`, its K2 weights, checkpoint step,
    'ema' or 'raw')."""
    from .kernels import kernel_dtype, resolve_device
    from .models.hifigan import HiFiGANGenerator
    from .training.checkpoint import CheckpointManager

    device = resolve_device(device)
    tree, step = CheckpointManager(checkpoint, cfg.audio).restore_tree(step=step)
    which = "ema" if params == "auto" and tree.get("g_ema") is not None else "raw"
    gen = HiFiGANGenerator(cfg.vocoder.generator)
    gen.load_state_dict(tree["g_ema"] if which == "ema" else tree["generator"])
    gen.to(device).eval()
    return gen, gen.pack(kernel_dtype(device)), step, which


def copy_synthesize(cfg, metadata: str, checkpoint: str, output_dir: str,
                    step: Optional[int] = None, n: Optional[int] = None, params: str = "auto",
                    device=None) -> Tuple[int, str, List[Tuple[Path, int]]]:
    """Writes one wav per utterance; returns (step, 'ema' or 'raw',
    [(wav written, samples)])."""
    import torch

    from .data.audio import save_wav
    from .data.dataset import TTSDataset
    from .kernels import resolve_device
    from .pipeline import _ieee_f32

    device = resolve_device(device)
    gen, mrf_weights, step, which = load_generator(cfg, checkpoint, step, params, device)
    ds = TTSDataset(metadata, cfg, device=device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for utt in ds.utterances[:n] if n else ds.utterances:
        mel = torch.tensor(ds.load_features(utt)["mel"], device=device)  # [T, n_mels]
        with torch.no_grad(), _ieee_f32():
            wav = gen(mel.T[None], mrf_weights)[0, 0].cpu().numpy()
        path = out / f"{Path(utt.wav_path).stem}_copy.wav"
        save_wav(path, wav, cfg.audio.sample_rate)
        written.append((path, len(wav)))
    return step, which, written


def main(argv=None):
    from .config import default_config, load_config

    args = parse_args(argv)
    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    step, which, written = copy_synthesize(cfg, args.metadata, args.vocoder_checkpoint,
                                           args.output_dir, args.vocoder_step, args.n,
                                           args.params, args.device)
    print(f"vocoder checkpoint step {step} (params: {which})")
    for path, samples in written:
        print(f"{path} <- {samples} samples")
    print(f"wavs in {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
