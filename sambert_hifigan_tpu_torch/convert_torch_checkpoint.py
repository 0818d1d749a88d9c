"""Convert a reference-format PyTorch checkpoint into a checkpoint of the
port (the migration path for users of the reference repo).

  python -m sambert_hifigan_tpu_torch.convert_torch_checkpoint --model acoustic \
      --input sambert.pt --output checkpoints/acoustic
  python -m sambert_hifigan_tpu_torch.convert_torch_checkpoint --model hifigan \
      --input hifigan.pt --output checkpoints/vocoder
  python -m sambert_hifigan_tpu_torch.convert_torch_checkpoint --model generator \
      --input generator_only.pt --output checkpoints/vocoder

The counterpart of the JAX package's `scripts/convert_torch_checkpoint.py`.
"Reference format" is a torch `state_dict()` of the reference's model
classes, optionally nested under a 'state_dict', 'model' or 'generator'
key as torch training scripts save them.  The tensors go through the
port's copy of the JAX package's converters (interop.py) into the port's
models.  The output directory is a `CheckpointManager` checkpoint at step
0 (fresh optimizer state around the carried weights; for `generator`, the
discriminators are random from --seed), which `inference` and `serve
--acoustic-checkpoint/--vocoder-checkpoint` load and the trainers'
--resume continue.  A pure host conversion: no device is touched.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["acoustic", "hifigan", "generator"], required=True)
    p.add_argument("--input", type=str, required=True,
                   help="torch checkpoint (.pt/.pth) with a reference-format state_dict")
    p.add_argument("--output", type=str, required=True, help="output checkpoint directory")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


PROBE_KEYS = {"acoustic": "phoneme_embedding.ph_emb.weight",
              "hifigan": "generator.conv_pre.weight",
              "generator": "conv_pre.weight"}


def load_state_dict(path: str):
    """The reference-format state_dict of a torch checkpoint, as numpy."""
    import torch

    from .interop import state_dict_to_numpy

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "generator"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return state_dict_to_numpy(obj)


def main(argv=None):
    import torch

    from . import interop
    from .config import default_config, load_config
    from .models.hifigan import HiFiGAN
    from .models.layers import init_defaults_
    from .training.acoustic_trainer import init_acoustic_state
    from .training.checkpoint import CheckpointManager
    from .training.vocoder_trainer import vocoder_state_from_model
    from .weights import random_acoustic_model

    args = parse_args(argv)
    cfg = (load_config(args.config, args.model_config) if args.config or args.model_config
           else default_config())
    sd = load_state_dict(args.input)
    probe = PROBE_KEYS[args.model]
    if probe not in sd:
        sys.exit(
            f"error: checkpoint does not look like a reference-format '{args.model}' "
            f"state_dict (missing key {probe!r}; found keys like {sorted(sd)[:5]}). "
            "Pass the matching --model.")

    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "acoustic":
        model = random_acoustic_model(cfg, gen)
        model.load_state_dict(interop.acoustic_state_dict_from_torch(sd, cfg))
        state = init_acoustic_state(model, cfg)
        n = sum(p.numel() for p in model.parameters())
    else:
        model = HiFiGAN(cfg.vocoder)
        init_defaults_(model, gen)
        if args.model == "hifigan":
            model.load_state_dict(interop.hifigan_state_dict_from_torch(sd, cfg))
        else:  # a bare generator; the discriminators stay random
            model.generator.load_state_dict(interop.generator_state_dict_from_torch(sd, cfg))
        state = vocoder_state_from_model(model, cfg)  # an EMA starts from the carried weights
        n = sum(p.numel() for p in model.generator.parameters())
    CheckpointManager(args.output, cfg.audio).save(0, state)
    print(f"[convert] wrote {args.model} checkpoint (step 0, {n:,} generator/model params) "
          f"to {args.output}")
    return state


if __name__ == "__main__":
    main()
