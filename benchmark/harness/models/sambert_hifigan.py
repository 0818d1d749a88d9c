"""SAM-BERT and the HiFi-GAN V1 generator: the model of a configuration
that says `"model": "sambert_hifigan"`.

A model module gives the drivers of one-shot calls and live streams all
that is the model's own, by these names:
  config(c)                   the program's config for a configuration file
  weights(c, cfg, seed, device)   the weights made from the seed, a bundle
                              the drivers hand on without looking inside
  pipeline(cfg, W, devices, dtype)   the program's pipeline over them
  reference_batch(W, c, texts, q, device)   the plain reference's wavs of
                              one call, in the precision `q`
  reference_stream(W, c, texts, chunk, context, q, device)   its chunks of
                              each text's stream
  TINY                        the configuration's keys at the CPU tests' size
Here the bundle is (acoustic state_dict, generator state_dict).
"""

from __future__ import annotations

import torch

from reference import acoustic as ref

from .. import port
from ..weights import make, pin_predictors

config = port.tts_config  # the vocoder trainer's glue maps the same keys

TINY = dict(d_model=32, encoder_layers=1, encoder_heads=2, encoder_ffn=64,
            decoder_layers=1, decoder_heads=2, decoder_ffn=64, n_mels=16,
            upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
            upsample_initial_channel=16, resblock_kernel_sizes=[3],
            resblock_dilation_sizes=[[1, 3]], hop_length=4, dtype="float32",
            frames_per_phoneme=2, phoneme_buckets=[8, 16, 32], frame_buckets=[32, 64, 128])


def shapes(cfg):
    """(acoustic, generator) state_dict layouts as [(name, shape)]."""
    from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel
    from sambert_hifigan_tpu_torch.models.hifigan import HiFiGANGenerator

    with torch.device("meta"):
        return (port.state_shapes(SAMBERTAcousticModel(cfg.acoustic_model)),
                port.state_shapes(HiFiGANGenerator(cfg.vocoder.generator)))


def weights(c: dict, cfg, seed: int, device):
    ac_shapes, gen_shapes = shapes(cfg)
    sd_ac = make(ac_shapes, seed, device)
    pin_predictors(sd_ac, c)
    sd_gen = make(gen_shapes, seed + 1, device)
    return sd_ac, sd_gen


def pipeline(cfg, W, devices, dtype):
    from sambert_hifigan_tpu_torch.pipeline import TTSPipeline

    acoustic_sd, generator_sd = W
    return TTSPipeline(cfg, acoustic_sd, generator_sd, device=devices[0],
                       devices=devices if len(devices) > 1 else None, dtype=dtype)


def reference_batch(W, c: dict, texts, q, device):
    return ref.synthesize_batch(W[0], ref.hifigan(W[1], c, q), c, texts, q, device)


def reference_stream(W, c: dict, texts, chunk: int, context: int, q, device):
    return ref.stream_chunks(W[0], ref.hifigan(W[1], c, q), c, texts, chunk, context, q,
                             device)
