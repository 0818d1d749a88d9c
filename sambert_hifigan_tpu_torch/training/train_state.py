"""The vocoder's train state: the modules, their two optimizers, the step and
the generator's EMA.  The spectral-norm u/v, where a discriminator has
them, are that module's buffers."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..models.hifigan import HiFiGAN, HiFiGANGenerator
from .optim import Optimizer


@dataclass
class VocoderTrainState:
    """AdamW on the generator, AdamW on MSD + MPD jointly.  `step` counts
    train steps (micro-steps when accumulating) on the host."""

    model: HiFiGAN
    g_opt: Optimizer
    d_opt: Optimizer
    step: int = 0
    # EMA of the generator only (the discriminators are not used at inference)
    g_ema: Optional[HiFiGANGenerator] = None
