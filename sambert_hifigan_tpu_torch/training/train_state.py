"""Train states: the modules, their optimizers, the step on the host and the
EMA copy that inference prefers.  The vocoder's spectral-norm u/v, where a
discriminator has them, are that module's buffers.

Each state gives its checkpoint payload as `state_dict()` (nested state
dicts and the step) and takes one back with `load_state_dict`.  `BF16_KEYS`
names the payload entries that a save at precision="bf16" may downcast, and
`EMA_KEY` the entry of the EMA model (None when the state carries none)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from torch import nn

from ..models.acoustic_model import SAMBERTAcousticModel
from ..models.hifigan import HiFiGAN, HiFiGANGenerator
from .optim import Optimizer, ema_copy


def _ema_state(ema: Optional[nn.Module]) -> Optional[dict]:
    return None if ema is None else ema.state_dict()


def _load_ema(ema: Optional[nn.Module], sd: Optional[dict],
              module: nn.Module) -> Optional[nn.Module]:
    """An EMA in the checkpoint that the state does not carry is dropped; an
    EMA the state wants that the checkpoint lacks starts from the restored
    module."""
    if ema is None:
        return None
    if sd is None:
        return ema_copy(module)
    ema.load_state_dict(sd)
    return ema


@dataclass
class AcousticTrainState:
    """AdamW on the acoustic model.  `step` counts train steps (micro-steps
    when accumulating) on the host."""

    model: SAMBERTAcousticModel
    opt: Optimizer
    step: int = 0
    ema: Optional[SAMBERTAcousticModel] = None

    BF16_KEYS = ("opt",)
    EMA_KEY = "ema"

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "opt": self.opt.state_dict(),
                "ema": _ema_state(self.ema), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.opt.load_state_dict(sd["opt"])
        self.ema = _load_ema(self.ema, sd["ema"], self.model)
        self.step = int(sd["step"])


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

    # the optimizers and the discriminators: inference loads neither
    BF16_KEYS = ("msd", "mpd", "g_opt", "d_opt")
    EMA_KEY = "g_ema"

    def state_dict(self) -> dict:
        m = self.model
        return {"generator": m.generator.state_dict(), "msd": m.msd.state_dict(),
                "mpd": m.mpd.state_dict(), "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "g_ema": _ema_state(self.g_ema),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        m = self.model
        m.generator.load_state_dict(sd["generator"])
        m.msd.load_state_dict(sd["msd"])
        m.mpd.load_state_dict(sd["mpd"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.g_ema = _load_ema(self.g_ema, sd["g_ema"], m.generator)
        self.step = int(sd["step"])
