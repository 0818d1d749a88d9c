"""Train states: the modules, their optimizers, the step on the host and the
EMA copy that inference prefers.  The vocoder's spectral-norm u/v, where a
discriminator has them, are that module's buffers.

Each state gives its checkpoint payload as `state_dict()` (nested state
dicts and the step) and takes one back with `load_state_dict`.  `BF16_KEYS`
names the payload entries that a save at precision="bf16" may downcast, and
`EMA_KEY` the entry of the EMA model (None when the state carries none).

`shard_()` stores the state sharded over the model axis (tensor
parallelism, parallel/sharding_rules.py): each optimizer's parameters,
moments and accumulator, and the EMA copy, keep this rank's slices.  The
payload of a sharded state is still whole (the model = 1 format): its
`state_dict()` gathers, a collective every rank of the model group calls.
A checkpoint is restored into the whole state, before `shard_()`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from torch import nn

from ..models.acoustic_model import SAMBERTAcousticModel
from ..models.hifigan import HiFiGAN, HiFiGANGenerator
from ..parallel import mesh, sharding_rules
from .optim import Optimizer, ema_copy


def _module_state(module: Optional[nn.Module], dims: Sequence) -> Optional[dict]:
    """A module's state dict with its sharded parameters whole."""
    if module is None:
        return None
    return sharding_rules.full_module_state(module, dims)


def _shard(opt: Optimizer, modules: Sequence[nn.Module], ema: Optional[nn.Module]) -> None:
    """The shape rule's slices of an optimizer (over `modules`, whose
    parameters it holds) and of the EMA copy of them."""
    dims = sharding_rules.param_dims(modules, mesh.model_size())
    opt.shard_(dims)
    if ema is not None:
        sharding_rules.shard_module_(ema, dims)


def persistent_numel(state) -> int:
    """Elements a train state holds on this rank between steps: its
    parameters, both Adam moments and the EMA copies."""
    n = 0
    for opt, ema in state.parts():
        n += sum(p.numel() for p in opt.params)
        n += sum(t.numel() for st in opt.adamw.state.values()
                 for k, t in st.items() if k in ("exp_avg", "exp_avg_sq"))
        n += 0 if ema is None else sum(p.numel() for p in ema.parameters())
    return n


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

    @property
    def sharded(self) -> bool:
        return self.opt.sharded

    def shard_(self) -> None:
        _shard(self.opt, [self.model], self.ema)

    def parts(self) -> List[Tuple[Optimizer, Optional[nn.Module]]]:
        """Each optimizer with the EMA copy of its parameters (or None)."""
        return [(self.opt, self.ema)]

    def state_dict(self) -> dict:
        dims = self.opt.dims
        return {"model": _module_state(self.model, dims), "opt": self.opt.state_dict(),
                "ema": _module_state(self.ema, dims), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])  # raises on a sharded state
        self.model.load_state_dict(sd["model"])
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

    @property
    def sharded(self) -> bool:
        return self.g_opt.sharded

    def shard_(self) -> None:
        m = self.model
        _shard(self.g_opt, [m.generator], self.g_ema)
        _shard(self.d_opt, [m.msd, m.mpd], None)

    def parts(self) -> List[Tuple[Optimizer, Optional[nn.Module]]]:
        """Each optimizer with the EMA copy of its parameters (or None)."""
        return [(self.g_opt, self.g_ema), (self.d_opt, None)]

    def state_dict(self) -> dict:
        m, g_dims, d_dims = self.model, self.g_opt.dims, self.d_opt.dims
        n_msd = len(list(m.msd.parameters()))
        return {"generator": _module_state(m.generator, g_dims),
                "msd": _module_state(m.msd, d_dims[:n_msd]),
                "mpd": _module_state(m.mpd, d_dims[n_msd:]), "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "g_ema": _module_state(self.g_ema, g_dims),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        m = self.model
        self.g_opt.load_state_dict(sd["g_opt"])  # raises on a sharded state
        self.d_opt.load_state_dict(sd["d_opt"])
        m.generator.load_state_dict(sd["generator"])
        m.msd.load_state_dict(sd["msd"])
        m.mpd.load_state_dict(sd["mpd"])
        self.g_ema = _load_ema(self.g_ema, sd["g_ema"], m.generator)
        self.step = int(sd["step"])
