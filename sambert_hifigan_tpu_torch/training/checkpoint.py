"""Checkpoints of the vocoder train state: `step_<n>/state.pt` (a
`torch.save` of the state dicts: generator, MSD, MPD, both optimizers, the
EMA generator, the step) and `step_<n>/meta.json` (the step, the mel-config
fingerprint, the save precision, whether an EMA is inside), written last:
a directory without it is an aborted save and is ignored.

A checkpoint trained under another mel configuration is refused (the
train/infer invariant).  `precision="bf16"` stores the discriminators'
weights and buffers and every optimizer moment in bf16, about half of a
GAN checkpoint; the generator and its EMA, which inference loads, stay f32.
The last `keep` checkpoints are kept.  Saves are synchronous.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from ..config import AudioConfig, ConfigError, mel_config_fingerprint
from .optim import ema_copy
from .train_state import VocoderTrainState

# what precision="bf16" downcasts: the discriminators and the optimizers
_BF16_FIELDS = ("msd", "mpd", "g_opt", "d_opt")


def _to_bf16(tree: Any) -> Any:
    """Every float32 tensor of a nested dict/list as bf16, except the
    optimizers' step counters."""
    if isinstance(tree, dict):
        return {k: tree[k] if k == "step" else _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_bf16(v) for v in tree)
    if torch.is_tensor(tree) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, audio: AudioConfig, keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.audio = audio
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:09d}"

    def _fingerprint(self) -> list:
        return list(map(str, mel_config_fingerprint(self.audio)))

    def save(self, step: int, state: VocoderTrainState, precision: Optional[str] = None) -> None:
        if precision not in (None, "f32", "bf16"):
            raise ValueError(f"unknown save precision: {precision!r}")
        model = state.model
        payload = {
            "step": int(step),
            "generator": model.generator.state_dict(),
            "msd": model.msd.state_dict(),
            "mpd": model.mpd.state_dict(),
            "g_opt": state.g_opt.state_dict(),
            "d_opt": state.d_opt.state_dict(),
            "g_ema": None if state.g_ema is None else state.g_ema.state_dict(),
        }
        if precision == "bf16":
            payload.update({k: _to_bf16(payload[k]) for k in _BF16_FIELDS})
        meta = {"step": int(step), "mel_fingerprint": self._fingerprint(),
                "ema": state.g_ema is not None}
        if precision:
            meta["precision"] = precision
        path = self._step_dir(step)
        if path.exists():  # an aborted save, or a save of the same step again
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(payload, path / "state.pt")
        (path / "meta.json").write_text(json.dumps(meta))
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.directory.glob("step_*")
                      if (p / "meta.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _meta(self, step: int) -> dict:
        return json.loads((self._step_dir(step) / "meta.json").read_text())

    def has_ema(self, step: Optional[int] = None) -> bool:
        """Whether the (latest or given) checkpoint carries an EMA generator."""
        step = self.latest_step() if step is None else step
        return step is not None and bool(self._meta(step).get("ema", False))

    def restore_tree(self, step: Optional[int] = None) -> Tuple[dict, int]:
        """The saved payload as written (state dicts, on the host), after the
        mel check."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        meta = self._meta(step)
        if meta["mel_fingerprint"] != self._fingerprint():
            raise ConfigError(
                "Checkpoint was trained with a different mel configuration: "
                f"{meta['mel_fingerprint']} vs current {self._fingerprint()}. Refusing to "
                "resume (mel consistency invariant)."
            )
        payload = torch.load(self._step_dir(step) / "state.pt", map_location="cpu",
                             weights_only=True)
        return payload, step

    def restore(self, state: VocoderTrainState, step: Optional[int] = None) -> int:
        """Load the (latest or given) checkpoint into `state` in place; returns
        its step.  Float tensors come back in the state's own dtypes.  An EMA
        in the checkpoint that the state does not carry is dropped; an EMA the
        state wants that the checkpoint lacks starts from the restored
        generator."""
        # loaded to the host: load_state_dict copies into the modules' own
        # tensors, and the optimizers keep their step counts on the host as
        # torch.optim does (a count on the card would cost a sync a step)
        payload, step = self.restore_tree(step)
        model = state.model
        model.generator.load_state_dict(payload["generator"])
        model.msd.load_state_dict(payload["msd"])
        model.mpd.load_state_dict(payload["mpd"])
        state.g_opt.load_state_dict(payload["g_opt"])
        state.d_opt.load_state_dict(payload["d_opt"])
        if state.g_ema is not None:
            if payload["g_ema"] is not None:
                state.g_ema.load_state_dict(payload["g_ema"])
            else:
                state.g_ema = ema_copy(model.generator)
        state.step = int(payload["step"])
        return step
