"""Checkpoints of a train state: `step_<n>/state.pt` (a `torch.save` of the
state dicts) and `step_<n>/meta.json` (the step, the mel-config
fingerprint, the save precision, whether an EMA is inside), written last:
a directory without it is an aborted save and is ignored.

The payload is the train state's own `state_dict()` (train_state.py): of
an `AcousticTrainState`, the model, its optimizer, the EMA model, the step;
of a `VocoderTrainState`, generator, MSD, MPD, both optimizers, the EMA
generator, the step.

A checkpoint trained under another mel configuration is refused (the
train/infer invariant).  `precision="bf16"` stores the state's `BF16_KEYS`
in bf16: every optimizer moment (and the discriminators' weights and
buffers); the models that
inference loads, and their EMA copies, stay f32.  The last `keep`
checkpoints are kept.

`save(..., background=True)` copies the state on the device, in stream
order (so the next step may update it in place at once), and a thread
brings the copy to the host and writes it.  One save is in flight at a
time; a failed one raises at the next `save` or `wait`, and `drain`
returns its error instead, for the paths that must still save.

In a process group (parallel/mesh.py) only rank 0 writes, background saves
included; the replicas are identical, and every rank restores from the
same directory.  `finish` is the barrier after the last save: no rank
exits (or resumes) before the write has landed.

A state sharded over the model axis (tensor parallelism) is saved in the
same format, with whole tensors: every rank calls `save`, which gathers
the slices (the train state's `state_dict()`, collectives in step order on
the caller's thread; a background save then writes that copy), and rank 0
writes.  A checkpoint is restored into the whole state, before the
trainer shards it, so any model size resumes from any other's checkpoint.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import torch

from ..config import AudioConfig, ConfigError, mel_config_fingerprint
from ..parallel import mesh
from .train_state import AcousticTrainState, VocoderTrainState

TrainState = Union[AcousticTrainState, VocoderTrainState]


def _map(fn, tree: Any, skip: Tuple[str, ...] = ()) -> Any:
    """fn on every tensor of a nested dict/list, but those under a key in
    `skip`."""
    if isinstance(tree, dict):
        return {k: v if k in skip else _map(fn, v, skip) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, skip) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _to_bf16(tree: Any) -> Any:
    """Every float32 tensor of a nested dict/list as bf16, except the
    optimizers' step counters."""
    return _map(lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, tree,
                skip=("step",))


class CheckpointManager:
    def __init__(self, directory: str, audio: AudioConfig, keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.audio = audio
        self.keep = keep
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:09d}"

    def _fingerprint(self) -> list:
        return list(map(str, mel_config_fingerprint(self.audio)))

    def save(self, step: int, state: TrainState, precision: Optional[str] = None,
             background: bool = False) -> None:
        """Write a checkpoint of `state` at `step`; with `background`, on a
        thread, from a copy made on the device (see the module docstring)."""
        if precision not in (None, "f32", "bf16"):
            raise ValueError(f"unknown save precision: {precision!r}")
        if not (mesh.is_main() or state.sharded):  # the replicas are identical
            return
        payload = state.state_dict()  # a sharded state gathers: every rank takes part
        if not mesh.is_main():  # rank 0 writes
            return
        payload["step"] = int(step)
        if precision == "bf16":
            payload.update({k: _to_bf16(payload[k]) for k in state.BF16_KEYS})
        meta = {"step": int(step), "mel_fingerprint": self._fingerprint(),
                "ema": payload[state.EMA_KEY] is not None}
        if precision:
            meta["precision"] = precision
        if not background:
            self.wait()
            self._write(step, payload, meta)
            return
        snapshot = _map(torch.clone, payload)  # enqueued before the next step's updates
        self.wait()

        def run():
            try:
                self._write(step, _map(lambda t: t.cpu(), snapshot), meta)
            except Exception as e:  # noqa: BLE001 — raised by the next wait()
                self._save_error = e

        self._save_thread = threading.Thread(target=run, name=f"ckpt-save-{step}", daemon=True)
        self._save_thread.start()

    def wait(self) -> None:
        """Block until the background save in flight, if any, is written;
        raise its error if it failed."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise err

    def drain(self) -> Optional[BaseException]:
        """`wait` that returns a failed background save's error instead of
        raising it."""
        try:
            self.wait()
        except Exception as e:  # noqa: BLE001 — handed to the caller
            return e
        return None

    def needs_save(self, step: int) -> bool:
        """Whether the latest checkpoint on disk is not of `step`, as rank 0
        sees it (after its own saves landed: call after `drain`), on every
        rank: a sharded state's save is a collective, so every rank must
        take the same branch, and another rank may read the directory
        before rank 0's background write has landed."""
        return mesh.any_rank(mesh.is_main() and self.latest_step() != step)

    def finish(self) -> Optional[BaseException]:
        """`drain`, then wait for every rank: after it, the last save is on
        disk for all of them.  Returns the drained error, if any."""
        err = self.drain()
        mesh.barrier()
        return err

    def _write(self, step: int, payload: dict, meta: dict) -> None:
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
        """Whether the (latest or given) checkpoint carries an EMA model."""
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

    def restore(self, state: TrainState, step: Optional[int] = None) -> int:
        """Load the (latest or given) checkpoint into `state` in place; returns
        its step.  Float tensors come back in the state's own dtypes."""
        # loaded to the host: load_state_dict copies into the modules' own
        # tensors, and the optimizers keep their step counts on the host as
        # torch.optim does (a count on the card would cost a sync a step)
        payload, step = self.restore_tree(step)
        state.load_state_dict(payload)
        return step
