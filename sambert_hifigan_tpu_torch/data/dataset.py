"""Acoustic batches: the synthetic batch of the JAX package's
`data/dataset.py` (numpy, the same draws from the same seed), and its move
to the device.  The corpus loader (`TTSDataset`, `collate_acoustic`) is not
ported yet."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import TTSConfig


def synthetic_batch(
    cfg: TTSConfig, batch: int = 4, tph: int = 16, tfrm: int = 64, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Deterministic random acoustic batch honoring all invariants
    (sum(dur) <= tfrm, masks consistent).  For tests and smoke training."""
    rng = np.random.default_rng(seed)
    fe = cfg.acoustic_model.frontend
    dur = rng.integers(1, max(2, tfrm // tph), (batch, tph)).astype(np.int32)
    totals = dur.sum(axis=1)
    return {
        "ph_ids": rng.integers(4, fe.vocab_size, (batch, tph)).astype(np.int32),
        "tone_ids": rng.integers(0, fe.tone_size, (batch, tph)).astype(np.int32),
        "boundary_ids": rng.integers(0, fe.boundary_size, (batch, tph)).astype(np.int32),
        "dur_gt": dur,
        "mel_gt": rng.standard_normal((batch, tfrm, cfg.audio.n_mels)).astype(np.float32),
        "pitch_gt": rng.uniform(80, 600, (batch, tfrm)).astype(np.float32),
        "energy_gt": rng.uniform(0, 1, (batch, tfrm)).astype(np.float32),
        "phoneme_mask": np.ones((batch, tph), bool),
        "pitch_mask": rng.random((batch, tfrm)) > 0.3,
        "frame_lengths": totals.astype(np.int32),
    }


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays the train step reads, as tensors on `device` (ids as
    int64, the embeddings' index type; `frame_lengths` stays behind)."""
    out = {}
    for k, v in batch.items():
        if k == "frame_lengths":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k.endswith("_ids"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out
