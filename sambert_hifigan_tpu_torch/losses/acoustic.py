"""Acoustic-model losses.

L_total = w_mel * L1(mel) + w_dur * MSE(log_dur_pred, log(dur_gt + 1))
        + w_pitch * MSE(pitch, masked) + w_energy * MSE(energy, masked)

Masked means: loss * mask summed over valid entries, divided by
(mask.sum() + 1e-8); the mel loss divides by (mask.sum() * n_mels + 1e-8).
Without a mask, a plain mean.  Every value is a 0-dim tensor on the
device: nothing here waits for it.

Data parallel (parallel/mesh.py): the JAX step takes these means over the
GLOBAL batch, so the denominators are global.  `loss_counts` gives a
rank's four denominators (valid frames for mel and energy, phonemes,
voiced frames); summed over the ranks and passed back as `counts`, each
rank's terms are its masked sums over the global counts, and the sum of
the ranks' terms (and of their gradients) is the global loss.  Averaging
per-rank means would weigh a shard with few valid frames as much as one
with many.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import LossWeights


def _masked_mean(loss: torch.Tensor, mask: Optional[torch.Tensor],
                 count: Optional[torch.Tensor] = None, width: int = 1) -> torch.Tensor:
    """sum(loss * mask) / (count * width + 1e-8), `count` the mask's sum
    unless given (the global one); without a mask, the plain mean (`count`:
    the global number of elements)."""
    if mask is None:
        return loss.mean() if count is None else loss.sum() / count
    m = mask.to(loss.dtype)
    while m.dim() < loss.dim():
        m = m[..., None]
    return (loss * m).sum() / ((m.sum() if count is None else count) * width + 1e-8)


def mel_l1_loss(mel_pred: torch.Tensor, mel_gt: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 over [B, T, n_mels]; with a [B, T] mask, the mean over valid
    frames x mels.  `count`: the global number of valid frames (or of
    elements, without a mask)."""
    return _masked_mean((mel_pred - mel_gt).abs(), mask, count, mel_pred.shape[-1])


def duration_loss(log_dur_pred: torch.Tensor, dur_gt: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE(log_dur_pred, log(dur_gt + 1))."""
    log_dur_gt = torch.log(dur_gt.float() + 1.0)
    return _masked_mean(torch.square(log_dur_pred - log_dur_gt), mask, count)


def pitch_loss(pitch_pred: torch.Tensor, pitch_gt: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over the voiced frames of `mask`."""
    return _masked_mean(torch.square(pitch_pred - pitch_gt), mask, count)


def energy_loss(energy_pred: torch.Tensor, energy_gt: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(torch.square(energy_pred - energy_gt), mask, count)


def _count(mask: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """A mask's number of set entries, or `like`'s number of elements."""
    if mask is None:
        return torch.full((), float(like.numel()), dtype=torch.float32, device=like.device)
    return mask.to(torch.float32).sum()


def loss_counts(mel_gt: torch.Tensor, dur_gt: torch.Tensor, pitch_gt: torch.Tensor,
                mel_mask: Optional[torch.Tensor] = None,
                phoneme_mask: Optional[torch.Tensor] = None,
                pitch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's denominators [4]: valid frames (the mel loss's, which it
    multiplies by n_mels; the energy loss's), phonemes, voiced frames.
    Without a mask, the elements of the term."""
    return torch.stack([
        _count(mel_mask, mel_gt), _count(phoneme_mask, dur_gt), _count(pitch_mask, pitch_gt),
        _count(mel_mask, pitch_gt)])


def acoustic_loss(
    mel_pred: torch.Tensor,
    mel_gt: torch.Tensor,
    log_dur_pred: torch.Tensor,
    dur_gt: torch.Tensor,
    pitch_pred: torch.Tensor,
    pitch_gt: torch.Tensor,
    energy_pred: torch.Tensor,
    energy_gt: torch.Tensor,
    mel_mask: Optional[torch.Tensor] = None,
    phoneme_mask: Optional[torch.Tensor] = None,
    pitch_mask: Optional[torch.Tensor] = None,
    weights: LossWeights = LossWeights(),
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted total and its terms, under the keys total_loss,
    mel_loss, dur_loss, pitch_loss, energy_loss.  `counts`: the global
    denominators (`loss_counts` summed over the ranks); each term is then
    this rank's share of the global mean."""
    c = [None] * 4 if counts is None else list(counts)
    l_mel = mel_l1_loss(mel_pred, mel_gt, mel_mask, c[0])
    l_dur = duration_loss(log_dur_pred, dur_gt, phoneme_mask, c[1])
    l_pitch = pitch_loss(pitch_pred, pitch_gt, pitch_mask, c[2])
    l_energy = energy_loss(energy_pred, energy_gt, mel_mask, c[3])
    total = (weights.mel * l_mel + weights.dur * l_dur + weights.pitch * l_pitch
             + weights.energy * l_energy)
    return total, {"total_loss": total, "mel_loss": l_mel, "dur_loss": l_dur,
                   "pitch_loss": l_pitch, "energy_loss": l_energy}
