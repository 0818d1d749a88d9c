"""Acoustic-model losses.

L_total = w_mel * L1(mel) + w_dur * MSE(log_dur_pred, log(dur_gt + 1))
        + w_pitch * MSE(pitch, masked) + w_energy * MSE(energy, masked)

Masked means: loss * mask summed over valid entries, divided by
(mask.sum() + 1e-8); the mel loss divides by (mask.sum() * n_mels + 1e-8).
Without a mask, a plain mean.  Every value is a 0-dim tensor on the
device: nothing here waits for it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import LossWeights


def _masked_mean(loss: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    while m.dim() < loss.dim():
        m = m[..., None]
    return (loss * m).sum() / (m.sum() + 1e-8)


def mel_l1_loss(mel_pred: torch.Tensor, mel_gt: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 over [B, T, n_mels]; with a [B, T] mask, the mean over valid
    frames x mels."""
    loss = (mel_pred - mel_gt).abs()
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    return (loss * m[..., None]).sum() / (m.sum() * mel_pred.shape[-1] + 1e-8)


def duration_loss(log_dur_pred: torch.Tensor, dur_gt: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE(log_dur_pred, log(dur_gt + 1))."""
    log_dur_gt = torch.log(dur_gt.float() + 1.0)
    return _masked_mean(torch.square(log_dur_pred - log_dur_gt), mask)


def pitch_loss(pitch_pred: torch.Tensor, pitch_gt: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over the voiced frames of `mask`."""
    return _masked_mean(torch.square(pitch_pred - pitch_gt), mask)


def energy_loss(energy_pred: torch.Tensor, energy_gt: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(torch.square(energy_pred - energy_gt), mask)


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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted total and its terms, under the keys total_loss,
    mel_loss, dur_loss, pitch_loss, energy_loss."""
    l_mel = mel_l1_loss(mel_pred, mel_gt, mel_mask)
    l_dur = duration_loss(log_dur_pred, dur_gt, phoneme_mask)
    l_pitch = pitch_loss(pitch_pred, pitch_gt, pitch_mask)
    l_energy = energy_loss(energy_pred, energy_gt, mel_mask)
    total = (weights.mel * l_mel + weights.dur * l_dur + weights.pitch * l_pitch
             + weights.energy * l_energy)
    return total, {"total_loss": total, "mel_loss": l_mel, "dur_loss": l_dur,
                   "pitch_loss": l_pitch, "energy_loss": l_energy}
