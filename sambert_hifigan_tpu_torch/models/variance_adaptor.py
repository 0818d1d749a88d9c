"""Variance adaptor: duration/pitch/energy predictors and the static-shape
length regulator.

Training (ground truth given as keywords): the durations `dur_gt` expand
the phonemes, and `pitch_gt` / `energy_gt` choose the embedded bins.
Inference: predicted durations are max(round(exp(log_dur) * scale), 1),
zeroed on padded phonemes, and pitch/energy embed their own predictions
under the prosody controls (ignored where ground truth is given).  The
duration predictor takes no mask, as the reference's does.

Quantisation keeps the reference's boundary semantics bit for bit: clamp,
normalise, scale by (n_bins - 1), truncate, clamp; pitch has NO epsilon in
the denominator while energy has +1e-8.  `torch.round` rounds half to
even, as `jnp.round` does.  Compute runs in henc's dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..config import VarianceAdaptorConfig
from ..ops.length_regulator import gather_frames, regulate_indices
from .layers import Conv1d, LayerNorm, Linear, conv1d, dropout, layer_generator, linear


class VariancePredictor(nn.Module):
    """n_layers x [Conv1d(k, same pad) -> ReLU -> LayerNorm -> Dropout
    -> +residual], then Linear -> one scalar per position."""

    def __init__(self, d_model: int, n_layers: int = 2, kernel_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList(
            Conv1d(d_model, d_model, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in range(n_layers)
        )
        self.norms = nn.ModuleList(LayerNorm(d_model) for _ in range(n_layers))
        self.linear = Linear(d_model, 1)

    def forward(self, h: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, Tph, d] -> [B, Tph]"""
        x = h
        for conv, norm in zip(self.convs, self.norms):
            y = torch.relu(conv1d(conv, x.transpose(1, 2), x.dtype).transpose(1, 2))
            x = dropout(norm(y), self.dropout, gen) + x
        return linear(self.linear, x).squeeze(-1)


def quantize_pitch(
    pitch: torch.Tensor, n_bins: int, pitch_min: float, pitch_max: float
) -> torch.Tensor:
    p = torch.clamp(pitch, pitch_min, pitch_max)
    p = (p - pitch_min) / (pitch_max - pitch_min)
    return torch.clamp((p * (n_bins - 1)).to(torch.int32), 0, n_bins - 1)


def quantize_energy(
    energy: torch.Tensor, n_bins: int, energy_min: float, energy_max: float
) -> torch.Tensor:
    e = torch.clamp(energy, energy_min, energy_max)
    e = (e - energy_min) / (energy_max - energy_min + 1e-8)
    return torch.clamp((e * (n_bins - 1)).to(torch.int32), 0, n_bins - 1)


class VarianceAdaptorOutput(NamedTuple):
    hvar: torch.Tensor  # [B, max_frames, d]
    frame_mask: torch.Tensor  # [B, max_frames] bool
    total_frames: torch.Tensor  # [B] int32
    predictions: Dict[str, torch.Tensor]


class VarianceAdaptor(nn.Module):
    def __init__(self, d_model: int = 256, config: VarianceAdaptorConfig = VarianceAdaptorConfig()):
        super().__init__()
        self.config = config
        c = config
        self.duration_predictor, self.pitch_predictor, self.energy_predictor = (
            VariancePredictor(d_model, c.predictor_layers, c.predictor_kernel_size,
                              c.predictor_dropout)
            for _ in range(3)
        )
        self.pitch_emb = nn.Embedding(c.pitch_bins, d_model)
        self.energy_emb = nn.Embedding(c.energy_bins, d_model)

    def forward(
        self,
        henc: torch.Tensor,  # [B, Tph, d]
        max_frames: int,
        phoneme_mask: Optional[torch.Tensor] = None,  # [B, Tph] True = valid
        duration_scale: float = 1.0,
        pitch_shift: float = 0.0,
        energy_scale: float = 1.0,
        *,
        dur_gt: Optional[torch.Tensor] = None,  # [B, Tph] int
        pitch_gt: Optional[torch.Tensor] = None,  # [B, max_frames]
        energy_gt: Optional[torch.Tensor] = None,  # [B, max_frames]
        rng: Optional[torch.Generator] = None,  # host generator: dropout on
    ) -> VarianceAdaptorOutput:
        c = self.config
        dev = henc.device
        log_dur_pred = self.duration_predictor(henc, layer_generator(rng, dev))
        if dur_gt is not None:
            dur = dur_gt.to(torch.int32)
        else:
            dur = torch.round(torch.exp(log_dur_pred) * duration_scale).to(torch.int32)
            dur = torch.clamp(dur, min=1)
            if phoneme_mask is not None:
                dur = dur * phoneme_mask.to(torch.int32)

        idx, frame_mask, total = regulate_indices(dur, max_frames)
        hlr = gather_frames(henc, idx, frame_mask)

        pitch_tok = self.pitch_predictor(henc, layer_generator(rng, dev))
        pitch_frm = gather_frames(pitch_tok, idx, frame_mask)
        pitch = pitch_gt if pitch_gt is not None else pitch_frm + pitch_shift
        pitch_bins = quantize_pitch(pitch, c.pitch_bins, c.pitch_min, c.pitch_max)
        energy_tok = self.energy_predictor(henc, layer_generator(rng, dev))
        energy_frm = gather_frames(energy_tok, idx, frame_mask)
        energy = energy_gt if energy_gt is not None else energy_frm * energy_scale
        energy_bins = quantize_energy(energy, c.energy_bins, c.energy_min, c.energy_max)
        hvar = (hlr + self.pitch_emb(pitch_bins).to(hlr.dtype)
                + self.energy_emb(energy_bins).to(hlr.dtype))
        hvar = hvar * frame_mask[:, :, None].to(hvar.dtype)
        predictions = {
            "log_dur_pred": log_dur_pred,
            "dur": dur,
            "pitch_tok": pitch_tok,
            "pitch_frm": pitch_frm,
            "energy_tok": energy_tok,
            "energy_frm": energy_frm,
        }
        return VarianceAdaptorOutput(hvar, frame_mask, total, predictions)
