"""Phoneme embedding: H0 = Emb_ph(ph) + Emb_tone(tone) + Emb_boundary(boundary),
each table N(0, 1)-initialised like torch nn.Embedding."""

from __future__ import annotations

import torch
from torch import nn


class PhonemeEmbedding(nn.Module):
    def __init__(
        self, vocab_size: int = 300, tone_size: int = 10, boundary_size: int = 5,
        d_model: int = 256,
    ):
        super().__init__()
        self.ph_emb = nn.Embedding(vocab_size, d_model)
        self.tone_emb = nn.Embedding(tone_size, d_model)
        self.boundary_emb = nn.Embedding(boundary_size, d_model)

    def forward(
        self, ph_ids: torch.Tensor, tone_ids: torch.Tensor, boundary_ids: torch.Tensor
    ) -> torch.Tensor:
        return (
            self.ph_emb(ph_ids) + self.tone_emb(tone_ids)
            + self.boundary_emb(boundary_ids)
        )
