"""BERT encoder: n post-norm transformer layers (ReLU) and a final LayerNorm."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import EncoderConfig
from .layers import LayerNorm
from .transformer import TransformerEncoderLayer


class BERTEncoder(nn.Module):
    def __init__(self, d_model: int = 256, config: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.d_model = d_model
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, config.n_heads, config.d_ff)
            for _ in range(config.n_layers)
        )
        self.final_norm = LayerNorm(d_model)

    def forward(
        self,
        h0: torch.Tensor,  # [B, Tph, d]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Tph] True = pad
    ) -> torch.Tensor:
        x = h0
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return self.final_norm(x)
