"""BERT encoder: n post-norm transformer layers (ReLU) and a final LayerNorm.

With `config.remat`, each layer of a forward that records gradients runs
under `torch.utils.checkpoint`: its activations are recomputed on the
backward pass instead of being kept (long batches), with the same dropout
masks (models/layers.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import EncoderConfig
from .layers import LayerNorm, run_layer
from .transformer import TransformerEncoderLayer


class BERTEncoder(nn.Module):
    def __init__(self, d_model: int = 256, config: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.d_model = d_model
        self.remat = config.remat
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, config.n_heads, config.d_ff, config.dropout)
            for _ in range(config.n_layers)
        )
        self.final_norm = LayerNorm(d_model)

    def forward(
        self,
        h0: torch.Tensor,  # [B, Tph, d]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Tph] True = pad
        rng: Optional[torch.Generator] = None,  # host generator: dropout on
    ) -> torch.Tensor:
        x = h0
        for layer in self.layers:
            x = run_layer(layer, self.remat, rng, x, key_padding_mask)
        return self.final_norm(x)
