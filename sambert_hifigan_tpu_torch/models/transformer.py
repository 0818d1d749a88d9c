"""Transformer blocks with torch nn.Transformer* semantics: post-norm, ReLU,
LayerNorm eps 1e-5, masks as `where` fills with NEG_INF, scores and softmax
in float32.

Masks: `key_padding_mask` is boolean [B, S] (True = ignore).

The decoder layer holds parameters only: one-shot decoding runs over packed
weights (models/ar_decoder.py, ops/ar_decode.py), and teacher forcing belongs
to the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .layers import LayerNorm, Linear, xavier_uniform_

NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    """nn.MultiheadAttention-compatible MHA with separate q/k/v/o
    projections (torch Linear layout [out, in]).

    Init: q/k/v xavier with zero biases; the output projection is xavier
    in the decoder (`xavier_all`) and torch-default elsewhere, zero bias."""

    def __init__(self, d_model: int, n_heads: int, xavier_all: bool = False):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.xavier_all = xavier_all
        self.wq = Linear(d_model, d_model)
        self.wk = Linear(d_model, d_model)
        self.wv = Linear(d_model, d_model)
        self.wo = Linear(d_model, d_model)

    def init_weights_(self, gen: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv):
            xavier_uniform_(lin.weight, gen)
        if self.xavier_all:
            xavier_uniform_(self.wo.weight, gen)
        for lin in (self.wq, self.wk, self.wv, self.wo):
            nn.init.zeros_(lin.bias)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        return x.reshape(b, t, self.n_heads, d // self.n_heads)

    def forward(
        self,
        q_input: torch.Tensor,  # [B, T, d]
        kv_input: torch.Tensor,  # [B, S, d]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = ignore
    ) -> torch.Tensor:
        q = self._split(self.wq(q_input))
        k = self._split(self.wk(kv_input))
        v = self._split(self.wv(kv_input))
        dh = q.shape[-1]
        scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(dh)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", w.to(v.dtype), v)
        b, t = out.shape[0], out.shape[1]
        return self.wo(out.reshape(b, t, self.d_model))


class FeedForward(nn.Module):
    """linear2(relu(linear1(x)))."""

    def __init__(self, d_model: int, d_ff: int, xavier_all: bool = False):
        super().__init__()
        self.xavier_all = xavier_all
        self.linear1 = Linear(d_model, d_ff)
        self.linear2 = Linear(d_ff, d_model)

    def init_weights_(self, gen: torch.Generator) -> None:
        if self.xavier_all:
            xavier_uniform_(self.linear1.weight, gen)
            xavier_uniform_(self.linear2.weight, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.relu(self.linear1(x)))


class TransformerEncoderLayer(nn.Module):
    """x = norm1(x + SA(x)); x = norm2(x + FFN(x))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm1 = LayerNorm(d_model)
        self.ffn = FeedForward(d_model, d_ff)
        self.norm2 = LayerNorm(d_model)

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, key_padding_mask))
        return self.norm2(x + self.ffn(x))


class TransformerDecoderLayer(nn.Module):
    """Parameters of one post-norm decoder layer: self-attn -> norm1,
    cross-attn -> norm2, FFN -> norm3, every matrix xavier."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, xavier_all=True)
        self.cross_attn = MultiHeadAttention(d_model, n_heads, xavier_all=True)
        self.ffn = FeedForward(d_model, d_ff, xavier_all=True)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """[max_len, d_model] float32 sin/cos table (numpy-built, as the JAX
    package builds it, so both sides hold the same values)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)
