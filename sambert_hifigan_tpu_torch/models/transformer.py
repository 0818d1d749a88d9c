"""Transformer blocks with torch nn.Transformer* semantics: post-norm, ReLU,
LayerNorm eps 1e-5, masks as `where` fills with NEG_INF, scores and softmax
in float32.

Masks: `attn_mask` is boolean [T, S] and `key_padding_mask` boolean [B, S],
True = blocked; both given, they are ORed.

Every matrix product runs in the dtype of its input, with the weights cast
at use (bf16 under mixed precision, models/acoustic_model.py); LayerNorm
and softmax compute in float32.  Dropout (on the attention weights, the
FFN's inner activation and each residual branch) draws from the layer's
generator `gen` (models/layers.py) and is off without one.

The decoder layer's `forward` is teacher forcing: causal self-attention,
cross-attention to the memory, FFN.  One-shot decoding runs over packed
weights instead (models/ar_decoder.py, ops/ar_decode.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .layers import LayerNorm, Linear, dropout, linear, xavier_uniform_

NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    """nn.MultiheadAttention-compatible MHA with separate q/k/v/o
    projections (torch Linear layout [out, in]).

    Init: q/k/v xavier with zero biases; the output projection is xavier
    in the decoder (`xavier_all`) and torch-default elsewhere, zero bias."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0,
                 xavier_all: bool = False):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.dropout = dropout
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
        attn_mask: Optional[torch.Tensor] = None,  # [T, S] True = blocked
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = ignore
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        q = self._split(linear(self.wq, q_input))
        k = self._split(linear(self.wk, kv_input))
        v = self._split(linear(self.wv, kv_input))
        dh = q.shape[-1]
        scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(dh)
        mask = None if attn_mask is None else attn_mask[None, None, :, :]
        if key_padding_mask is not None:
            kpm = key_padding_mask[:, None, None, :]
            mask = kpm if mask is None else mask | kpm
        if mask is not None:
            scores = scores.masked_fill(mask, NEG_INF)
        w = dropout(torch.softmax(scores, dim=-1), self.dropout, gen)
        out = torch.einsum("bhts,bshd->bthd", w.to(v.dtype), v)
        b, t = out.shape[0], out.shape[1]
        return linear(self.wo, out.reshape(b, t, self.d_model))


class FeedForward(nn.Module):
    """linear2(dropout(relu(linear1(x))))."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0,
                 xavier_all: bool = False):
        super().__init__()
        self.dropout = dropout
        self.xavier_all = xavier_all
        self.linear1 = Linear(d_model, d_ff)
        self.linear2 = Linear(d_ff, d_model)

    def init_weights_(self, gen: torch.Generator) -> None:
        if self.xavier_all:
            xavier_uniform_(self.linear1.weight, gen)
            xavier_uniform_(self.linear2.weight, gen)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(torch.relu(linear(self.linear1, x)), self.dropout, gen)
        return linear(self.linear2, h)


class TransformerEncoderLayer(nn.Module):
    """x = norm1(x + dropout(SA(x))); x = norm2(x + dropout(FFN(x)))."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm1 = LayerNorm(d_model)
        self.ffn = FeedForward(d_model, d_ff, dropout)
        self.norm2 = LayerNorm(d_model)

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        sa = self.self_attn(x, x, None, key_padding_mask, gen)
        x = self.norm1(x + dropout(sa, self.dropout, gen))
        ff = self.ffn(x, gen)
        return self.norm2(x + dropout(ff, self.dropout, gen))


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attn -> norm1, cross-attn -> norm2,
    FFN -> norm3, every matrix xavier."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout, xavier_all=True)
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dropout, xavier_all=True)
        self.ffn = FeedForward(d_model, d_ff, dropout, xavier_all=True)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(
        self,
        tgt: torch.Tensor,  # [B, T, d]
        memory: torch.Tensor,  # [B, S, d]
        tgt_mask: Optional[torch.Tensor] = None,  # [T, T] True = blocked
        memory_key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = pad
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        sa = self.self_attn(tgt, tgt, tgt_mask, None, gen)
        x = self.norm1(tgt + dropout(sa, self.dropout, gen))
        ca = self.cross_attn(x, memory, None, memory_key_padding_mask, gen)
        x = self.norm2(x + dropout(ca, self.dropout, gen))
        ff = self.ffn(x, gen)
        return self.norm3(x + dropout(ff, self.dropout, gen))


def causal_mask(size: int, device=None) -> torch.Tensor:
    """Boolean [size, size], True above the diagonal (= blocked)."""
    return torch.ones(size, size, dtype=torch.bool, device=device).triu(1)


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
