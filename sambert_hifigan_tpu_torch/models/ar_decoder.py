"""PNCA AR decoder: prenet Linear(n_mels->d) -> ReLU -> Linear(d->d),
sinusoidal positional encoding, L post-norm decoder layers cross-attending
to Hvar, mel projection; every matrix xavier.

Inference decodes from a zero start frame over packed weights
(`pack_decoder`, once per pipeline) and cross-attention K/V projected once
per utterance (`precompute_memory_packed`).  `ar_decode` routes every CUDA
tensor to the K1 kernel (ops/ar_decode.py) and every CPU tensor to its plain
version; a shape the kernel does not take raises.  Teacher forcing belongs to
the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import DecoderConfig
from ..ops import ar_decode as k1
from ..ops.ar_decode import NEG_INF, DecodeWeights
from .layers import Linear, xavier_uniform_
from .transformer import TransformerDecoderLayer, sinusoidal_positional_encoding


class PNCAARDecoder(nn.Module):
    def __init__(self, d_model: int = 256, n_mels: int = 80, config: DecoderConfig = DecoderConfig()):
        super().__init__()
        self.d_model = d_model
        self.n_mels = n_mels
        self.config = config
        self.prenet1 = Linear(n_mels, d_model)
        self.prenet2 = Linear(d_model, d_model)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, config.n_heads, config.d_ff)
            for _ in range(config.n_layers)
        )
        self.mel_proj = Linear(d_model, n_mels)
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(config.max_len, d_model), persistent=False
        )

    def init_weights_(self, gen: torch.Generator) -> None:
        for lin in (self.prenet1, self.prenet2, self.mel_proj):
            xavier_uniform_(lin.weight, gen)
        for layer in self.layers:
            layer.self_attn.init_weights_(gen)
            layer.cross_attn.init_weights_(gen)
            layer.ffn.init_weights_(gen)


@torch.no_grad()
def pack_decoder(dec: PNCAARDecoder, dtype: torch.dtype) -> DecodeWeights:
    """Matrices to [in, out] in `dtype`, stacked over layers, Q/K/V fused;
    biases, LayerNorm and PE in f32; in bf16 also the kernel's weight stream
    for its cluster size."""

    def mat(lin):
        return lin.weight.detach().t()

    def stack(fn, dt):
        return torch.stack([fn(layer) for layer in dec.layers]).to(dt).contiguous()

    def m(t):
        return t.to(dtype).contiguous()

    def v(t):
        return t.detach().float().contiguous()

    f32 = torch.float32
    w = DecodeWeights(
        prenet_w1=m(mat(dec.prenet1)), prenet_b1=v(dec.prenet1.bias),
        prenet_w2=m(mat(dec.prenet2)), prenet_b2=v(dec.prenet2.bias),
        wqkv=stack(lambda q: torch.cat([mat(q.self_attn.wq), mat(q.self_attn.wk),
                                         mat(q.self_attn.wv)], dim=1), dtype),
        bqkv=stack(lambda q: torch.cat([q.self_attn.wq.bias, q.self_attn.wk.bias,
                                         q.self_attn.wv.bias]), f32),
        wo=stack(lambda q: mat(q.self_attn.wo), dtype),
        bo=stack(lambda q: q.self_attn.wo.bias, f32),
        wcq=stack(lambda q: mat(q.cross_attn.wq), dtype),
        bcq=stack(lambda q: q.cross_attn.wq.bias, f32),
        wco=stack(lambda q: mat(q.cross_attn.wo), dtype),
        bco=stack(lambda q: q.cross_attn.wo.bias, f32),
        w1=stack(lambda q: mat(q.ffn.linear1), dtype),
        b1=stack(lambda q: q.ffn.linear1.bias, f32),
        w2=stack(lambda q: mat(q.ffn.linear2), dtype),
        b2=stack(lambda q: q.ffn.linear2.bias, f32),
        ln=stack(lambda q: torch.stack([
            torch.stack([n.weight, n.bias]) for n in (q.norm1, q.norm2, q.norm3)
        ]), f32),
        mel_w=m(mat(dec.mel_proj)), mel_b=v(dec.mel_proj.bias),
        pe=v(dec.pe),
        n_heads=dec.config.n_heads,
    )
    cluster = k1.cluster_size(dec.d_model, dec.config.d_ff, dec.n_mels)
    if dtype != torch.bfloat16 or not cluster:  # the kernel's stream is bf16
        return w
    return w._replace(stream=k1.pack_stream(w, cluster))


@torch.no_grad()
def precompute_memory_packed(dec: PNCAARDecoder, hvar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of every layer, f32 [L, B, S, d] each."""
    ks = [layer.cross_attn.wk(hvar) for layer in dec.layers]
    vs = [layer.cross_attn.wv(hvar) for layer in dec.layers]
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def ar_decode(
    dec: PNCAARDecoder,
    hvar: torch.Tensor,  # [B, S, d]
    max_len: int,
    memory_key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = pad
    *,
    weights: DecodeWeights,  # pack_decoder(dec, ...)
) -> torch.Tensor:
    """Autoregressive mel generation -> [B, max_len, n_mels] f32."""
    mem_k, mem_v = precompute_memory_packed(dec, hvar.float())
    dt = weights.wqkv.dtype
    b, s = hvar.shape[:2]
    if memory_key_padding_mask is None:
        mem_bias = torch.zeros(b, s, device=hvar.device)
    else:
        mem_bias = torch.where(memory_key_padding_mask, NEG_INF, 0.0).float()
    return k1.ar_decode(
        weights, mem_k.to(dt).contiguous(), mem_v.to(dt).contiguous(),
        mem_bias.contiguous(), max_len,
    )
