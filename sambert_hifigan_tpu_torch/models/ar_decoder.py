"""PNCA AR decoder: prenet Linear(n_mels->d) -> ReLU -> Linear(d->d),
sinusoidal positional encoding, L post-norm decoder layers cross-attending
to Hvar, mel projection; every matrix xavier.

Inference decodes from a zero start frame over packed weights
(`pack_decoder`, once per pipeline) and cross-attention K/V projected once
per utterance, in hvar's dtype (`precompute_memory_packed`,
`decode_memory`).  `ar_decode`
decodes every frame in one call; a stream calls `ar_decode_chunk` from
`init_packed_carry`, chunk after chunk, with the same bits.  Both route
every CUDA tensor to the K1 kernel (ops/ar_decode.py) and every CPU tensor
to its plain version; a shape the kernel does not take raises.  Both take
each row's length as a device tensor (`lengths`): the decode stops at the
longest row and does no work for a row past its own, whose frames are 0.

Training is teacher forcing (`PNCAARDecoder.forward`): the ground-truth mel
shifted right by a zero frame goes through the prenet (with dropout), the
positional encoding (with dropout) and the L layers under a causal mask,
so frame t is predicted from frames < t as the decode predicts it from its
own output.  With `config.remat` each layer is recomputed on the backward
pass (models/layers.py `run_layer`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import DecoderConfig
from ..ops import ar_decode as k1
from ..ops.ar_decode import NEG_INF, DecodeCarry, DecodeWeights
from .layers import Linear, dropout, layer_generator, linear, run_layer, xavier_uniform_
from .transformer import TransformerDecoderLayer, causal_mask, sinusoidal_positional_encoding


class PNCAARDecoder(nn.Module):
    def __init__(self, d_model: int = 256, n_mels: int = 80, config: DecoderConfig = DecoderConfig()):
        super().__init__()
        self.d_model = d_model
        self.n_mels = n_mels
        self.config = config
        self.prenet1 = Linear(n_mels, d_model)
        self.prenet2 = Linear(d_model, d_model)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, config.n_heads, config.d_ff, config.dropout)
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

    def forward(
        self,
        hvar: torch.Tensor,  # [B, T, d], the compute dtype
        mel_gt: torch.Tensor,  # [B, T, n_mels]
        memory_key_padding_mask: Optional[torch.Tensor] = None,  # [B, T] True = pad
        rng: Optional[torch.Generator] = None,  # host generator: dropout on
    ) -> torch.Tensor:
        """Teacher forcing: predict frame t from frames < t -> [B, T, n_mels]
        in hvar's dtype."""
        b, t, _ = hvar.shape
        gen = layer_generator(rng, hvar.device)
        shifted = torch.cat([mel_gt.new_zeros(b, 1, self.n_mels), mel_gt[:, :-1]], dim=1)
        x = torch.relu(linear(self.prenet1, shifted.to(hvar.dtype)))
        x = linear(self.prenet2, dropout(x, self.config.dropout, gen))
        x = dropout(x + self.pe[None, :t].to(x.dtype), self.config.dropout, gen)
        tgt_mask = causal_mask(t, hvar.device)
        for layer in self.layers:
            x = run_layer(layer, self.config.remat, rng, x, hvar, tgt_mask,
                          memory_key_padding_mask)
        return linear(self.mel_proj, x)


@torch.no_grad()
def pack_decoder(dec: PNCAARDecoder, dtype: torch.dtype,
                 compute_dtype: torch.dtype = torch.float32) -> DecodeWeights:
    """Matrices to [in, out] in `dtype`, stacked over layers, Q/K/V fused;
    biases, LayerNorm and PE in f32; in bf16 also the kernel's weight stream
    for its cluster size.  A bf16 `compute_dtype` rounds the biases to bf16
    first (held in f32), as the JAX package's bf16 decoder casts every bias
    to its dtype before its kernel reads them in f32; LayerNorm and PE stay
    exact."""

    def mat(lin):
        return lin.weight.detach().t()

    def stack(fn, dt):
        return torch.stack([fn(layer) for layer in dec.layers]).to(dt).contiguous()

    def m(t):
        return t.to(dtype).contiguous()

    def v(t):
        return t.detach().float().contiguous()

    def bias(t):
        return v(t.detach().to(compute_dtype))

    f32 = torch.float32
    w = DecodeWeights(
        prenet_w1=m(mat(dec.prenet1)), prenet_b1=bias(dec.prenet1.bias),
        prenet_w2=m(mat(dec.prenet2)), prenet_b2=bias(dec.prenet2.bias),
        wqkv=stack(lambda q: torch.cat([mat(q.self_attn.wq), mat(q.self_attn.wk),
                                         mat(q.self_attn.wv)], dim=1), dtype),
        bqkv=bias(stack(lambda q: torch.cat([q.self_attn.wq.bias, q.self_attn.wk.bias,
                                              q.self_attn.wv.bias]), f32)),
        wo=stack(lambda q: mat(q.self_attn.wo), dtype),
        bo=bias(stack(lambda q: q.self_attn.wo.bias, f32)),
        wcq=stack(lambda q: mat(q.cross_attn.wq), dtype),
        bcq=bias(stack(lambda q: q.cross_attn.wq.bias, f32)),
        wco=stack(lambda q: mat(q.cross_attn.wo), dtype),
        bco=bias(stack(lambda q: q.cross_attn.wo.bias, f32)),
        w1=stack(lambda q: mat(q.ffn.linear1), dtype),
        b1=bias(stack(lambda q: q.ffn.linear1.bias, f32)),
        w2=stack(lambda q: mat(q.ffn.linear2), dtype),
        b2=bias(stack(lambda q: q.ffn.linear2.bias, f32)),
        ln=stack(lambda q: torch.stack([
            torch.stack([n.weight, n.bias]) for n in (q.norm1, q.norm2, q.norm3)
        ]), f32),
        mel_w=m(mat(dec.mel_proj)), mel_b=bias(dec.mel_proj.bias),
        pe=v(dec.pe),
        n_heads=dec.config.n_heads,
    )
    cluster = k1.cluster_size(dec.d_model, dec.config.d_ff, dec.n_mels)
    if dtype != torch.bfloat16 or not cluster:  # the kernel's stream is bf16
        return w
    return w._replace(stream=k1.pack_stream(w, cluster))


@torch.no_grad()
def precompute_memory_packed(dec: PNCAARDecoder, hvar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of every layer, [L, B, S, d] each in hvar's
    dtype (the weights cast at use, as the JAX package projects them)."""
    ks = [linear(layer.cross_attn.wk, hvar) for layer in dec.layers]
    vs = [linear(layer.cross_attn.wv, hvar) for layer in dec.layers]
    return torch.stack(ks), torch.stack(vs)


class DecodeMemory(NamedTuple):
    """The decode's memory as K1 takes it: every layer's cross-attention K/V
    [L, B, S, d] in the weights' dtype and the mask bias [B, S] f32 (0 on
    frames, -1e9 on padding)."""

    mem_k: torch.Tensor
    mem_v: torch.Tensor
    mem_bias: torch.Tensor


@torch.no_grad()
def decode_memory(
    dec: PNCAARDecoder,
    hvar: torch.Tensor,  # [B, S, d]
    memory_key_padding_mask: Optional[torch.Tensor],  # [B, S] True = pad
    weights: DecodeWeights,
) -> DecodeMemory:
    """Project the memory once per utterance, for every chunk of its decode:
    in hvar's dtype (bf16 K/V from a bf16 hvar), then in the weights'."""
    mem_k, mem_v = precompute_memory_packed(dec, hvar)
    dt = weights.wqkv.dtype
    b, s = hvar.shape[:2]
    if memory_key_padding_mask is None:
        mem_bias = torch.zeros(b, s, device=hvar.device)
    else:
        mem_bias = torch.where(memory_key_padding_mask, NEG_INF, 0.0).float()
    return DecodeMemory(mem_k.to(dt).contiguous(), mem_v.to(dt).contiguous(),
                        mem_bias.contiguous())


def init_packed_carry(weights: DecodeWeights, batch: int, max_len: int) -> DecodeCarry:
    """(prev_mel, k_cache, v_cache) before step 0, caches of capacity
    `max_len` (the frame bucket)."""
    return k1.init_carry(weights, batch, max_len)


@torch.no_grad()
def ar_decode_chunk(
    weights: DecodeWeights, memory: DecodeMemory, carry: DecodeCarry, pos0: int, chunk: int,
    lengths: Optional[torch.Tensor] = None,  # [B] int32: the frames each row keeps
) -> Tuple[DecodeCarry, torch.Tensor]:
    """Advance the decode by `chunk` frames from `carry` at position `pos0`
    -> (carry', mel [B, chunk, n_mels] f32).  One K1 launch on the card."""
    return k1.ar_decode_chunk(weights, *memory, carry, pos0, chunk, lengths)


@torch.no_grad()
def ar_decode(
    dec: PNCAARDecoder,
    hvar: torch.Tensor,  # [B, S, d]
    max_len: int,
    memory_key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = pad
    *,
    weights: DecodeWeights,  # pack_decoder(dec, ...)
    lengths: Optional[torch.Tensor] = None,  # [B] int32: the frames each row keeps
) -> torch.Tensor:
    """Autoregressive mel generation -> [B, max_len, n_mels] in hvar's
    dtype: the kernel's f32 mel, cast as the JAX decode casts its output."""
    return k1.ar_decode(weights, *decode_memory(dec, hvar, memory_key_padding_mask, weights),
                        max_len, lengths).to(hvar.dtype)
