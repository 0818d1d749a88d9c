"""K1: the whole autoregressive mel decode, T steps x L layers, in one launch.

`ar_decode` is the wrapper.  A CUDA tensor goes to the hand-written kernel in
`csrc/ar_decode.cu` (or the call raises); a CPU tensor goes to
`ar_decode_plain`, the same function in plain PyTorch.  There is no switch
and no fallback.

Numerics (the contract of the JAX package's Pallas kernel, which this
replaces): matmul inputs and weights bf16 with f32 accumulation, biases,
LayerNorm and softmax in f32, q scaled by 1/sqrt(dh) before its bf16 cast,
each q*k product rounded to bf16 before the f32 sum over the head (the
Pallas kernel's `(keys * q).astype(bf16)` ahead of its head-group matmul),
softmax probabilities cast to bf16 before the value product, bf16 K/V caches
and memory K/V, and a zero start frame.  The residual stream stays f32.
Given float32 weights the plain version rounds nowhere and is the packed
decode step of the JAX package in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import kernels

launches = 0  # kernel launches through `ar_decode` (never the plain version)

NEG_INF = -1e9
_THREADS = 512  # threads per block, as in csrc/ar_decode.cu


class DecodeWeights(NamedTuple):
    """Decoder weights packed once per pipeline: matrices [in, out] in the
    kernel dtype (bf16 on the card), per-layer tensors stacked on a leading L
    axis, self-attention Q/K/V fused into one [L, d, 3d] matrix; biases,
    LayerNorm affine ([L, 3, 2, d]: norm, scale/bias) and the positional
    table in f32."""

    prenet_w1: torch.Tensor  # [n_mels, d]
    prenet_b1: torch.Tensor
    prenet_w2: torch.Tensor  # [d, d]
    prenet_b2: torch.Tensor
    wqkv: torch.Tensor  # [L, d, 3d]
    bqkv: torch.Tensor  # [L, 3d]
    wo: torch.Tensor  # [L, d, d]
    bo: torch.Tensor
    wcq: torch.Tensor
    bcq: torch.Tensor
    wco: torch.Tensor
    bco: torch.Tensor
    w1: torch.Tensor  # [L, d, ff]
    b1: torch.Tensor  # [L, ff]
    w2: torch.Tensor  # [L, ff, d]
    b2: torch.Tensor
    ln: torch.Tensor  # [L, 3, 2, d]
    mel_w: torch.Tensor  # [d, n_mels]
    mel_b: torch.Tensor
    pe: torch.Tensor  # [max_len, d]
    n_heads: int

    @property
    def matrices(self):
        return (self.prenet_w1, self.prenet_w2, self.wqkv, self.wo, self.wcq,
                self.wco, self.w1, self.w2, self.mel_w)

    @property
    def vectors(self):
        return (self.prenet_b1, self.prenet_b2, self.bqkv, self.bo, self.bcq,
                self.bco, self.b1, self.b2, self.ln, self.mel_b, self.pe)


def ar_decode(
    w: DecodeWeights,
    mem_k: torch.Tensor,  # [L, B, S, d], the kernel dtype
    mem_v: torch.Tensor,
    mem_bias: torch.Tensor,  # [B, S] f32: 0 on frames, -1e9 on padding
    max_len: int,
) -> torch.Tensor:
    """Decode `max_len` frames from a zero start frame -> mel [B, max_len,
    n_mels] f32."""
    if mem_k.device.type == "cpu":
        return ar_decode_plain(w, mem_k, mem_v, mem_bias, max_len)
    if mem_k.device.type != "cuda":
        raise ValueError(f"ar_decode: unsupported device {mem_k.device}")
    return _ar_decode_cuda(w, mem_k, mem_v, mem_bias, max_len)


def _rounder(dtype: torch.dtype):
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    if dtype == torch.float32:
        return lambda t: t
    raise ValueError(f"unsupported decode weight dtype {dtype}")


def _layer_norm(x: torch.Tensor, scale_bias: torch.Tensor, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale_bias[0] + scale_bias[1]


def _scores(q: torch.Tensor, keys: torch.Tensor, rnd) -> torch.Tensor:
    """q [B, H, dh] . keys [B, S, H, dh] -> [B, H, S], each product rounded
    (bf16 in the kernel's numerics) before the f32 sum over dh."""
    return rnd(q[:, None] * keys).sum(-1).transpose(1, 2)


def ar_decode_plain(w, mem_k, mem_v, mem_bias, max_len: int) -> torch.Tensor:
    """Plain PyTorch version of K1: the packed per-frame step in a Python
    loop, rounding where the kernel rounds when the weights are bf16."""
    rnd = _rounder(w.wqkv.dtype)
    L, b, s, d = mem_k.shape
    h = w.n_heads
    dh = d // h
    n_mels = w.mel_w.shape[1]
    sq = math.sqrt(dh)
    f = lambda t: t.float()  # noqa: E731
    mk = mem_k.float().reshape(L, b, s, h, dh)
    mv = mem_v.float().reshape(L, b, s, h, dh)
    ck = torch.zeros(L, b, max_len, h, dh, device=mem_k.device)
    cv = torch.zeros_like(ck)
    bias = mem_bias.float()[:, None, :]
    prev = torch.zeros(b, n_mels, device=mem_k.device)
    out = []
    for t in range(max_len):
        x = torch.relu(rnd(prev) @ f(w.prenet_w1) + w.prenet_b1)
        x = rnd(x) @ f(w.prenet_w2) + w.prenet_b2 + w.pe[t]
        for l in range(L):
            qkv = rnd(x) @ f(w.wqkv[l]) + w.bqkv[l]
            q, k_t, v_t = qkv.split(d, dim=-1)
            ck[l, :, t] = rnd(k_t).reshape(b, h, dh)
            cv[l, :, t] = rnd(v_t).reshape(b, h, dh)
            qs = rnd(q / sq).reshape(b, h, dh)
            sc = _scores(qs, ck[l, :, : t + 1], rnd)
            p = rnd(torch.softmax(sc, dim=-1))
            sa = torch.einsum("bhs,bshd->bhd", p, cv[l, :, : t + 1]).reshape(b, d)
            x = _layer_norm(x + rnd(sa) @ f(w.wo[l]) + w.bo[l], w.ln[l, 0])
            cq = rnd((rnd(x) @ f(w.wcq[l]) + w.bcq[l]) / sq).reshape(b, h, dh)
            cs = _scores(cq, mk[l], rnd) + bias
            cp = rnd(torch.softmax(cs, dim=-1))
            ca = torch.einsum("bhs,bshd->bhd", cp, mv[l]).reshape(b, d)
            x = _layer_norm(x + rnd(ca) @ f(w.wco[l]) + w.bco[l], w.ln[l, 1])
            hid = torch.relu(rnd(x) @ f(w.w1[l]) + w.b1[l])
            x = _layer_norm(x + rnd(hid) @ f(w.w2[l]) + w.b2[l], w.ln[l, 2])
        prev = rnd(x) @ f(w.mel_w) + w.mel_b
        out.append(prev)
    return torch.stack(out, dim=1)


def smem_bytes(max_len: int, mem_len: int, d: int, n_heads: int, d_ff: int,
               n_mels: int) -> int:
    """Dynamic shared memory of one K1 block (mirrors csrc/ar_decode.cu)."""
    floats = (
        d  # x
        + max(3 * d, d_ff, d)  # tmp
        + max(d_ff, d, n_mels)  # vin
        + 2 * d  # qs, att
        + n_mels  # prev
        + _THREADS // 32  # lnred
        + 8 * _THREADS  # split-K partials
        + n_heads * max(max_len, mem_len)  # scores
    )
    return 4 * floats


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ar_decode kernel: {msg}")


def _ar_decode_cuda(w, mem_k, mem_v, mem_bias, max_len: int) -> torch.Tensor:
    global launches
    L, b, s, d = mem_k.shape
    h = w.n_heads
    d_ff = w.w1.shape[-1]
    n_mels = w.mel_w.shape[1]
    dev = mem_k.device
    bf16 = torch.bfloat16
    for t in w.matrices + (mem_k, mem_v):
        _check(t.device == dev and t.dtype == bf16 and t.is_contiguous(),
               f"weights and memory K/V must be contiguous bf16 on {dev}")
    for t in w.vectors + (mem_bias,):
        _check(t.device == dev and t.dtype == torch.float32 and t.is_contiguous(),
               f"biases, LayerNorm, PE and mask bias must be contiguous f32 on {dev}")
    _check(mem_v.shape == mem_k.shape, "mem_k/mem_v shapes differ")
    _check(tuple(mem_bias.shape) == (b, s), f"mem_bias {tuple(mem_bias.shape)} != {(b, s)}")
    _check(w.wqkv.shape == (L, d, 3 * d), f"wqkv {tuple(w.wqkv.shape)} vs L={L}, d={d}")
    _check(w.w2.shape == (L, d_ff, d) and w.ln.shape == (L, 3, 2, d), "layer shapes")
    _check(w.prenet_w1.shape == (n_mels, d), "prenet shape")
    _check(d % h == 0 and (d // h) % 8 == 0, "head width must be a multiple of 8")
    _check(d % 8 == 0 and d_ff % 8 == 0 and n_mels % 8 == 0,
           "d, d_ff and n_mels must be multiples of 8")
    _check(d <= _THREADS, f"d={d} exceeds {_THREADS}")
    _check(1 <= max_len <= w.pe.shape[0], f"max_len {max_len} outside the PE table")
    smem = smem_bytes(max_len, s, d, h, d_ff, n_mels)
    _check(smem <= kernels.MAX_SMEM, f"needs {smem} B of shared memory")

    kcache = torch.empty(L, b, max_len, d, dtype=bf16, device=dev)
    vcache = torch.empty_like(kcache)
    out = torch.empty(b, max_len, n_mels, dtype=torch.float32, device=dev)
    lib = kernels.library("ar_decode")
    ptrs = [t.data_ptr() for t in (
        w.prenet_w1, w.prenet_b1, w.prenet_w2, w.prenet_b2,
        w.wqkv, w.bqkv, w.wo, w.bo, w.wcq, w.bcq, w.wco, w.bco,
        w.w1, w.b1, w.w2, w.b2, w.ln, w.mel_w, w.mel_b, w.pe,
        mem_k, mem_v, mem_bias, kcache, vcache, out,
    )]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ar_decode_launch(
            *[ctypes.c_void_p(p) for p in ptrs],
            b, max_len, s, L, d, h, d_ff, n_mels, ctypes.c_void_p(stream),
        )
    kernels.raise_on_error("ar_decode", err, lib)
    launches += 1
    return out
