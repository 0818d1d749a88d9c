"""K2: one whole multi-receptive-field (MRF) block of the HiFi-GAN generator.

`mrf` is the wrapper.  A CUDA tensor goes to the hand-written kernels in
`csrc/mrf.cu` (18 tensor-core conv launches plus one rounding pass, enqueued
by one C call; or the call raises); a CPU tensor goes to `mrf_plain`, the
same function with `F.conv1d`.  There is no switch and no fallback.

The function is the flax `MRF` of the JAX package: 3 ResBlocks, each
3 x [LeakyReLU(0.1) -> conv (dilation d) -> LeakyReLU -> conv (dilation 1)
-> + residual], averaged.  Every conv zero-pads its own input at the
sequence ends.  With bf16 weights the conv inputs (and the block input) are
rounded to bf16 and products accumulate in f32, as in the Pallas kernel; with
f32 weights nothing is rounded.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

launches = 0  # MRF calls that launched the kernels (never the plain version)

LRELU_SLOPE = 0.1


class MRFWeights(NamedTuple):
    """One MRF's conv weights, packed once per pipeline.

    `weights` are torch Conv1d weights [C, C, K] in the kernel dtype, in
    (ResBlock, dilation, conv1/conv2) order, `biases` [n_convs, C] f32.
    `packed` is the same weights as 16x16 bf16 tiles for the kernel
    ([C/16, C/16, K, 16, 16] per conv, concatenated), None for f32."""

    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[int, ...]
    weights: List[torch.Tensor]
    biases: torch.Tensor
    packed: torch.Tensor = None


def pack_conv_tiles(w: torch.Tensor) -> torch.Tensor:
    """Conv1d weight [Cout, Cin, K] -> flat [Cout/16, Cin/16, K, 16, 16]."""
    co, ci, k = w.shape
    t = w.permute(2, 0, 1).reshape(k, co // 16, 16, ci // 16, 16)
    return t.permute(1, 3, 0, 2, 4).contiguous().reshape(-1)


def pack_mrf(mrf_module, dtype: torch.dtype) -> MRFWeights:
    """Pack a models.hifigan.MRF for `mrf` (weights in `dtype`)."""
    ks, dils, ws, bs = [], None, [], []
    for rb in mrf_module.resblocks:
        ks.append(rb.kernel_size)
        dils = rb.dilations if dils is None else dils
        if rb.dilations != dils:
            raise ValueError("every ResBlock of an MRF must share one dilation list")
        for c1, c2 in zip(rb.convs1, rb.convs2):
            for conv in (c1, c2):
                ws.append(conv.weight.detach().to(dtype).contiguous())
                bs.append(conv.bias.detach().float())
    packed = None
    if dtype == torch.bfloat16 and ws[0].shape[0] % 32 == 0:
        packed = torch.cat([pack_conv_tiles(w) for w in ws])
    return MRFWeights(tuple(ks), tuple(dils), ws, torch.stack(bs).contiguous(), packed)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def mrf(x: torch.Tensor, w: MRFWeights) -> torch.Tensor:
    """x [B, C, T] -> [B, C, T] f32."""
    if x.device.type == "cpu":
        return mrf_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"mrf: unsupported device {x.device}")
    return _mrf_cuda(x, w)


def mrf_plain(x: torch.Tensor, w: MRFWeights) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    if w.weights[0].dtype == torch.bfloat16:
        rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    else:
        rnd = lambda t: t  # noqa: E731
    x0 = rnd(x.float())
    out = None
    n = 0
    for k in w.kernel_sizes:
        y = x0
        for d in w.dilations:
            t1 = F.conv1d(rnd(_lrelu(y)), w.weights[n].float(), w.biases[n],
                          padding=(k * d - d) // 2, dilation=d)
            t2 = F.conv1d(rnd(_lrelu(t1)), w.weights[n + 1].float(), w.biases[n + 1],
                          padding=(k - 1) // 2)
            y = y + t2
            n += 2
        out = y if out is None else out + y
    return out / len(w.kernel_sizes)


def _mrf_cuda(x: torch.Tensor, w: MRFWeights) -> torch.Tensor:
    global launches
    b, c, t = x.shape
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("mrf kernel: x must be contiguous f32 [B, C, T]")
    if w.packed is None or w.packed.device != dev or w.packed.dtype != torch.bfloat16:
        raise ValueError(f"mrf kernel: needs bf16 packed weights on {dev} (C % 32 == 0)")
    if w.biases.device != dev or w.biases.dtype != torch.float32:
        raise ValueError(f"mrf kernel: biases must be f32 on {dev}")
    n_convs = 2 * len(w.kernel_sizes) * len(w.dilations)
    expect = sum(2 * len(w.dilations) * c * c * k for k in w.kernel_sizes)
    if w.packed.numel() != expect or tuple(w.biases.shape) != (n_convs, c):
        raise ValueError(f"mrf kernel: weights do not match C={c}")
    # the kernel stages input channels 64 at a time (all of them when C = 32)
    if (c != 32 and c % 64) or any(k % 2 == 0 for k in w.kernel_sizes):
        raise ValueError("mrf kernel: needs C = 32 or C % 64 == 0, and odd kernel sizes")
    if b > 65535:
        raise ValueError("mrf kernel: batch exceeds the grid limit")
    out = torch.empty_like(x)
    x0, y, t1 = (torch.empty_like(x) for _ in range(3))
    ks = (ctypes.c_int * len(w.kernel_sizes))(*w.kernel_sizes)
    dils = (ctypes.c_int * len(w.dilations))(*w.dilations)
    lib = kernels.library("mrf")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mrf_launch(
            *[ctypes.c_void_p(p.data_ptr()) for p in (x, w.packed, w.biases, out, x0, y, t1)],
            b, c, t, len(w.kernel_sizes), len(w.dilations),
            ctypes.cast(ks, ctypes.c_void_p), ctypes.cast(dils, ctypes.c_void_p),
            ctypes.c_void_p(stream),
        )
    kernels.raise_on_error("mrf", err, lib)
    launches += 1
    return out
