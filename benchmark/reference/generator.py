"""The HiFi-GAN V1 generator in plain PyTorch (Kong et al. 2020), shared by
both configurations' references.

mel [B, n_mels, T] -> wav [B, 1, T * prod(upsample)]: conv_pre (k 7) ->
per stage [LeakyReLU(0.1) -> ConvTranspose1d (padding (k - u) // 2) -> MRF]
-> LeakyReLU -> conv_post (k 7) -> tanh.  The MRF is the mean of its
ResBlocks; a ResBlock is, per dilation d, x = x + conv2(lrelu(conv1_d(
lrelu(x)))).  Every conv zero-pads its own input.  Weights are read by the
system's state_dict names from `P` under `prefix`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SLOPE = 0.1


def _conv(P, name, x, q, **kw):
    return F.conv1d(q(x), q(P[name + ".weight"]), P[name + ".bias"], **kw)


def generator(P, prefix: str, mel: torch.Tensor, c: dict, q) -> torch.Tensor:
    x = _conv(P, prefix + "conv_pre", mel, q, padding=3)
    n_rb = len(c["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
        up = f"{prefix}ups.{i}"
        x = F.conv_transpose1d(q(F.leaky_relu(x, SLOPE)), q(P[up + ".weight"]), P[up + ".bias"],
                               stride=u, padding=(k - u) // 2)
        out = None
        for r, (rk, dils) in enumerate(zip(c["resblock_kernel_sizes"],
                                           c["resblock_dilation_sizes"])):
            rb = f"{prefix}mrfs.{i}.resblocks.{r}"
            y = x
            for j, d in enumerate(dils):
                t = _conv(P, f"{rb}.convs1.{j}", F.leaky_relu(y, SLOPE), q,
                          padding=(rk * d - d) // 2, dilation=d)
                y = y + _conv(P, f"{rb}.convs2.{j}", F.leaky_relu(t, SLOPE), q,
                              padding=(rk - 1) // 2)
            out = y if out is None else out + y
        x = out / n_rb
    x = _conv(P, prefix + "conv_post", F.leaky_relu(x, SLOPE), q, padding=3)
    return torch.tanh(x)
