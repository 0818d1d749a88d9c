"""HiFi-GAN generator (inference): mel [B, n_mels, Tfrm] -> wav [B, 1, Tfrm * hop].

conv_pre(k7) -> per stage [LeakyReLU(0.1) -> ConvTranspose1d (padding
(k-u)//2, so T_wav == Tfrm * prod(upsample_rates)) -> MRF] -> LeakyReLU ->
conv_post(k7) -> tanh.  No weight norm; the MRF AVERAGES its ResBlocks.

Every MRF runs through the K2 wrapper (ops/mrf.py): the hand-written kernels
on the card, their plain version on the CPU.  `forward` takes the MRF
weights packed once by `pack`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import GeneratorConfig
from ..ops.mrf import MRFWeights, mrf, pack_mrf
from .layers import LRELU_SLOPE, Conv1d, ConvTranspose1d, get_padding


class ResBlock(nn.Module):
    """Parameters of x = x + conv2(lrelu(conv1_{dil d}(lrelu(x)))) per d."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d))
            for d in self.dilations
        )
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in self.dilations
        )


class MRF(nn.Module):
    """Parameters of the parallel ResBlocks; computed by ops.mrf.mrf."""

    def __init__(self, channels: int, kernel_sizes=(3, 7, 11), dilation_sizes=((1, 3, 5),) * 3):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResBlock(channels, k, d) for k, d in zip(kernel_sizes, dilation_sizes)
        )


class HiFiGANGenerator(nn.Module):
    def __init__(self, config: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.n_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.mrfs = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, cout = c0 // (2 ** i), c0 // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(cin, cout, k, stride=u, padding=(k - u) // 2))
            self.mrfs.append(MRF(cout, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        self.conv_post = Conv1d(c0 // (2 ** len(cfg.upsample_rates)), 1, 7, padding=3)

    @torch.no_grad()
    def pack(self, dtype: torch.dtype) -> List[MRFWeights]:
        """Every MRF's weights packed for the K2 wrapper."""
        return [pack_mrf(m, dtype) for m in self.mrfs]

    def forward(self, mel: torch.Tensor, mrf_weights: List[MRFWeights]) -> torch.Tensor:
        x = self.conv_pre(mel.float())
        for up, w in zip(self.ups, mrf_weights):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = mrf(x.contiguous(), w)
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)
