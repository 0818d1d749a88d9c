"""HiFi-GAN: the generator and the two discriminators (MSD, MPD).

Generator: mel [B, n_mels, Tfrm] -> wav [B, 1, Tfrm * hop].  conv_pre(k7) ->
per stage [LeakyReLU(0.1) -> ConvTranspose1d (padding (k-u)//2, so T_wav ==
Tfrm * prod(upsample_rates)) -> MRF] -> LeakyReLU(`post_lrelu_slope`, 0.1
by default) -> conv_post(k7, a bias unless `post_bias` is off) -> tanh.
VITS's decoder is this generator over the flow's channels (`n_mels` 192),
with slope 0.01 and no bias there.
No weight norm; the MRF AVERAGES its ResBlocks, and every conv zero-pads its
own input.

`HiFiGANGenerator.forward(mel, mrf_weights, dtype)` runs every MRF through
the K2 wrapper (ops/mrf.py): the hand-written kernels on the card, their
plain version on the CPU, with the MRF weights packed once by `pack`; the
convolutions around them compute in `dtype`, and in bf16 each MRF's input
and output are bf16, as the JAX package's fused MRF takes and gives them.
Without `mrf_weights` the MRFs run as these plain, differentiable modules,
in the compute dtype given (training).

Discriminators, each returning (logits, feature maps) per critic, maps in
torch layout ([B, C, T] and [B, C, H, W]):
  MSD: 3 scale critics at 1x / 2x / 4x; the 4x branch applies
       AvgPool1d(4, 2, 2) twice, as the reference does.
  MPD: period critics (2, 3, 5, 7, 11): reflect-pad T to a multiple of p,
       fold to [B, 1, T/p, p], Conv2d ladder [32, 128, 512, 1024, 1024, 1].
Both use weight norm (spectral norm by config).  The JAX package's folded
and chained layouts for the MSD are lane layouts of its TPU; the plain
layout here gives the same elements, so plain means are exact in the losses.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiscriminatorConfig, GeneratorConfig, VocoderConfig
from ..ops.mrf import MRFWeights, mrf, pack_mrf
from .layers import (
    LRELU_SLOPE, Conv1d, ConvTranspose1d, NormConv1d, NormConv2d, conv1d, conv_transpose1d,
    get_padding,
)

F32 = torch.float32


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class ResBlock(nn.Module):
    """x = x + conv2(lrelu(conv1_{dil d}(lrelu(x)))) per dilation d."""

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

    def forward(self, x: torch.Tensor, dtype: torch.dtype = F32) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + conv1d(c2, _lrelu(conv1d(c1, _lrelu(x), dtype)), dtype)
        return x


class MRF(nn.Module):
    """The parallel ResBlocks, averaged.  `forward` is the plain function
    (ops.mrf.mrf_plain's, differentiable); inference packs the weights for
    the K2 wrapper instead."""

    def __init__(self, channels: int, kernel_sizes=(3, 7, 11), dilation_sizes=((1, 3, 5),) * 3):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResBlock(channels, k, d) for k, d in zip(kernel_sizes, dilation_sizes)
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype = F32) -> torch.Tensor:
        out = None
        for rb in self.resblocks:
            y = rb(x, dtype)
            out = y if out is None else out + y
        return out / len(self.resblocks)


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
        self.conv_post = Conv1d(c0 // (2 ** len(cfg.upsample_rates)), 1, 7, padding=3,
                                bias=cfg.post_bias)

    @torch.no_grad()
    def pack(self, dtype: torch.dtype) -> List[MRFWeights]:
        """Every MRF's weights packed for the K2 wrapper."""
        return [pack_mrf(m, dtype) for m in self.mrfs]

    def forward(self, mel: torch.Tensor, mrf_weights: Optional[List[MRFWeights]] = None,
                dtype: torch.dtype = F32) -> torch.Tensor:
        """mel [B, n_mels, T] -> wav [B, 1, T * hop] float32, every conv in
        `dtype` and tanh in f32.  With `mrf_weights` (inference) every MRF
        goes through K2, which computes in f32 inside: its input is the
        upsampled `dtype` activation, its output is rounded back to `dtype`;
        without, through the modules."""
        x = conv1d(self.conv_pre, mel, dtype)
        for i, up in enumerate(self.ups):
            x = conv_transpose1d(up, _lrelu(x), dtype)
            if mrf_weights is None:
                x = self.mrfs[i](x, dtype)
            else:
                x = mrf(x.float().contiguous(), mrf_weights[i]).to(dtype)
        x = conv1d(self.conv_post, F.leaky_relu(x, self.config.post_lrelu_slope), dtype)
        return torch.tanh(x.float())


# ---- discriminators -----------------------------------------------------------

# MSD ladder conv specs: (cin, cout, kernel, stride, groups, pad); conv_post
# appended by msd_ladder
_MSD_SPECS = (
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
)
# MPD ladder: (cin, cout) of the stride-3 convs, then conv_4 and conv_post
_MPD_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024))


def _scaled(c: int, channel_div: int) -> int:
    return c if c == 1 else max(1, c // channel_div)


def msd_ladder(channel_div: int) -> List[Tuple[int, int, int, int, int, int]]:
    """The 8 conv specs (7 ladder + conv_post) at a channel divisor; groups
    shrink with the channels."""
    out = []
    for cin, cout, k, s, g, p in _MSD_SPECS:
        cin, cout = _scaled(cin, channel_div), _scaled(cout, channel_div)
        out.append((cin, cout, k, s, math.gcd(g, math.gcd(cin, cout)), p))
    out.append((_scaled(1024, channel_div), 1, 3, 1, 1, 1))
    return out


def _norm(spectral: bool) -> str:
    return "spectral" if spectral else "weight"


class ScaleDiscriminator(nn.Module):
    """One waveform critic: 7 convs + conv_post; 8 feature maps (the last is
    the logits)."""

    def __init__(self, spectral: bool = False, channel_div: int = 1):
        super().__init__()
        *ladder, post = msd_ladder(channel_div)
        norm = _norm(spectral)
        self.convs = nn.ModuleList(
            NormConv1d(cin, cout, k, stride=s, groups=g, padding=p, norm=norm)
            for cin, cout, k, s, g, p in ladder
        )
        cin, cout, k, _, _, p = post
        self.conv_post = NormConv1d(cin, cout, k, padding=p, norm=norm)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = F32, advance: bool = False):
        fmaps = []
        for conv in self.convs:
            x = _lrelu(conv(x, dtype, advance))
            fmaps.append(x)
        x = self.conv_post(x, dtype, advance)
        fmaps.append(x)
        return x, fmaps


class MultiScaleDiscriminator(nn.Module):
    """Critics at 1x / 2x / 4x: each further scale pools the last one with
    AvgPool1d(4, 2, 2) (zero padding counted), in the waveform's dtype."""

    def __init__(self, spectral: bool = False, channel_div: int = 1, n_scales: int = 3):
        super().__init__()
        self.discs = nn.ModuleList(ScaleDiscriminator(spectral, channel_div)
                                   for _ in range(n_scales))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = F32, advance: bool = False):
        outs, fmaps = [], []
        for i, disc in enumerate(self.discs):
            if i > 0:
                x = F.avg_pool1d(x, 4, 2, 2)
            out, fm = disc(x, dtype, advance)
            outs.append(out)
            fmaps.append(fm)
        return outs, fmaps


class PeriodDiscriminator(nn.Module):
    """Period-p critic on [B, 1, T/p, p]: 4 Conv2d (5, 1) of stride (3, 1),
    conv_4 of stride 1, conv_post (3, 1); 6 feature maps."""

    def __init__(self, period: int, spectral: bool = False, channel_div: int = 1,
                 kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        norm = _norm(spectral)
        pad = (get_padding(kernel_size, 1), 0)
        convs = [NormConv2d(_scaled(cin, channel_div), _scaled(cout, channel_div),
                            (kernel_size, 1), (stride, 1), pad, norm=norm)
                 for cin, cout in _MPD_CHANNELS]
        c = _scaled(1024, channel_div)
        convs.append(NormConv2d(c, c, (kernel_size, 1), 1, (2, 0), norm=norm))
        self.convs = nn.ModuleList(convs)
        self.conv_post = NormConv2d(c, 1, (3, 1), 1, (1, 0), norm=norm)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = F32, advance: bool = False):
        b, c, t = x.shape
        if t % self.period:
            pad = self.period - t % self.period
            x = F.pad(x, (0, pad), mode="reflect")
            t += pad
        x = x.reshape(b, c, t // self.period, self.period)
        fmaps = []
        for conv in self.convs:
            x = _lrelu(conv(x, dtype, advance))
            fmaps.append(x)
        x = self.conv_post(x, dtype, advance)
        fmaps.append(x)
        return x, fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), spectral: bool = False,
                 channel_div: int = 1):
        super().__init__()
        self.discs = nn.ModuleList(PeriodDiscriminator(p, spectral, channel_div)
                                   for p in periods)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = F32, advance: bool = False):
        outs, fmaps = [], []
        for disc in self.discs:
            out, fm = disc(x, dtype, advance)
            outs.append(out)
            fmaps.append(fm)
        return outs, fmaps


class HiFiGAN(nn.Module):
    """Generator + MSD + MPD.  `discriminate(wav_real, wav_fake)` returns the
    reference's 8-tuple (msd_real_out, msd_real_feat, msd_fake_out,
    msd_fake_feat, mpd_real_out, mpd_real_feat, mpd_fake_out,
    mpd_fake_feat); advance=True moves the spectral-norm power iteration on
    at every critic call (so twice per discriminate: real, then fake)."""

    def __init__(self, config: VocoderConfig = VocoderConfig()):
        super().__init__()
        self.config = config
        d: DiscriminatorConfig = config.discriminator
        self.generator = HiFiGANGenerator(config.generator)
        self.msd = MultiScaleDiscriminator(d.msd_use_spectral_norm, d.channel_div, d.msd_scales)
        self.mpd = MultiPeriodDiscriminator(tuple(d.mpd_periods), d.mpd_use_spectral_norm,
                                            d.channel_div)

    def discriminator_parameters(self) -> List[nn.Parameter]:
        return list(self.msd.parameters()) + list(self.mpd.parameters())

    def discriminate(self, wav_real: torch.Tensor, wav_fake: torch.Tensor,
                     dtype: torch.dtype = F32, advance: bool = False):
        msd_real_out, msd_real_feat = self.msd(wav_real, dtype, advance)
        msd_fake_out, msd_fake_feat = self.msd(wav_fake, dtype, advance)
        mpd_real_out, mpd_real_feat = self.mpd(wav_real, dtype, advance)
        mpd_fake_out, mpd_fake_feat = self.mpd(wav_fake, dtype, advance)
        return (
            msd_real_out, msd_real_feat, msd_fake_out, msd_fake_feat,
            mpd_real_out, mpd_real_feat, mpd_fake_out, mpd_fake_feat,
        )
