"""The card's peak rates and the train steps' FLOP counts, shared by
`bench_scaling`, `bench` and `chip_smoke.py`.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 3.35 TB/s of HBM and 989 TFLOP/s in bf16 on the tensor
cores.  A card set below 700 W (`nvidia-smi --query-gpu=power.limit`) runs
slower under load; shares of these peaks are stated beside its limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def acoustic_step_flops(cfg, b: int, tph: int, t: int) -> float:
    """Matrix-product FLOPs of one acoustic train step (forward, and backward
    at twice the forward), from the shapes: the encoder over b x tph
    phonemes, the three predictors' convolutions, the decoder over b x t
    frames (dense causal and cross attention over all t frames, as
    computed).  One teacher-forced pass, no remat: a step with scheduled
    sampling or remat computes more."""
    am = cfg.acoustic_model
    d, enc, dec, va = am.d_model, am.encoder, am.decoder, am.variance_adaptor
    per_token = enc.n_layers * (4 * d * d + 2 * d * enc.d_ff + 2 * tph * d)
    per_token += 3 * va.predictor_layers * va.predictor_kernel_size * d * d + 3 * d
    per_frame = dec.n_layers * (4 * d * d + 4 * d * d + 2 * d * dec.d_ff + 4 * t * d)
    per_frame += am.n_mels * d + d * d + d * am.n_mels
    return 3 * 2 * (b * tph * per_token + b * t * per_frame)


def _conv_out(t: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (t + 2 * p - d * (k - 1) - 1) // s + 1


def _generator_flops(gcfg, n_mels: int, b: int, frames: int):
    """Forward FLOPs of the HiFi-GAN generator over b x `frames` mel frames,
    and of its first conv alone (whose input, the mel, takes no gradient):
    conv_pre, each ConvTranspose (2 Cin Cout k per input sample), each MRF's
    ResBlock convs, conv_post."""
    c = gcfg.upsample_initial_channel
    t = frames
    first = 2 * b * t * n_mels * c * 7
    total = first
    for u, k in zip(gcfg.upsample_rates, gcfg.upsample_kernel_sizes):
        total += 2 * b * t * c * (c // 2) * k
        c, t = c // 2, t * u
        for rk, dils in zip(gcfg.resblock_kernel_sizes, gcfg.resblock_dilation_sizes):
            total += 2 * len(dils) * 2 * b * t * c * c * rk
    return total + 2 * b * t * c * 7, first


def _discriminator_flops(dcfg, b: int, t: int):
    """Forward FLOPs of MSD + MPD on one waveform batch [b, 1, t], and of
    each critic's first conv (whose input, the waveform or its pooling,
    takes a gradient only in the generator's pass)."""
    from .models.hifigan import _MPD_CHANNELS, _scaled, msd_ladder

    total = first = 0
    n = t
    for i in range(dcfg.msd_scales):
        if i:
            n = _conv_out(n, 4, 2, 2)  # AvgPool1d(4, 2, 2)
        x = n
        for j, (cin, cout, k, s, g, p) in enumerate(msd_ladder(dcfg.channel_div)):
            x = _conv_out(x, k, s, p)
            f = 2 * b * x * cout * (cin // g) * k
            total += f
            first += f if j == 0 else 0
    c = _scaled(1024, dcfg.channel_div)
    for period in dcfg.mpd_periods:
        h = -(-t // period)
        convs = [(_scaled(ci, dcfg.channel_div), _scaled(co, dcfg.channel_div), 5, 3, 2)
                 for ci, co in _MPD_CHANNELS] + [(c, c, 5, 1, 2), (c, 1, 3, 1, 1)]
        for j, (cin, cout, k, s, p) in enumerate(convs):
            h = _conv_out(h, k, s, p)
            f = 2 * b * h * period * cout * cin * k
            total += f
            first += f if j == 0 else 0
    return total, first


def vocoder_step_flops(cfg, b: int, seg: int) -> float:
    """Matrix-product FLOPs of one `adv_mel_fm` vocoder train step at B = b
    over `seg`-frame segments, as training/vocoder_trainer.py computes it.
    A backward pass costs twice its forward where it takes the gradients of
    both a layer's input and its weights, once where it takes one of them:

      generator forward                                      G
      D step: MSD + MPD on real and fake                     2 D
        backward to D's weights (inputs need none)           2 (2 D - D_first)
      G step: MSD + MPD on fake, and real for the features   2 D
        backward through D(fake) to the waveform only        D
      the generator's backward (the mel needs none)          2 G - G_first
      log-mel filterbank products: real, fake, fake's backward

    The STFTs are FFTs, which this count (like torch's FlopCounterMode)
    leaves out."""
    hop, n_mels = cfg.audio.hop_length, cfg.audio.n_mels
    t = seg * hop
    g, g_first = _generator_flops(cfg.vocoder.generator, n_mels, b, seg)
    d, d_first = _discriminator_flops(cfg.vocoder.discriminator, b, t)
    frames = t // hop + 1  # the centred STFT's frames
    mel = 2 * b * (cfg.audio.n_fft // 2 + 1) * frames * n_mels
    return g + 2 * d + 2 * (2 * d - d_first) + 2 * d + d + 2 * g - g_first + 3 * mel
