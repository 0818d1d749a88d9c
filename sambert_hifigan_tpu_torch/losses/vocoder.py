"""HiFi-GAN vocoder losses.

LSGAN adversarial terms, feature matching (real maps detached),
multi-resolution STFT (the reference's "spectral convergence" is an L1 on
log magnitudes and its "mag" term an L2 on log magnitudes, kept on purpose),
and mel reconstruction through the ONE shared log-mel op (ops/mel.py).

Aggregation: every GAN term is the MEAN over all 8 critics (3 MSD + 5 MPD);
the FM term is first the mean over each critic's layers.

Loss modes:
  mel_only   : L_gen = 45 * L_mel                   (no discriminator training)
  adv_mel    : L_gen = L_adv + 45 * L_mel + L_stft
  adv_mel_fm : L_gen = L_adv + 2 * L_fm + 45 * L_mel + L_stft

Inactive terms are reported as 0-valued metrics: every mode has the full
key schema.  Every input here is float32 (the trainer casts at the loss
boundary).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import AudioConfig, LossWeights
from ..ops.mel import log_mel_spectrogram
from ..ops.stft import stft_magnitude

VALID_LOSS_MODES = ("mel_only", "adv_mel", "adv_mel_fm")

# Multi-resolution STFT configs
STFT_PARAMS = (
    {"n_fft": 1024, "hop_length": 120, "win_length": 600},
    {"n_fft": 2048, "hop_length": 240, "win_length": 1200},
    {"n_fft": 512, "hop_length": 50, "win_length": 240},
)

Maps = Sequence[Sequence[torch.Tensor]]


def discriminator_loss(disc_real_outputs: Sequence[torch.Tensor],
                       disc_fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN: mean over critics of E[(D(x) - 1)^2] + E[D(g)^2]."""
    loss = 0.0
    for dr, df in zip(disc_real_outputs, disc_fake_outputs):
        loss = loss + torch.mean(torch.square(dr - 1.0)) + torch.mean(torch.square(df))
    return loss / len(disc_real_outputs)


def generator_adversarial_loss(disc_fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN: mean over critics of E[(D(g) - 1)^2]."""
    loss = 0.0
    for df in disc_fake_outputs:
        loss = loss + torch.mean(torch.square(df - 1.0))
    return loss / len(disc_fake_outputs)


def feature_matching_loss(real_feature_maps: Maps,
                          fake_feature_maps: Maps) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """L1 per layer (real side detached), the mean over layers, then over
    critics; also the per-critic terms."""
    per_disc = []
    for real_list, fake_list in zip(real_feature_maps, fake_feature_maps):
        disc_loss = 0.0
        for rf, ff in zip(real_list, fake_list):
            disc_loss = disc_loss + torch.mean(torch.abs(ff - rf.detach()))
        per_disc.append(disc_loss / len(real_list))
    return sum(per_disc) / len(per_disc), per_disc


def multi_resolution_stft_loss(wav_real: torch.Tensor,
                               wav_fake: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sc, mag) over 3 resolutions, both on log(|STFT| + 1e-5): sc = L1,
    mag = L2."""
    x = wav_real.squeeze(1)  # [B, T]
    g = wav_fake.squeeze(1)
    sc_loss = 0.0
    mag_loss = 0.0
    for p in STFT_PARAMS:
        log_r = torch.log(stft_magnitude(x, p["n_fft"], p["hop_length"], p["win_length"]) + 1e-5)
        log_f = torch.log(stft_magnitude(g, p["n_fft"], p["hop_length"], p["win_length"]) + 1e-5)
        sc_loss = sc_loss + torch.mean(torch.abs(log_f - log_r))
        mag_loss = mag_loss + torch.mean(torch.square(log_f - log_r))
    n = len(STFT_PARAMS)
    return sc_loss / n, mag_loss / n


def mel_reconstruction_loss(wav_real: torch.Tensor, wav_fake: torch.Tensor,
                            audio: AudioConfig) -> torch.Tensor:
    """L1 between the log-mels of real and fake, through the shared mel op."""
    mel_real = log_mel_spectrogram(wav_real.squeeze(1), audio)
    mel_fake = log_mel_spectrogram(wav_fake.squeeze(1), audio)
    return torch.mean(torch.abs(mel_fake - mel_real))


def vocoder_discriminator_loss(
    disc_real_outputs: Sequence[torch.Tensor], disc_fake_outputs: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    loss = discriminator_loss(disc_real_outputs, disc_fake_outputs)
    return loss, {"disc_loss": loss}


def vocoder_generator_loss(
    wav_real: torch.Tensor,
    wav_fake: torch.Tensor,
    audio: AudioConfig,
    loss_mode: str = "adv_mel_fm",
    disc_fake_outputs: Optional[Sequence[torch.Tensor]] = None,
    real_feature_maps: Optional[Maps] = None,
    fake_feature_maps: Optional[Maps] = None,
    weights: LossWeights = LossWeights(),
    use_mel_loss: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(gen_loss, metrics) for a loss mode; metrics carry every key, zeros
    for inactive terms, and gen_fm_loss_disc_{i} per critic in adv_mel_fm."""
    if loss_mode not in VALID_LOSS_MODES:
        raise ValueError(
            f"Invalid loss_mode '{loss_mode}'. Must be one of {list(VALID_LOSS_MODES)}"
        )
    zero = torch.zeros((), dtype=torch.float32, device=wav_fake.device)
    metrics: Dict[str, torch.Tensor] = {}
    mel_loss = mel_reconstruction_loss(wav_real, wav_fake, audio) if use_mel_loss else zero
    metrics["gen_mel_loss"] = mel_loss

    if loss_mode == "mel_only":
        gen_loss = weights.vocoder_mel * mel_loss
        for k in ("gen_adv_loss", "gen_fm_loss", "gen_sc_loss", "gen_mag_loss", "gen_stft_loss"):
            metrics[k] = zero
    else:
        if disc_fake_outputs is None:
            raise ValueError(f"disc_fake_outputs is required for '{loss_mode}' mode")
        adv = generator_adversarial_loss(disc_fake_outputs)
        sc, mag = multi_resolution_stft_loss(wav_real, wav_fake)
        stft = sc + mag
        fm, per_disc = zero, []
        gen_loss = adv
        if loss_mode == "adv_mel_fm":
            if real_feature_maps is None or fake_feature_maps is None:
                raise ValueError(
                    "real_feature_maps and fake_feature_maps are required for "
                    "'adv_mel_fm' mode"
                )
            fm, per_disc = feature_matching_loss(real_feature_maps, fake_feature_maps)
            gen_loss = gen_loss + weights.feature_matching * fm
        gen_loss = gen_loss + weights.vocoder_mel * mel_loss + weights.stft * stft
        metrics["gen_adv_loss"] = adv
        metrics["gen_fm_loss"] = fm
        metrics["gen_sc_loss"] = sc
        metrics["gen_mag_loss"] = mag
        metrics["gen_stft_loss"] = stft
        for i, d in enumerate(per_disc):
            metrics[f"gen_fm_loss_disc_{i}"] = d

    metrics["gen_loss"] = gen_loss
    return gen_loss, metrics


def should_train_discriminator(loss_mode: str) -> bool:
    return loss_mode in ("adv_mel", "adv_mel_fm")
