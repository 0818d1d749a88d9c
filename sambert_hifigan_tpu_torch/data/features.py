"""Ground-truth feature extraction: F0 (pitch), energy, durations.

The frame layout is that of the mel frames (centred, reflect-padded, hop
256, T = time // hop + 1), so pitch_gt and energy_gt line up with mel_gt by
construction, as in the JAX package's `data/features.py`.

F0: frame-wise normalised autocorrelation, searched over lags [sr /
fmax_pitch, sr / fmin_pitch], computed with an rFFT of twice the frame
length (Wiener-Khinchin; cuFFT on the card), then refined by a parabola
through the peak.  Unvoiced frames (peak below the voicing threshold,
silent, or outside the band) report f0 = 0 and voiced = False, which masks
the pitch loss.  The peak is an argmax over the band: where two lags tie
to within float noise, two FFT libraries can pick different neighbours,
and a frame near the voicing threshold can flip its voiced flag (the
tests bound how often).

Energy: per-frame RMS, normalised per utterance to [0, 1].

Durations: `uniform_durations` is the even-split bootstrap; the CTC aligner
(data/aligner.py) replaces it with learned ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioConfig
from ..ops.stft import frame_signal


def frame_waveform_centered(wav: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Frames aligned with the centred STFT: reflect-pad frame_length // 2 on
    both sides -> [..., T, frame_length], T = time // hop + 1."""
    pad = frame_length // 2
    lead = wav.shape[:-1]
    x = F.pad(wav.reshape(1, -1, wav.shape[-1]), (pad, pad), mode="reflect")
    return frame_signal(x.reshape(*lead, x.shape[-1]), frame_length, hop)


def extract_f0(
    wav: torch.Tensor,  # [..., time]
    audio: AudioConfig,
    fmin_pitch: float = 80.0,
    fmax_pitch: float = 600.0,
    voicing_threshold: float = 0.3,
    energy_floor: float = 1e-4,
    frame_length: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autocorrelation F0 -> (f0 [..., T] in Hz with 0 for unvoiced,
    voiced [..., T] bool).  The band is the PitchPredictor's [80, 600] Hz."""
    sr = audio.sample_rate
    frame_length = frame_length or audio.win_length
    frames = frame_waveform_centered(wav, frame_length, audio.hop_length)
    frames = frames - frames.mean(dim=-1, keepdim=True)

    n_fft = 2 * frame_length
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    ac = torch.fft.irfft(spec.abs() ** 2, n=n_fft, dim=-1)[..., :frame_length]
    r0 = ac[..., 0]
    ncc = ac / (r0[..., None] + 1e-10)

    lag_min = max(int(sr / fmax_pitch), 2)
    lag_max = min(int(sr / fmin_pitch) + 1, frame_length - 1)
    band = ncc[..., lag_min: lag_max + 1]
    best = band.argmax(dim=-1)
    peak = band.gather(-1, best[..., None])[..., 0]

    # parabolic interpolation around the peak for a sub-sample lag
    idx = best + lag_min
    ym = ncc.gather(-1, (idx - 1).clamp(0, frame_length - 1)[..., None])[..., 0]
    y0 = ncc.gather(-1, idx[..., None])[..., 0]
    yp = ncc.gather(-1, (idx + 1).clamp(0, frame_length - 1)[..., None])[..., 0]
    denom = ym - 2 * y0 + yp
    delta = torch.where(denom.abs() > 1e-8, 0.5 * (ym - yp) / denom, torch.zeros_like(denom))
    refined_lag = idx.to(torch.float32) + delta.clamp(-0.5, 0.5)

    f0 = sr / refined_lag.clamp(min=1.0)
    rms = torch.sqrt(r0 / frame_length + 1e-12)
    voiced = (peak > voicing_threshold) & (rms > energy_floor)
    voiced &= (f0 >= fmin_pitch) & (f0 <= fmax_pitch)
    return torch.where(voiced, f0, torch.zeros_like(f0)), voiced


def extract_energy(wav: torch.Tensor, audio: AudioConfig, normalize: bool = True) -> torch.Tensor:
    """Per-frame RMS normalised per utterance to [0, 1] -> energy [..., T].

    normalize=False returns the raw RMS, so a caller that extracts on a
    padded buffer can slice to the true frame count first and normalise
    over real frames only (TTSDataset does this)."""
    frames = frame_waveform_centered(wav, audio.win_length, audio.hop_length)
    rms = torch.sqrt(frames.square().mean(dim=-1) + 1e-12)
    if not normalize:
        return rms
    return rms / (rms.amax(dim=-1, keepdim=True) + 1e-8)


def uniform_durations(n_phonemes: int, n_frames: int) -> np.ndarray:
    """Split n_frames over n_phonemes as evenly as possible (host-side):
    sum == n_frames exactly; the first n_frames % n_phonemes get one more."""
    base = n_frames // n_phonemes
    rem = n_frames % n_phonemes
    out = np.full(n_phonemes, base, np.int32)
    out[:rem] += 1
    return out
