"""Log-mel spectrogram extraction: the one mel op of the port.

Dataset preprocessing, the vocoder's mel-reconstruction loss and inference
all go through `log_mel_spectrogram`; the mel configuration must be the same
for all three (the train/infer invariant, `config.validate_mel_consistency`).

The filterbank is torchaudio's melscale_fbanks (slaney mel scale and slaney
norm by default), computed in float64 numpy and cast to float32; the
resampler is torchaudio's Resample (sinc interpolation with a Hann window,
lowpass_filter_width 6, rolloff 0.99), also from a numpy kernel.  No
torchaudio is needed.

Output: log_mel = log_b(mel_power + 1e-10), [..., n_mels, T], T = time // hop + 1.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioConfig
from .stft import hann_window, stft_magnitude

_MEL_LOG_EPS = 1e-10

# Slaney mel-scale constants
_F_SP = 200.0 / 3.0  # Hz per mel below the break
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq, mel_scale: str = "slaney") -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mels, mel_scale: str = "slaney") -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_np(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: Optional[str],
    mel_scale: str,
) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], float64 -> float32."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)  # [n_mels + 2]

    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]  # rising edge
    up_slopes = slopes[:, 2:] / f_diff[1:]  # falling edge
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))  # [n_freqs, n_mels]

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def mel_filterbank(audio: AudioConfig, device=None) -> torch.Tensor:
    """Mel filterbank [n_freqs, n_mels] for the given audio config."""
    fb = _mel_filterbank_np(
        audio.n_fft // 2 + 1, float(audio.fmin), float(audio.fmax), audio.n_mels,
        audio.sample_rate, audio.norm, audio.mel_scale,
    )
    return torch.from_numpy(fb).to(device)


def _apply_log(mel: torch.Tensor, log_base: Any) -> torch.Tensor:
    """log_b(mel + 1e-10): base 10, e, or any other as ln(x) / ln(b)."""
    x = mel + _MEL_LOG_EPS
    if log_base == 10.0 or log_base == "10":
        return torch.log10(x)
    if log_base == "e" or log_base == 2.718281828459045:
        return torch.log(x)
    return torch.log(x) / np.log(float(log_base))


def mel_power_spectrogram(waveform: torch.Tensor, audio: AudioConfig) -> torch.Tensor:
    """Power mel spectrogram (no log) of waveform [..., time] -> [..., n_mels, T]."""
    spec = stft_magnitude(
        waveform, n_fft=audio.n_fft, hop_length=audio.hop_length, win_length=audio.win_length,
        window=hann_window(audio.win_length, dtype=waveform.dtype, device=waveform.device),
        center=True, power=2.0,
    )  # [..., n_freqs, T]
    fb = mel_filterbank(audio, waveform.device).to(waveform.dtype)
    return torch.einsum("...ft,fm->...mt", spec, fb)


def log_mel_spectrogram(waveform: torch.Tensor, audio: AudioConfig) -> torch.Tensor:
    """Log-mel spectrogram of waveform [..., time] -> [..., n_mels, T]: the op
    shared by preprocessing, the vocoder loss and inference."""
    return _apply_log(mel_power_spectrogram(waveform, audio), audio.log_base)


def extract_mel(waveform, sample_rate: Optional[int] = None,
                audio: Optional[AudioConfig] = None) -> torch.Tensor:
    """[time] or [channels, time] (numpy or tensor) -> log-mel [n_mels, T]:
    resampled to audio.sample_rate if needed and downmixed to mono."""
    if audio is None:
        audio = AudioConfig()
    x = torch.as_tensor(waveform, dtype=torch.float32)
    if x.dim() == 1:
        x = x[None, :]
    if sample_rate is not None and sample_rate != audio.sample_rate:
        x = resample(x, sample_rate, audio.sample_rate)
    if x.shape[0] > 1:
        x = x.mean(dim=0, keepdim=True)
    return log_mel_spectrogram(x[0], audio)


def extract_mel_from_file(audio_path, audio: Optional[AudioConfig] = None):
    """Load a WAV file and extract its log-mel: (log_mel [n_mels, T], the
    file's sample rate)."""
    from ..data.audio import load_wav

    waveform, sample_rate = load_wav(audio_path)
    return extract_mel(waveform, sample_rate, audio), sample_rate


@functools.lru_cache(maxsize=8)
def _resample_kernel_np(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                        rolloff: float = 0.99):
    gcd = np.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = int(np.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(t == 0, 1.0, np.sin(t * np.pi) / (t * np.pi))
    kernels = sinc * window * scale
    return kernels.astype(np.float32), width, orig, new


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample x [channels, time] from orig_freq to new_freq."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig, new = _resample_kernel_np(orig_freq, new_freq)
    num_wavs, length = x.shape
    target_length = int(np.ceil(new * length / orig))
    x_pad = F.pad(x, (width, width + orig))
    k = torch.from_numpy(kernels).to(device=x.device, dtype=x.dtype)[:, None, :]  # [new, 1, K]
    y = F.conv1d(x_pad[:, None, :], k, stride=orig)  # [C, new, T // orig]
    y = y.transpose(1, 2).reshape(num_wavs, -1)
    return y[:, :target_length]
