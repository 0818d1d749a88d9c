"""Log-mel spectrogram and STFT magnitude in plain PyTorch and NumPy.

STFT: centred, reflect padding of n_fft // 2, a periodic Hann window of
win_length zero-padded symmetrically to n_fft, one-sided, unnormalised.
Mel: the slaney mel scale and slaney area normalisation (torchaudio's
melscale_fbanks) over the power spectrum, then log10(mel + 1e-10).  Used by
the benchmark to make the mels of its training segments, and by the
training reference's losses.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


@functools.lru_cache(maxsize=4)
def filterbank(n_freqs: int, fmin: float, fmax: float, n_mels: int, sr: int) -> np.ndarray:
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """|STFT| of x [B, T] -> [B, n_fft // 2 + 1, frames]."""
    n = np.arange(win, dtype=np.float64)
    w = torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / win), dtype=x.dtype,
                        device=x.device)
    if win < n_fft:
        left = (n_fft - win) // 2
        w = F.pad(w, (left, n_fft - win - left))
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft, window=w, center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    return spec.abs()


def log_mel(x: torch.Tensor, c: dict) -> torch.Tensor:
    """x [B, T] -> log10 mel power [B, n_mels, T // hop + 1]."""
    spec = stft_magnitude(x, c["n_fft"], c["hop_length"], c["win_length"]) ** 2
    fb = torch.from_numpy(filterbank(c["n_fft"] // 2 + 1, float(c["fmin"]), float(c["fmax"]),
                                     c["n_mels"], c["sample_rate"])).to(x.device, x.dtype)
    return torch.log10(torch.einsum("bft,fm->bmt", spec, fb) + 1e-10)
