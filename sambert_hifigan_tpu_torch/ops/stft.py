"""STFT with torch.stft's semantics as torchaudio's MelSpectrogram uses them:
center=True with reflect padding of n_fft // 2 on both sides, a periodic Hann
window zero-padded symmetrically to n_fft, onesided, no normalisation.

Frame count: T = time // hop_length + 1 (`num_stft_frames`).

The transform itself is `torch.stft` (cuFFT on the card): like the JAX
package's XLA FFT, it is a library call and no TPU kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, computed in float64 then cast, as
    torch.hann_window(periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.as_tensor(w, dtype=dtype, device=device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice x [..., time] into overlapping frames [..., T, frame_length]."""
    return x.unfold(-1, frame_length, hop)


def _padded_window(window: Optional[torch.Tensor], n_fft: int, win_length: int,
                   x: torch.Tensor) -> torch.Tensor:
    if window is None:
        window = hann_window(win_length, dtype=x.dtype, device=x.device)
    window = window.to(device=x.device, dtype=x.dtype)
    if win_length < n_fft:  # torch zero-pads the window symmetrically to n_fft
        left = (n_fft - win_length) // 2
        window = F.pad(window, (left, n_fft - win_length - left))
    return window


def stft_complex(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
) -> torch.Tensor:
    """Complex STFT of x [..., time] -> [..., n_freqs, T]."""
    window = _padded_window(window, n_fft, win_length, x)
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]), n_fft, hop_length=hop_length, win_length=n_fft,
        window=window, center=center, pad_mode="reflect", normalized=False,
        onesided=True, return_complex=True,
    )
    return spec.reshape(*lead, *spec.shape[-2:])


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    power: float = 1.0,
) -> torch.Tensor:
    """|STFT|^power of x [..., time] -> [..., n_freqs, T].

    The gradient of |X| at X == 0 is 0 (torch's complex abs backward uses
    sgn(0) = 0), as the JAX package's is: silent frames give exact zeros."""
    mag = stft_complex(x, n_fft, hop_length, win_length, window, center).abs()
    if power != 1.0:
        mag = mag ** power
    return mag


def num_stft_frames(time: int, n_fft: int, hop_length: int, center: bool = True) -> int:
    """Frame count for a signal of `time` samples."""
    if center:
        time = time + 2 * (n_fft // 2)
    return 1 + (time - n_fft) // hop_length
