"""Host-side WAV output (numpy and the standard library only)."""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Union

import numpy as np


def save_wav(path: Union[str, Path], waveform: np.ndarray, sample_rate: int) -> None:
    """Write mono/stereo float32 [-1, 1] (shape [time] or [channels, time]) as
    16-bit PCM."""
    x = np.asarray(waveform, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    x = np.clip(x, -1.0, 1.0)
    pcm = (x.T * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
