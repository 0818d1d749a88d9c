"""Host-side audio IO (numpy and the standard library only): WAV read and
write (PCM 8/16/24/32-bit and float32, mono or multi-channel) and the .npy
mel files of preprocessing."""

from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def load_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (waveform [channels, time] float32 in [-1, 1], sr)."""
    path = str(path)
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if chunk_id == b"fmt ":
                fmt = payload
            elif chunk_id == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr = struct.unpack("<HHI", fmt[:8])
    bits = struct.unpack("<H", fmt[14:16])[0]
    if audio_format == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, "<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}")
    x = x.reshape(-1, channels).T  # [channels, time]
    return np.ascontiguousarray(x), sr


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


def save_mel(mel: np.ndarray, output_path: Union[str, Path]) -> None:
    """Write a mel array as .npy, creating the parent directory."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(output_path, np.asarray(mel))


def load_mel(mel_path: Union[str, Path]) -> np.ndarray:
    """Read a .npy mel as float32."""
    return np.load(mel_path).astype(np.float32)
