"""Objective audio and mel evaluation metrics, the port of the JAX
package's `utils/eval_metrics.py`: mel-MAE (the parity criterion between
implementations), mel-cepstral distortion (MCD), their DTW-aligned forms,
multi-resolution STFT log-magnitude MAE and F0 metrics.

Every metric goes through the same log-mel op as training and the losses
(the consistency invariant).  Waveforms come in as numpy; the transforms
run on `device` (default: the card; pass device='cpu' for the CPU), the
DTW and the DCT on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..kernels import resolve_device
from ..ops.mel import log_mel_spectrogram
from ..ops.stft import stft_magnitude


def _tensor(wav: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(wav, np.float32), device=device)  # a copy: inputs may be frozen


def _log_mel(wav: np.ndarray, audio: AudioConfig, device) -> np.ndarray:
    """log-mel [n_mels, T] of wav [T], as numpy float32."""
    return log_mel_spectrogram(_tensor(wav, device), audio).cpu().numpy()


def mel_mae(wav_a: np.ndarray, wav_b: np.ndarray, audio: Optional[AudioConfig] = None,
            device=None) -> float:
    """Mean absolute error between the log-mels of two waveforms [T],
    trimmed to the shorter (a frame-aligned comparison)."""
    audio = audio or AudioConfig()
    device = resolve_device(device)
    n = min(wav_a.shape[-1], wav_b.shape[-1])
    ma = log_mel_spectrogram(_tensor(wav_a[..., :n], device), audio)
    mb = log_mel_spectrogram(_tensor(wav_b[..., :n], device), audio)
    return float((ma - mb).abs().mean())


def mel_mae_from_mels(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """MAE between two log-mel matrices (any matching shape)."""
    a, b = np.asarray(mel_a), np.asarray(mel_b)
    t = min(a.shape[-1], b.shape[-1])
    return float(np.mean(np.abs(a[..., :t] - b[..., :t])))


def _mfcc_from_log_mel(log_mel: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """DCT-II (ortho) over the mel axis -> [n_mfcc, T]; the caller drops c0."""
    n_mels, _ = log_mel.shape
    k = np.arange(n_mels)
    basis = np.cos(np.pi * (k[:, None] + 0.5) * np.arange(n_mfcc)[None, :] / n_mels)
    basis *= np.sqrt(2.0 / n_mels)
    basis[:, 0] /= np.sqrt(2.0)
    return (log_mel.T @ basis).T  # [n_mfcc, T]


def mcd(wav_a: np.ndarray, wav_b: np.ndarray, audio: Optional[AudioConfig] = None,
        n_mfcc: int = 13, device=None) -> float:
    """Mel-cepstral distortion in dB (identical audio -> 0):
    MCD = (10 / ln 10) * sqrt(2) * mean_t ||c_a[1:] - c_b[1:]||_2 on mel
    cepstra of the shared log-mel."""
    audio = audio or AudioConfig()
    device = resolve_device(device)
    n = min(wav_a.shape[-1], wav_b.shape[-1])
    # the shared op is log10; the cepstra's convention is ln
    ca = _mfcc_from_log_mel(_log_mel(wav_a[..., :n], audio, device) * np.log(10.0), n_mfcc)
    cb = _mfcc_from_log_mel(_log_mel(wav_b[..., :n], audio, device) * np.log(10.0), n_mfcc)
    dist = np.sqrt(np.sum((ca[1:] - cb[1:]) ** 2, axis=0))  # c0 (energy) dropped
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0) * np.mean(dist))


def mel_mae_dtw(wav_a: np.ndarray, wav_b: np.ndarray, audio: Optional[AudioConfig] = None,
                device=None) -> float:
    """Alignment-invariant mel-MAE: DTW over frames, then the mean |diff|
    along the optimal path.  Full TTS predicts its own durations, so a
    frame-wise comparison with the recording mixes timing drift into the
    spectral error; DTW separates them."""
    audio = audio or AudioConfig()
    device = resolve_device(device)
    return _dtw(_log_mel(wav_a, audio, device).T, _log_mel(wav_b, audio, device).T)[0]


def _dtw(ma: np.ndarray, mb: np.ndarray):
    """DTW between [T, n_mels] sequences -> (mean path cost, path_a
    indices, path_b indices).

    Row-vectorised DP (one numpy pass per reference frame), with cost rows
    computed on the fly: memory is the O(ta * tb) table plus one row."""
    ta, tb = ma.shape[0], mb.shape[0]
    acc = np.empty((ta, tb), np.float64)
    move = np.empty((ta, tb), np.int8)  # 0 = diag, 1 = up (i-1), 2 = left (j-1)
    cost0 = np.abs(ma[0][None, :] - mb).mean(-1)
    acc[0] = np.cumsum(cost0)
    move[0] = 2
    move[0, 0] = 0
    for i in range(1, ta):
        cost = np.abs(ma[i][None, :] - mb).mean(-1)  # [tb]
        prev = acc[i - 1]
        # diag (prev shifted) and up (prev); left by the running scan below
        diag = np.concatenate(([np.inf], prev[:-1]))
        best = np.where(diag <= prev, diag, prev)
        mv = np.where(diag <= prev, 0, 1).astype(np.int8)
        # left (j-1): row[j] = cost[j] + min(best[j], row[j-1]) unrolls to
        # row[j] = Cs[j] + min_{k<=j}(best[k] - Cs[k-1]), a min-plus prefix
        # scan done with cumsum and minimum.accumulate
        cs = np.cumsum(cost)
        g = best - np.concatenate(([0.0], cs[:-1]))
        gm = np.minimum.accumulate(g)
        acc[i] = gm + cs
        move[i] = np.where(gm < g, np.int8(2), mv)
    # backtrack for the mean over the optimal path
    i, j = ta - 1, tb - 1
    path_cost, steps = 0.0, 0
    pa, pb = [], []
    while True:
        path_cost += float(np.abs(ma[i] - mb[j]).mean())
        pa.append(i)
        pb.append(j)
        steps += 1
        if i == 0 and j == 0:
            break
        m = move[i, j]
        if m == 0 and i > 0 and j > 0:
            i, j = i - 1, j - 1
        elif m == 1 and i > 0:
            i -= 1
        elif j > 0:
            j -= 1
        else:
            i -= 1
    return (float(path_cost / steps), np.asarray(pa[::-1], np.int64),
            np.asarray(pb[::-1], np.int64))


def stft_logmag_mae(wav_a: np.ndarray, wav_b: np.ndarray,
                    fft_sizes: Tuple[int, ...] = (512, 1024, 2048),
                    sample_rate_hops: int = 4, device=None) -> float:
    """Multi-resolution STFT log-magnitude MAE between two waveforms [T],
    trimmed to the shorter: finer in frequency than the 80-bin mel, so it
    sees the harmonic oversmoothing a mel metric cannot; the eval-side
    counterpart of the MR-STFT training loss at the same resolutions."""
    device = resolve_device(device)
    n = min(wav_a.shape[-1], wav_b.shape[-1])
    a = _tensor(wav_a[..., :n], device)
    b = _tensor(wav_b[..., :n], device)
    vals = []
    for n_fft in fft_sizes:
        hop = n_fft // sample_rate_hops
        ma = torch.log(stft_magnitude(a, n_fft, hop, n_fft) + 1e-5)
        mb = torch.log(stft_magnitude(b, n_fft, hop, n_fft) + 1e-5)
        vals.append(float((ma - mb).abs().mean()))
    return float(np.mean(vals))


def _f0(wav: np.ndarray, audio: AudioConfig, device):
    from ..data.features import extract_f0

    f0, voiced = extract_f0(_tensor(wav, device), audio)
    return f0.cpu().numpy(), voiced.cpu().numpy()


def f0_metrics(wav_ref: np.ndarray, wav_syn: np.ndarray,
               audio: Optional[AudioConfig] = None, device=None) -> dict:
    """Periodicity-sensitive vocoder metrics, frame by frame (trimmed to the
    shorter waveform): f0_rmse_hz, the RMSE of autocorrelation F0 over
    frames voiced in both, and voicing_f1, the F1 of the synthetic voicing
    decision against the reference's.  The same `extract_f0` as the
    training features, band [80, 600] Hz."""
    audio = audio or AudioConfig()
    device = resolve_device(device)
    n = min(wav_ref.shape[-1], wav_syn.shape[-1])
    f0_r, v_r = _f0(wav_ref[..., :n], audio, device)
    f0_s, v_s = _f0(wav_syn[..., :n], audio, device)
    return _f0_compare(f0_r, f0_s, v_r, v_s)


def _f0_compare(f0_r: np.ndarray, f0_s: np.ndarray, v_r: np.ndarray, v_s: np.ndarray) -> dict:
    """F0-RMSE over frames voiced on both sides and voicing-decision F1,
    shared by the frame-wise and DTW-aligned variants."""
    both = v_r & v_s
    rmse = float(np.sqrt(np.mean((f0_r[both] - f0_s[both]) ** 2))) if both.any() else float("nan")
    tp = float(both.sum())
    prec = tp / max(float(v_s.sum()), 1.0)
    rec = tp / max(float(v_r.sum()), 1.0)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"f0_rmse_hz": rmse, "voicing_f1": float(f1)}


def f0_metrics_dtw(wav_ref: np.ndarray, wav_syn: np.ndarray,
                   audio: Optional[AudioConfig] = None, device=None) -> dict:
    """Alignment-invariant F0 metrics for full TTS: frames paired along the
    same mel-DTW path as mel_mae_dtw, then compared as f0_metrics does."""
    audio = audio or AudioConfig()
    device = resolve_device(device)
    _, pa, pb = _dtw(_log_mel(wav_ref, audio, device).T, _log_mel(wav_syn, audio, device).T)
    f0_r, v_r = _f0(wav_ref, audio, device)
    f0_s, v_s = _f0(wav_syn, audio, device)
    # F0 frames share the mel hop; clamp the path to the shorter F0 track
    pa = np.clip(pa, 0, len(f0_r) - 1)
    pb = np.clip(pb, 0, len(f0_s) - 1)
    return _f0_compare(f0_r[pa], f0_s[pb], v_r[pa], v_s[pb])
