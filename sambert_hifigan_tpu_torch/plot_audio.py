"""Offline audio plots with the port's own DSP (no librosa).

  python -m sambert_hifigan_tpu_torch.plot_audio input.wav [--output out.png]
      [--panels waveform,channels,spec_mag,spec_db,phase,mel,mel_power,mel_db,f0,energy]
      [--seconds N] [--clip-percentile 99] [--vmin-db -80] [--fmax-vis 8000]
      [--device cpu]

The counterpart of the JAX package's `scripts/plot_audio.py`, with its ten
panels, flags and defaults:

  waveform    mono waveform used for analysis
  channels    original channels with vertical offsets (stereo view)
  spec_mag    linear |STFT| with percentile-clipped vmax
  spec_db     |STFT| in dB referenced to the max, floored at --vmin-db
  phase       wrapped STFT phase in [-pi, pi]
  mel         log-mel (the model feature)
  mel_power   linear mel power with percentile-clipped vmax
  mel_db      mel power in dB referenced to the max
  f0          extracted F0 contour over voiced frames
  energy      normalized RMS frame energy

`panel_arrays` computes every panel's array on a device (`ops/stft`,
`ops/mel`, `data/features`; the file read by `data/audio.load_wav`,
resampled to the config's rate and averaged to mono); `render` draws them
with matplotlib, which only it imports.  The arrays are computed on the
CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ALL_PANELS = "waveform,channels,spec_mag,spec_db,phase,mel,mel_power,mel_db,f0,energy"
_SPEC_PANELS = {"spec_mag", "spec_db", "phase", "mel_power", "mel_db"}


def parse_panels(arg: str) -> List[str]:
    panel_arg = ALL_PANELS if arg.strip() == "all" else arg
    panels = [s.strip() for s in panel_arg.split(",") if s.strip()]
    unknown = [p for p in panels if p not in ALL_PANELS.split(",")]
    if unknown:
        raise SystemExit(f"unknown panel: {unknown[0]}")
    return panels


def panel_arrays(wav: np.ndarray, sr: int, panels: List[str], audio, device=None,
                 seconds: Optional[float] = None) -> Dict[str, object]:
    """Every requested panel's array, computed on `device`, as numpy: wav
    [channels, time] at `sr`.  Also "mono" (the analysed signal at
    audio.sample_rate), "sr" and "sr0" (the file's rate); "f0" is (f0,
    voiced)."""
    import torch

    from .data.features import extract_energy, extract_f0
    from .kernels import resolve_device
    from .ops.mel import log_mel_spectrogram, mel_filterbank, resample
    from .ops.stft import stft_complex

    device = resolve_device(device)
    if seconds is not None:
        wav = wav[:, : int(round(seconds * sr))]
    out: Dict[str, object] = {"channels": np.asarray(wav), "sr0": sr}
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    if sr != audio.sample_rate:
        x = resample(x, sr, audio.sample_rate)
        sr = audio.sample_rate
    x = x.mean(dim=0) if x.shape[0] > 1 else x[0]
    out.update(mono=x.cpu().numpy(), sr=sr)
    out["waveform"] = out["mono"]
    if _SPEC_PANELS & set(panels):
        spec = stft_complex(x, audio.n_fft, audio.hop_length, audio.win_length)
        mag = spec.abs()
        if "spec_mag" in panels:
            out["spec_mag"] = mag.cpu().numpy()
        if "spec_db" in panels:
            out["spec_db"] = (20 * torch.log10(mag / (mag.max() + 1e-10) + 1e-10)).cpu().numpy()
        if "phase" in panels:
            out["phase"] = spec.angle().cpu().numpy()
        if {"mel_power", "mel_db"} & set(panels):
            mp = mel_filterbank(audio, device).T @ mag.square()
            if "mel_power" in panels:
                out["mel_power"] = mp.cpu().numpy()
            if "mel_db" in panels:
                out["mel_db"] = (10 * torch.log10(mp / (mp.max() + 1e-12) + 1e-12)).cpu().numpy()
    if "mel" in panels:
        out["mel"] = log_mel_spectrogram(x, audio).cpu().numpy()
    if "f0" in panels:
        f0, voiced = extract_f0(x, audio)
        out["f0"] = (f0.cpu().numpy(), voiced.cpu().numpy())
    if "energy" in panels:
        out["energy"] = extract_energy(x, audio).cpu().numpy()
    return out


def render(arrays: Dict[str, object], panels: List[str], audio, output: str,
           clip_percentile: float = 99.0, vmin_db: float = -80.0,
           fmax_vis: float = 8000.0) -> str:
    """Draw the panels of `panel_arrays` into one PNG at `output`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sr, sr0 = arrays["sr"], arrays["sr0"]
    mono, channels = arrays["mono"], arrays["channels"]
    t_axis = np.arange(mono.shape[0]) / sr
    hop_t = audio.hop_length / sr
    fmax_vis = (sr / 2) if fmax_vis <= 0 else min(fmax_vis, sr / 2)
    fig, axes = plt.subplots(len(panels), 1, figsize=(12, 2.6 * len(panels)),
                             constrained_layout=True)
    if len(panels) == 1:
        axes = [axes]

    def image(ax, a, top, label, **kw):
        im = ax.imshow(a, origin="lower", aspect="auto",
                       extent=[0, a.shape[1] * hop_t, 0, top], **kw)
        ax.set_ylabel(label)
        return im

    for ax, panel in zip(axes, panels):
        a = arrays[panel]
        if panel == "waveform":
            ax.plot(t_axis, mono, linewidth=0.4)
            ax.set_title("Waveform (mono used for analysis)")
            ax.set_ylabel("amplitude")
        elif panel == "channels":
            t0 = np.arange(channels.shape[1]) / sr0
            offset = 2.2 * (np.percentile(np.abs(channels), 99) + 1e-9)
            for c in range(channels.shape[0]):
                ax.plot(t0, channels[c] + c * offset, linewidth=0.4, label=f"ch{c}")
            if channels.shape[0] > 1:
                ax.legend(loc="upper right", frameon=False)
            ax.set_title(f"Waveform ({channels.shape[0]} channel(s), offsets)")
            ax.set_ylabel("amplitude")
        elif panel == "spec_mag":
            vmax = np.percentile(a, clip_percentile)
            im = image(ax, a, sr / 2 / 1000, "kHz", vmin=0.0, vmax=vmax, cmap="magma")
            ax.set_ylim(0, fmax_vis / 1000)
            ax.set_title(f"STFT magnitude (linear, clipped @P{clip_percentile:g})")
            fig.colorbar(im, ax=ax, format="%.2f")
        elif panel == "spec_db":
            im = image(ax, a, sr / 2 / 1000, "kHz", vmin=vmin_db, vmax=0.0, cmap="magma")
            ax.set_ylim(0, fmax_vis / 1000)
            ax.set_title(f"STFT magnitude (dB re max, vmin={vmin_db:g})")
            fig.colorbar(im, ax=ax, format="%+2.0f dB")
        elif panel == "phase":
            im = image(ax, a, sr / 2 / 1000, "kHz", vmin=-np.pi, vmax=np.pi, cmap="twilight")
            ax.set_ylim(0, fmax_vis / 1000)
            ax.set_title("STFT phase (wrapped) — discarded by mel features")
            fig.colorbar(im, ax=ax, format="%.2f")
        elif panel == "mel":
            im = image(ax, a, audio.n_mels, "mel bin", cmap="magma")
            ax.set_title(f"Log-mel spectrogram ({audio.n_mels} bins) — model feature")
            fig.colorbar(im, ax=ax, format="%.1f")
        elif panel == "mel_power":
            vmax = np.percentile(a, clip_percentile)
            im = image(ax, a, audio.n_mels, "mel bin", vmin=0.0, vmax=vmax, cmap="magma")
            ax.set_title(f"Mel spectrogram (power, clipped @P{clip_percentile:g})")
            fig.colorbar(im, ax=ax, format="%.2f")
        elif panel == "mel_db":
            im = image(ax, a, audio.n_mels, "mel bin", vmin=vmin_db, vmax=0.0, cmap="magma")
            ax.set_title(f"Mel spectrogram (dB re max, vmin={vmin_db:g})")
            fig.colorbar(im, ax=ax, format="%+2.0f dB")
        elif panel == "f0":
            f0, voiced = a
            frames_t = np.arange(f0.shape[0]) * hop_t
            ax.plot(frames_t[voiced], f0[voiced], ".", markersize=2)
            ax.set_title("F0 (voiced frames)")
            ax.set_ylabel("Hz")
            ax.set_ylim(0, 650)
        elif panel == "energy":
            ax.plot(np.arange(a.shape[0]) * hop_t, a)
            ax.set_title("Frame energy (normalized RMS)")
            ax.set_ylabel("energy")
        ax.set_xlabel("time (s)")

    frame_ms = 1000.0 * audio.hop_length / sr
    fig.suptitle(
        f"sr={sr} Hz | dur={mono.shape[0] / sr:.2f}s | hop={audio.hop_length} "
        f"({frame_ms:.2f} ms/frame) | n_fft={audio.n_fft} | n_mels={audio.n_mels}"
    )
    fig.savefig(output, dpi=120)
    plt.close(fig)
    return output


def main(argv=None) -> str:
    from .config import default_config
    from .data.audio import load_wav

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input")
    p.add_argument("--output", default=None)
    p.add_argument("--panels", default="waveform,spec_db,mel,f0,energy",
                   help=f"comma list from: {ALL_PANELS} (or 'all')")
    p.add_argument("--seconds", type=float, default=None, help="only plot the first N seconds")
    p.add_argument("--clip-percentile", type=float, default=99.0,
                   help="vmax percentile for linear spectrogram panels")
    p.add_argument("--vmin-db", type=float, default=-80.0, help="floor (dB) for dB panels")
    p.add_argument("--fmax-vis", type=float, default=8000.0,
                   help="max frequency (Hz) shown on STFT panels; 0 = sr/2")
    p.add_argument("--device", type=str, default=None,
                   help="torch device for the arrays (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    audio = default_config().audio
    panels = parse_panels(args.panels)
    wav, sr = load_wav(args.input)  # [C, time]
    arrays = panel_arrays(wav, sr, panels, audio, args.device, args.seconds)
    out = args.output or str(Path(args.input).with_suffix(".png"))
    render(arrays, panels, audio, out, args.clip_percentile, args.vmin_db, args.fmax_vis)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
