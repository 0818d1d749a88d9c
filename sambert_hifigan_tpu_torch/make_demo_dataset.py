"""Write a deterministic synthetic speech-like corpus for training demos.

  python -m sambert_hifigan_tpu_torch.make_demo_dataset --output data/demo [--n 64] [--seed 0]
  python -m sambert_hifigan_tpu_torch.make_demo_dataset --output data/demo_v2 --n 384 \\
      --speaker-var 1.0     # a varied corpus for adversarial training

The counterpart of the JAX package's `scripts/make_demo_dataset.py`, numpy
only, with its draws: for the same --n, --seed and --speaker-var both write
the same bytes (wavs through the port's `data/audio.save_wav`, and
metadata.csv).

Every character's acoustic realization (duration 90-270 ms, F0 110-220 Hz,
harmonic or fricative timbre, amplitude) is a pure function of the
character, so text predicts the audio: the CTC aligner has boundaries to
find and the duration, pitch and energy predictors have structure to learn.
Four characters make a word, and words are separated by 50 ms pauses.
--speaker-var > 0 adds per-utterance "speaker" variation (F0 scale,
brightness, amplitude, noise floor), so that real crops do not repeat and
the discriminators keep giving useful gradients.  Output: metadata.csv
(`wav_path|text` per line, the layout TTSDataset reads) and 16-bit PCM wavs
at 22.05 kHz.  The corpus is not speech; it has speech's statistical
interface.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

SR = 22050
# a small alphabet, so that a 64-utterance corpus sees every character many times
ALPHABET = "你好世界天地人山水火风雨花鸟虫鱼春夏秋冬东南西北"


def char_params(c: str) -> dict:
    """Deterministic per-character acoustics (same character, same sound)."""
    o = ord(c)
    return {
        "dur_s": 0.09 + (o % 7) * 0.03,  # 90-270 ms
        "voiced": (o % 5) != 0,
        "f0": 110.0 * 2.0 ** ((o % 13) / 12.0),  # 110-220 Hz
        "amp": 0.35 + 0.45 * (((o // 7) % 5) / 4.0),
        "bright": 0.3 + 0.7 * (((o // 3) % 4) / 3.0),  # harmonic rolloff
    }


def speaker_params(rng: np.random.Generator, amount: float) -> dict:
    """Per-utterance 'speaker': smooth multiplicative deviations from the
    per-character defaults, scaled by `amount` (0 = one fixed voice)."""
    return {
        "f0_scale": 2.0 ** (amount * rng.uniform(-0.35, 0.35)),
        "bright_scale": 1.0 + amount * rng.uniform(-0.35, 0.35),
        "amp_scale": 1.0 + amount * rng.uniform(-0.25, 0.25),
        "noise_floor": amount * rng.uniform(0.0, 0.02),
    }


_NO_SPEAKER = {"f0_scale": 1.0, "bright_scale": 1.0, "amp_scale": 1.0, "noise_floor": 0.0}


def render_char(c: str, spk: dict = _NO_SPEAKER) -> np.ndarray:
    p = char_params(c)
    p = dict(
        p,
        f0=min(p["f0"] * spk["f0_scale"], 580.0),
        bright=float(np.clip(p["bright"] * spk["bright_scale"], 0.15, 1.0)),
        amp=float(np.clip(p["amp"] * spk["amp_scale"], 0.1, 0.95)),
    )
    n = int(round(p["dur_s"] * SR))
    t = np.arange(n) / SR
    if p["voiced"]:
        # a harmonic stack with mild vibrato; rolloff set by the brightness
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.5 * t)
        phase = 2 * np.pi * np.cumsum(p["f0"] * vib) / SR
        x = np.zeros(n)
        for k in range(1, 7):
            x += (p["bright"] ** (k - 1) / k) * np.sin(k * phase)
        x /= np.max(np.abs(x)) + 1e-9
    else:
        # a fricative: character-seeded band-shaped noise
        rng = np.random.default_rng(ord(c))
        x = rng.standard_normal(n)
        x = np.convolve(x, np.ones(5) / 5.0, mode="same")  # a crude lowpass
        x /= np.max(np.abs(x)) + 1e-9
        x *= 0.6
    # 15 ms raised-cosine fades: no clicks at segment joins
    f = min(int(0.015 * SR), n // 2)
    env = np.ones(n)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(f) / f)
    env[:f] = ramp
    env[-f:] = ramp[::-1]
    return (p["amp"] * env * x).astype(np.float32)


def render_text(text: str, spk: dict = _NO_SPEAKER,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    segs = []
    for i, c in enumerate(text):
        segs.append(render_char(c, spk))
        if (i + 1) % 4 == 0 and i + 1 < len(text):
            segs.append(np.zeros(int(0.05 * SR), dtype=np.float32))  # a pause
    wav = np.concatenate(segs)
    if spk["noise_floor"] > 0 and rng is not None:
        wav = wav + spk["noise_floor"] * rng.standard_normal(len(wav)).astype(np.float32)
    return wav.astype(np.float32)


def make_demo_dataset(output, n: int = 64, seed: int = 0, speaker_var: float = 0.0,
                      verbose: bool = True) -> Path:
    """Write the corpus under `output`; returns the path of its metadata.csv."""
    from .data.audio import save_wav

    out = Path(output)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    total_s = 0.0
    for i in range(n):
        length = int(rng.integers(4, 11))
        text = "".join(rng.choice(list(ALPHABET), size=length))
        spk = speaker_params(rng, speaker_var)
        wav = render_text(text, spk, rng)
        rel = f"wavs/utt_{i:04d}.wav"
        save_wav(out / rel, wav, SR)
        lines.append(f"{rel}|{text}")
        total_s += len(wav) / SR
    meta = out / "metadata.csv"
    meta.write_text("\n".join(lines) + "\n", encoding="utf-8")
    if verbose:
        print(f"wrote {n} utterances ({total_s:.1f}s audio) to {out}")
    return meta


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--output", type=str, default="data/demo")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speaker-var", type=float, default=0.0,
                    help="per-utterance voice variation amount (0 = off)")
    args = ap.parse_args(argv)
    return make_demo_dataset(args.output, args.n, args.seed, args.speaker_var)


if __name__ == "__main__":
    main()
