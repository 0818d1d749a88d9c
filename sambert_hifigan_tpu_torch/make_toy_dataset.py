"""Write a small synthetic-speech corpus, for training runs with no data to
download.

  python -m sambert_hifigan_tpu_torch.make_toy_dataset --out data/toy --n 32 [--seed 0]

Writes out/wavs/utt_NNNN.wav (16-bit, 22.05 kHz) and out/metadata.csv
(`wav_path|text` per line).  The corpus has the structure TTS training
needs:

  * each phoneme id maps to a fixed "vowel" (a two-formant harmonic tone)
    or "consonant" (a shaped noise burst), so mel frames follow from the
    phoneme;
  * pitch contours vary per utterance (declination and vibrato),
    durations per phoneme (log-normal), and word boundaries insert short
    silences, so the duration, pitch and energy predictors get real
    targets;
  * texts are drawn from a small character alphabet through the front end.

Numpy only, with the draws of the JAX package's scripts/make_toy_dataset.py:
from the same seed both write the same bytes.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SR = 22050
# a small repeating "alphabet", so that every phoneme id is seen many times
ALPHABET = "的一是了我不人在他有这上们来到时大地为子中你说生国年着就那"


def phoneme_prototype(ph_id: int):
    """Deterministic acoustic identity of a phoneme id."""
    if ph_id % 3 != 0:
        return ("vowel", 300.0 + (ph_id * 37 % 500), 900.0 + (ph_id * 61 % 1600))
    return ("noise", 1500.0 + (ph_id * 97 % 4000), 300.0 + (ph_id * 13 % 900))


def synth_phoneme(kind_params, n: int, f0: np.ndarray, rng) -> np.ndarray:
    kind, a, b = kind_params
    t = np.arange(n) / SR
    env = np.minimum(1.0, np.minimum(np.arange(n), n - 1 - np.arange(n)) / (0.01 * SR))
    if kind == "vowel":
        phase = 2 * np.pi * np.cumsum(f0) / SR
        sig = 0.5 * np.sin(phase)
        sig += 0.3 * np.sin(2 * phase) * np.sin(2 * np.pi * a * t)
        sig += 0.2 * np.sin(3 * phase) * np.sin(2 * np.pi * b * t)
        sig += 0.25 * np.sin(2 * np.pi * a * t) + 0.15 * np.sin(2 * np.pi * b * t)
    else:
        noise = rng.standard_normal(n)
        # crude band-pass: white noise smoothed, then moved to the centre frequency
        lp = np.convolve(noise, np.ones(8) / 8, mode="same")
        sig = 0.4 * lp * np.cos(2 * np.pi * a * t)
    return (sig * env).astype(np.float32)


def synth_utterance(text: str, rng) -> np.ndarray:
    from .text.frontend import FrontEnd

    ph, tone, _ = FrontEnd().text_to_sequence(text)
    base_f0 = rng.uniform(140, 260)
    pieces = [np.zeros(int(0.05 * SR), np.float32)]  # BOS silence
    for i, (p, tn) in enumerate(zip(ph[1:-1], tone[1:-1])):
        dur_s = float(np.exp(rng.normal(np.log(0.12), 0.35)))
        n = int(min(max(dur_s, 0.05), 0.4) * SR)
        # pitch: per-tone offset, utterance declination, vibrato
        f0 = base_f0 * (1.0 + 0.08 * tn) * (1.0 - 0.02 * i)
        f0_curve = f0 * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * np.arange(n) / SR))
        pieces.append(synth_phoneme(phoneme_prototype(int(p)), n, f0_curve, rng))
        if rng.random() < 0.15:  # an occasional word-boundary pause
            pieces.append(np.zeros(int(0.04 * SR), np.float32))
    pieces.append(np.zeros(int(0.05 * SR), np.float32))  # EOS silence
    wav = np.concatenate(pieces)
    wav = 0.8 * wav / (np.abs(wav).max() + 1e-6)
    return wav.astype(np.float32)


def make_toy_dataset(out, n: int = 32, seed: int = 0, min_chars: int = 4,
                     max_chars: int = 12, verbose: bool = True) -> Path:
    """Write the corpus under `out`; returns the path of its metadata.csv."""
    from .data.audio import save_wav

    rng = np.random.default_rng(seed)
    out = Path(out)
    (out / "wavs").mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        n_chars = int(rng.integers(min_chars, max_chars + 1))
        text = "".join(rng.choice(list(ALPHABET), n_chars))
        wav = synth_utterance(text, rng)
        rel = f"wavs/utt_{i:04d}.wav"
        save_wav(str(out / rel), wav, SR)
        lines.append(f"{rel}|{text}")
        if verbose:
            print(f"[{i + 1}/{n}] {rel}: {len(wav) / SR:.2f}s  '{text}'")
    meta = out / "metadata.csv"
    meta.write_text("\n".join(lines) + "\n", encoding="utf-8")
    if verbose:
        print(f"wrote {n} utterances under {out}")
    return meta


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--min-chars", type=int, default=4)
    p.add_argument("--max-chars", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    return make_toy_dataset(args.out, args.n, args.seed, args.min_chars, args.max_chars)


if __name__ == "__main__":
    main()
