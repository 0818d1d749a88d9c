"""Frozen copy of the system's text front end and its bucket rules.

Text -> (phoneme, tone, boundary) ids: BOS=2, one id per character
(ord % (vocab - 4) + 4; a space is PAD=0), EOS=3; tones ord % (tone - 1) + 1
(0 for a space, BOS and EOS); boundaries 1 begin / 2 middle / 3 end / 4 a
single character, BOS 1 and EOS 3.  Rows are right-padded with 0 to a
phoneme bucket.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

BOS, EOS = 2, 3


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {max(buckets)}")


def text_ids(text: str, vocab: int, tones: int) -> Tuple[List[int], List[int], List[int]]:
    text = text.strip()
    n = len(text)
    ph, tone, bound = [BOS], [0], [1]
    for i, ch in enumerate(text):
        ph.append(0 if ch == " " else ord(ch) % (vocab - 4) + 4)
        tone.append(0 if ch == " " else ord(ch) % (tones - 1) + 1)
        bound.append(4 if n == 1 else 1 if i == 0 else 3 if i == n - 1 else 2)
    return ph + [EOS], tone + [0], bound + [3]


def batch_ids(texts: Sequence[str], vocab: int, tones: int, pad_to: int):
    """[B, pad_to] int64 arrays (ph, tone, boundary) and the [B] lengths."""
    b = len(texts)
    arrs = [np.zeros((b, pad_to), np.int64) for _ in range(3)]
    lengths = np.zeros(b, np.int64)
    for i, text in enumerate(texts):
        seqs = text_ids(text, vocab, tones)
        lengths[i] = len(seqs[0])
        for arr, seq in zip(arrs, seqs):
            arr[i, :len(seq)] = seq
    return (*arrs, lengths)


def phoneme_count(text: str) -> int:
    return len(text.strip()) + 2


def initial_frames(tph: int, c: dict, duration_scale: float = 1.0) -> int:
    """The frame bucket the system decodes first: 12 frames a phoneme of
    the phoneme bucket, clamped into the frame buckets."""
    buckets = c["frame_buckets"]
    return pick_bucket(min(int(tph * 12 * max(duration_scale, 1.0)), max(buckets)), buckets)


def refit_frames(need: int, frames: int, c: dict) -> int:
    """After a first pass that needs `need` frames: the bucket of the one
    re-run, or `frames` when it fits or is already the largest."""
    buckets = c["frame_buckets"]
    if need > frames and frames < max(buckets):
        return pick_bucket(min(need, max(buckets)), buckets)
    return frames
