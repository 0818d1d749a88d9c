"""Text frontend: pseudo-G2P (reference: models/frontend.py).

Deterministic char-level tokenizer standing in for a real TN/G2P stack
(the reference says so itself, models/frontend.py:39-42).  Behavioral
contract, reproduced exactly (reference tests/test_frontend.py):

  * PAD=0, UNK=1, BOS=2, EOS=3 (models/frontend.py:56-59)
  * char -> phoneme id: ord(c) % (vocab_size - 4) + 4; ' ' -> PAD
    (models/frontend.py:74-90)
  * char -> tone id: ord(c) % (tone_size - 1) + 1; ' ' -> 0
    (models/frontend.py:92-106)
  * boundary by position: 1 begin / 2 middle / 3 end / 4 single-char;
    BOS gets boundary 1, EOS gets 3 (models/frontend.py:108-133, 152-169)
  * text stripped; empty text -> ([BOS, EOS], [0, 0], [1, 3])
    (models/frontend.py:145-150)
  * batch_forward right-pads every stream with 0 (models/frontend.py:242-247)

This layer is host-side Python/numpy (no torch, no jax): it feeds int32
arrays into the model.  `pad_to` supports the bucket contract.  A copy of
the JAX package's frontend, kept so the port imports nothing from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
UNK_ID = 1
BOS_ID = 2
EOS_ID = 3


@dataclass
class LinguisticFeature:
    """(reference: models/frontend.py:20-32)"""

    ph_ids: np.ndarray  # [B, Tph] int32
    tone_ids: np.ndarray  # [B, Tph] int32
    boundary_ids: np.ndarray  # [B, Tph] int32
    lengths: np.ndarray  # [B] int32 true (unpadded) lengths

    @property
    def phoneme_mask(self) -> np.ndarray:
        """[B, Tph] bool, True for valid positions."""
        t = self.ph_ids.shape[1]
        return np.arange(t)[None, :] < self.lengths[:, None]


class FrontEnd:
    def __init__(
        self, vocab_size: int = 300, tone_size: int = 10, boundary_size: int = 5
    ):
        self.vocab_size = vocab_size
        self.tone_size = tone_size
        self.boundary_size = boundary_size
        self.PAD_ID = PAD_ID
        self.UNK_ID = UNK_ID
        self.BOS_ID = BOS_ID
        self.EOS_ID = EOS_ID

    def _char_to_ph_id(self, char: str) -> int:
        if char == " ":
            return PAD_ID
        return (ord(char) % (self.vocab_size - 4)) + 4

    def _char_to_tone_id(self, char: str) -> int:
        if char == " ":
            return 0
        return (ord(char) % (self.tone_size - 1)) + 1

    def _char_to_boundary_id(self, idx: int, text_len: int) -> int:
        if text_len == 1:
            return 4
        if idx == 0:
            return 1
        if idx == text_len - 1:
            return 3
        return 2

    def text_to_sequence(self, text: str) -> Tuple[List[int], List[int], List[int]]:
        text = text.strip()
        if len(text) == 0:
            return [BOS_ID, EOS_ID], [0, 0], [1, 3]
        ph_ids = [BOS_ID]
        tone_ids = [0]
        boundary_ids = [1]
        for idx, char in enumerate(text):
            ph_ids.append(self._char_to_ph_id(char))
            tone_ids.append(self._char_to_tone_id(char))
            boundary_ids.append(self._char_to_boundary_id(idx, len(text)))
        ph_ids.append(EOS_ID)
        tone_ids.append(0)
        boundary_ids.append(3)
        return ph_ids, tone_ids, boundary_ids

    def __call__(
        self, text: str, batch_size: int = 1, pad_to: Optional[int] = None
    ) -> LinguisticFeature:
        """Single text -> [batch_size, Tph] features
        (reference: models/frontend.py:173-209)."""
        ph, tone, bound = self.text_to_sequence(text)
        n = len(ph)
        t = pad_to or n
        if n > t:
            raise ValueError(f"sequence length {n} exceeds pad_to {t}")

        def mk(seq):
            arr = np.zeros((batch_size, t), np.int32)
            arr[:, :n] = np.asarray(seq, np.int32)[None, :]
            return arr

        return LinguisticFeature(
            ph_ids=mk(ph),
            tone_ids=mk(tone),
            boundary_ids=mk(bound),
            lengths=np.full((batch_size,), n, np.int32),
        )

    forward = __call__

    def batch_forward(
        self, texts: Sequence[str], pad_to: Optional[int] = None
    ) -> LinguisticFeature:
        """Batch with right-padding (reference: models/frontend.py:211-265)."""
        seqs = [self.text_to_sequence(t) for t in texts]
        lengths = np.asarray([len(s[0]) for s in seqs], np.int32)
        t = pad_to or int(lengths.max())
        if int(lengths.max()) > t:
            raise ValueError(f"longest sequence {lengths.max()} exceeds pad_to {t}")
        b = len(texts)
        ph = np.zeros((b, t), np.int32)
        tone = np.zeros((b, t), np.int32)
        bound = np.zeros((b, t), np.int32)
        for i, (p, to, bo) in enumerate(seqs):
            ph[i, : len(p)] = p
            tone[i, : len(to)] = to
            bound[i, : len(bo)] = bo
        return LinguisticFeature(ph, tone, bound, lengths)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (static-shape padding target)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {max(buckets)}")
