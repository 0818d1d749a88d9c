"""Dataset and static-shape batching, the port of the JAX package's
`data/dataset.py`.

Format: one `wav_path|text` pair per line of metadata.csv, LJSpeech-style.

Every batch is padded to a (phoneme bucket, frame bucket) pair from the
config; masks carry the true lengths.  Features (log-mel, F0, energy,
durations) are extracted with the same ops the losses use (the
mel-consistency invariant) on the dataset's device, returned as numpy, and
cached as .npz under the same key and field names as the JAX package's, so
a corpus preprocessed by either package loads in the other.  A cache file
is written whole or not at all (`save_npz_atomic`): ranks of a process
group that extract the same utterance at once each write their own
temporary file and rename it into place.

Entry points:
  TTSDataset       — files on disk, feature cache, bucketed batch iterator
  synthetic_batch  — deterministic in-memory batch for tests and smoke runs
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TTSConfig
from ..kernels import resolve_device
from ..ops.mel import log_mel_spectrogram, resample
from ..text.frontend import FrontEnd, pick_bucket
from .audio import load_wav
from .features import extract_energy, extract_f0, uniform_durations


def save_npz_atomic(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    """np.savez to a temporary file beside `path` (named `<key>.<pid>.tmp.npz`:
    savez appends .npz to a name without it), then os.replace onto `path`."""
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


@dataclass
class Utterance:
    wav_path: str
    text: str


def read_metadata(path: str) -> List[Utterance]:
    """Parse metadata.csv: `wav_path|text` per line; blank lines and lines
    starting with '#' are skipped."""
    utts = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("|", 1)
            if len(parts) != 2:
                raise ValueError(f"malformed metadata line: {line!r}")
            utts.append(Utterance(wav_path=parts[0], text=parts[1]))
    return utts


def _reflect_pad_to(x: np.ndarray, target: int) -> np.ndarray:
    """Right-pad 1-D x to `target` samples by repeated edge-free reflection
    (numpy 'reflect' caps each application at len - 1 samples)."""
    while x.shape[-1] < target:
        pad = min(target - x.shape[-1], x.shape[-1] - 1)
        if pad <= 0:  # degenerate 1-sample signal
            return np.pad(x, (0, target - x.shape[-1]))
        x = np.pad(x, (0, pad), mode="reflect")
    return x


class TTSDataset:
    """Loads wavs, extracts and caches features, serves static-shape
    batches.  Features are extracted on `device` (default: the card; pass
    device='cpu' for the CPU) and handed out as numpy."""

    def __init__(
        self,
        metadata_path: str,
        cfg: TTSConfig,
        root: Optional[str] = None,
        cache_dir: Optional[str] = None,
        device=None,
    ):
        self.cfg = cfg
        self.audio = cfg.audio
        self.device = resolve_device(device)
        self.root = Path(root) if root else Path(metadata_path).parent
        self.utterances = read_metadata(metadata_path)
        fe = cfg.acoustic_model.frontend
        self.frontend = FrontEnd(fe.vocab_size, fe.tone_size, fe.boundary_size)
        self.cache_dir = Path(cache_dir) if cache_dir else self.root / "feature_cache"
        # An in-memory memo over the disk cache: the trainers load every
        # utterance of a batch at every step, and an npz read each time
        # holds the loop up.  Byte-bounded (SAMBERT_MEM_CACHE_MB, default
        # 1024); once full, later utterances keep coming from the disk cache.
        self._mem_cache: Dict[str, Dict[str, np.ndarray]] = {}
        self._mem_bytes = 0
        self._mem_limit = int(os.environ.get("SAMBERT_MEM_CACHE_MB", "1024")) << 20

    def _memoize(self, utt: Utterance, feats: Dict[str, np.ndarray],
                 replace: bool = False) -> None:
        if replace and utt.wav_path in self._mem_cache:
            self._mem_bytes -= sum(v.nbytes for v in self._mem_cache.pop(utt.wav_path).values())
        nbytes = sum(v.nbytes for v in feats.values())
        if self._mem_bytes + nbytes <= self._mem_limit:
            # frozen: memo entries are shared by every caller, so an in-place
            # change would silently poison later reads
            for v in feats.values():
                v.flags.writeable = False
            self._mem_cache[utt.wav_path] = feats
            self._mem_bytes += nbytes

    def __len__(self) -> int:
        return len(self.utterances)

    # ---- feature extraction -------------------------------------------------

    def _extract_features(self, wav: torch.Tensor):
        mel = log_mel_spectrogram(wav, self.audio)  # [n_mels, T]
        f0, voiced = extract_f0(wav, self.audio)
        # raw RMS here; load_features normalises after slicing to the true
        # frame count, so the [0, 1] peak is over real frames, not padding
        energy = extract_energy(wav, self.audio, normalize=False)
        return mel, f0, voiced, energy

    def _cache_key(self, utt: Utterance) -> Path:
        h = hashlib.sha1(
            (utt.wav_path + repr(dataclasses.astuple(self.audio))).encode()
        ).hexdigest()[:16]
        return self.cache_dir / f"{Path(utt.wav_path).stem}_{h}.npz"

    def _read_wav(self, path) -> tuple:
        """The native C++ decode where it builds; the numpy reader, which
        gives the same bits, otherwise."""
        from .native_loader import load_wav_native, native_available

        if native_available():
            try:
                return load_wav_native(path)
            except (ValueError, RuntimeError):
                pass
        return load_wav(path)

    def load_features(self, utt: Utterance) -> Dict[str, np.ndarray]:
        mem = self._mem_cache.get(utt.wav_path)
        if mem is not None:
            return dict(mem)  # a shallow copy; the arrays themselves are frozen
        cache = self._cache_key(utt)
        if cache.exists():
            with np.load(cache) as z:
                feats = {k: z[k] for k in z.files}
            self._memoize(utt, feats)
            return feats
        wav, sr = self._read_wav(self.root / utt.wav_path)
        if sr != self.audio.sample_rate:
            wav = resample(torch.from_numpy(wav).to(self.device), sr,
                           self.audio.sample_rate).cpu().numpy()
        wav_mono = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
        # Pad the waveform to a length bucket, as the JAX package does (there
        # so that its jitted extraction compiles once per bucket): reflect
        # padding reproduces the samples the centred STFT's own tail
        # reflection would see, so every true frame matches unpadded
        # extraction up to rounding, PROVIDED the pad is at least half a
        # window; with less, the last true frame's window crosses the padded
        # signal's edge, where the STFT reflects already-reflected samples.
        n_true = wav_mono.shape[-1]
        n_frames = n_true // self.audio.hop_length + 1
        bucket = self.audio.hop_length * 64
        half_win = max(self.audio.n_fft, self.audio.win_length) // 2
        target = -(-(n_true + half_win) // bucket) * bucket
        padded = torch.from_numpy(_reflect_pad_to(wav_mono, target)).to(self.device)
        mel, f0, voiced, energy = (t[..., :n_frames].cpu().numpy()
                                   for t in self._extract_features(padded))
        rms = energy.astype(np.float32)
        ph, tone, bound = self.frontend.text_to_sequence(utt.text)
        feats = {
            "mel": np.asarray(mel, np.float32).T,  # [T, n_mels]
            "f0": np.asarray(f0, np.float32),
            "voiced": np.asarray(voiced, bool),
            "energy": rms / (rms.max() + 1e-8),
            "ph_ids": np.asarray(ph, np.int32),
            "tone_ids": np.asarray(tone, np.int32),
            "boundary_ids": np.asarray(bound, np.int32),
            "dur": uniform_durations(len(ph), n_frames),
            "wav": wav_mono.astype(np.float32),
        }
        cache.parent.mkdir(parents=True, exist_ok=True)
        save_npz_atomic(cache, feats)
        self._memoize(utt, feats)
        return feats

    # ---- alignment ------------------------------------------------------------

    def compute_alignments(
        self,
        steps: int = 400,
        batch_size: int = 8,
        seed: int = 0,
        verbose: bool = False,
        **aligner,
    ) -> List[float]:
        """Replace the uniform-duration bootstrap with learned forced
        alignments: train the corpus CTC aligner (data/aligner.py) on the
        dataset's device, Viterbi-align every utterance, and rewrite the
        cached `dur` arrays.  `aligner` passes on train_ctc_aligner's
        d_model, n_layers and learning_rate.  Returns the loss history."""
        from .aligner import ctc_durations, train_ctc_aligner

        feats = [self.load_features(u) for u in self.utterances]
        samples = [(f["mel"], f["ph_ids"]) for f in feats]
        net, losses = train_ctc_aligner(
            samples, vocab_size=self.cfg.acoustic_model.frontend.vocab_size,
            n_mels=self.audio.n_mels, steps=steps, batch_size=batch_size, seed=seed,
            device=self.device, **aligner,
        )
        for utt, f in zip(self.utterances, feats):
            dur = ctc_durations(net, f["mel"], f["ph_ids"])
            if dur.sum() != f["mel"].shape[0] or (dur < 1).any():
                raise ValueError(
                    f"{utt.wav_path}: aligner durations {dur.tolist()} break the contract "
                    f"(sum {int(dur.sum())}, {f['mel'].shape[0]} frames, each >= 1)"
                )
            f = dict(f, dur=dur.astype(np.int32))
            save_npz_atomic(self._cache_key(utt), f)
            self._memoize(utt, f, replace=True)
            if verbose:
                print(f"[align] {utt.wav_path}: dur={dur.tolist()}")
        return losses

    # ---- batching ------------------------------------------------------------

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """One shuffled epoch of acoustic-model batches padded to the
        config's buckets."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.utterances))
        ph_buckets = self.cfg.runtime.phoneme_buckets
        frm_buckets = self.cfg.runtime.frame_buckets
        for i in range(0, len(order) - (batch_size - 1 if drop_remainder else 0), batch_size):
            idx = order[i: i + batch_size]
            feats = [self.load_features(self.utterances[j]) for j in idx]
            yield collate_acoustic(feats, ph_buckets, frm_buckets)


def collate_acoustic(
    feats: Sequence[Dict[str, np.ndarray]],
    ph_buckets: Sequence[int],
    frm_buckets: Sequence[int],
) -> Dict[str, np.ndarray]:
    """Pad a list of utterance features to shared static buckets."""
    b = len(feats)
    tph = pick_bucket(max(len(f["ph_ids"]) for f in feats), ph_buckets)
    tfrm = pick_bucket(max(f["mel"].shape[0] for f in feats), frm_buckets)
    n_mels = feats[0]["mel"].shape[1]
    out = {
        "ph_ids": np.zeros((b, tph), np.int32),
        "tone_ids": np.zeros((b, tph), np.int32),
        "boundary_ids": np.zeros((b, tph), np.int32),
        "dur_gt": np.zeros((b, tph), np.int32),
        "mel_gt": np.zeros((b, tfrm, n_mels), np.float32),
        "pitch_gt": np.zeros((b, tfrm), np.float32),
        "energy_gt": np.zeros((b, tfrm), np.float32),
        "phoneme_mask": np.zeros((b, tph), bool),
        "pitch_mask": np.zeros((b, tfrm), bool),
        "frame_lengths": np.zeros((b,), np.int32),
    }
    for i, f in enumerate(feats):
        np_ = len(f["ph_ids"])
        nf = f["mel"].shape[0]
        out["ph_ids"][i, :np_] = f["ph_ids"]
        out["tone_ids"][i, :np_] = f["tone_ids"]
        out["boundary_ids"][i, :np_] = f["boundary_ids"]
        out["dur_gt"][i, :np_] = f["dur"]
        out["mel_gt"][i, :nf] = f["mel"]
        out["pitch_gt"][i, :nf] = f["f0"]
        out["energy_gt"][i, :nf] = f["energy"]
        out["phoneme_mask"][i, :np_] = True
        out["pitch_mask"][i, :nf] = f["voiced"]
        out["frame_lengths"][i] = nf
    return out


def vocoder_batches_from_dataset(
    ds: TTSDataset,
    batch_size: int,
    segment_frames: int = 32,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of vocoder training pairs: random fixed-length (mel
    segment, wav segment) crops, the HiFi-GAN recipe.  Utterances shorter
    than segment_frames + 1 frames are skipped.

    Yields (mel [B, n_mels, segment_frames], wav [B, 1, segment_frames * hop])."""
    rng = np.random.default_rng(seed)
    hop = ds.audio.hop_length
    order = rng.permutation(len(ds.utterances))
    mels, wavs = [], []
    for j in order:
        f = ds.load_features(ds.utterances[j])
        mel = f["mel"]  # [T, n_mels]
        wav = f["wav"]
        t = mel.shape[0]
        if t < segment_frames + 1:
            continue
        start = int(rng.integers(0, t - segment_frames))
        mel_seg = mel[start: start + segment_frames].T  # [n_mels, seg]
        wav_seg = wav[start * hop: (start + segment_frames) * hop]
        if wav_seg.shape[0] < segment_frames * hop:
            wav_seg = np.pad(wav_seg, (0, segment_frames * hop - wav_seg.shape[0]))
        mels.append(mel_seg)
        wavs.append(wav_seg[None, :])
        if len(mels) == batch_size:
            yield np.stack(mels).astype(np.float32), np.stack(wavs).astype(np.float32)
            mels, wavs = [], []


def epochs(epoch: Callable[[int], Iterable]) -> Iterator:
    """Endless batches: epoch(0), then epoch(1), ...  Raises if an epoch
    gives no batch (a corpus smaller than one batch, or no utterance long
    enough for a crop), where the loop would otherwise spin forever."""
    for n in itertools.count():
        empty = True
        for batch in epoch(n):
            empty = False
            yield batch
        if empty:
            raise ValueError("the corpus gives no batch: fewer utterances than the batch size, "
                             "or none long enough for a vocoder crop")


def synthetic_batch(
    cfg: TTSConfig, batch: int = 4, tph: int = 16, tfrm: int = 64, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Deterministic random acoustic batch honoring all invariants
    (sum(dur) <= tfrm, masks consistent).  For tests and smoke training."""
    rng = np.random.default_rng(seed)
    fe = cfg.acoustic_model.frontend
    dur = rng.integers(1, max(2, tfrm // tph), (batch, tph)).astype(np.int32)
    totals = dur.sum(axis=1)
    return {
        "ph_ids": rng.integers(4, fe.vocab_size, (batch, tph)).astype(np.int32),
        "tone_ids": rng.integers(0, fe.tone_size, (batch, tph)).astype(np.int32),
        "boundary_ids": rng.integers(0, fe.boundary_size, (batch, tph)).astype(np.int32),
        "dur_gt": dur,
        "mel_gt": rng.standard_normal((batch, tfrm, cfg.audio.n_mels)).astype(np.float32),
        "pitch_gt": rng.uniform(80, 600, (batch, tfrm)).astype(np.float32),
        "energy_gt": rng.uniform(0, 1, (batch, tfrm)).astype(np.float32),
        "phoneme_mask": np.ones((batch, tph), bool),
        "pitch_mask": rng.random((batch, tfrm)) > 0.3,
        "frame_lengths": totals.astype(np.int32),
    }


def to_device(a: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array as a tensor on `device`.  To the card it goes from
    pinned memory with non_blocking=True, so the copy is asynchronous (a
    copy from pageable memory is not) and is ordered on the current
    stream before whatever is enqueued after it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays the train step reads, as tensors on `device` (ids as
    int64, the embeddings' index type; `frame_lengths` stays behind)."""
    return {k: to_device(v, device, torch.long if k.endswith("_ids") else None)
            for k, v in batch.items() if k != "frame_lengths"}
