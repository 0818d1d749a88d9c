"""The port's native WAV decoder (csrc/dataloader.cpp through
data/native_loader.py) against the numpy reader (data/audio.load_wav):
decodes bit for bit equal in every format both read (PCM 8/16/24/32-bit
and float32, mono and stereo), bad bytes raise, the NativePrefetcher
delivers every file and skips the undecodable, the library is built under
the port's `_build/` (never in `native/`), and TTSDataset falls back to
the numpy reader where the library does not build.
"""

import struct

import numpy as np
import pytest

from sambert_hifigan_tpu_torch import kernels
from sambert_hifigan_tpu_torch.config import TTSConfig
from sambert_hifigan_tpu_torch.data import native_loader as nl
from sambert_hifigan_tpu_torch.data.audio import load_wav, save_wav
from sambert_hifigan_tpu_torch.data.dataset import TTSDataset
from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset

REPO_NATIVE = kernels.CSRC.parents[1] / "native"


@pytest.fixture(scope="module", autouse=True)
def built():
    """g++ is part of the test image's toolchain: a failed build fails here."""
    assert nl.native_available()


def _tone(freq, n=8000, sr=22050, amp=0.5, ch=1):
    x = (amp * np.sin(2 * np.pi * freq * np.arange(n) / sr)).astype(np.float32)
    return np.stack([x * (i + 1) / ch for i in range(ch)]) if ch > 1 else x


def _wav_bytes(x: np.ndarray, sr: int, fmt: str) -> bytes:
    """x [channels, time] in [-1, 1] as a RIFF/WAVE file of format `fmt`."""
    inter = np.asarray(x, np.float64).T.reshape(-1)
    if fmt == "f32":
        tag, bits, data = 3, 32, inter.astype("<f4").tobytes()
    elif fmt == "pcm8":
        tag, bits, data = 1, 8, np.clip(inter * 127 + 128, 0, 255).astype(np.uint8).tobytes()
    elif fmt == "pcm24":
        v = np.clip(inter * 8388607, -8388608, 8388607).astype("<i4")
        tag, bits = 1, 24
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    else:
        bits = {"pcm16": 16, "pcm32": 32}[fmt]
        tag, data = 1, (inter * (2 ** (bits - 1) - 1)).astype(f"<i{bits // 8}").tobytes()
    ch = x.shape[0]
    fmt_chunk = struct.pack("<HHIIHH", tag, ch, sr, sr * ch * bits // 8, ch * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
    body += b"data" + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt", ["pcm16", "pcm32", "pcm8", "pcm24", "f32"])
def test_native_decode_equals_numpy_reader(tmp_path, fmt, channels):
    x = _tone(440.0, n=3001, ch=channels).reshape(channels, -1)
    path = tmp_path / f"a_{fmt}.wav"
    path.write_bytes(_wav_bytes(x, 16000, fmt))
    ours, sr = nl.load_wav_native(path)
    ref, sr_ref = load_wav(path)
    assert sr == sr_ref == 16000 and ours.shape == ref.shape == (channels, 3001)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_save_wav_round_trip_equals_numpy_reader(tmp_path):
    p = tmp_path / "s.wav"
    save_wav(p, _tone(220.0, ch=2), 22050)
    ours, sr = nl.load_wav_native(p)
    np.testing.assert_array_equal(ours, load_wav(p)[0])
    assert sr == 22050


def test_bad_bytes_raise():
    with pytest.raises(ValueError):
        nl.decode_wav_bytes(b"not a wav file at all, sorry!")
    with pytest.raises(ValueError):
        nl.decode_wav_bytes(b"RIFF" + b"\0" * 60)


def test_prefetcher_delivers_every_file(tmp_path):
    paths = []
    for i in range(10):
        p = tmp_path / f"u{i}.wav"
        save_wav(p, _tone(200.0 + 50 * i, n=4000 + 100 * i), 22050)
        paths.append(str(p))
    with nl.NativePrefetcher(paths, n_threads=3, capacity=4, max_samples=1000) as pf:
        got = {idx: (wav, sr) for idx, wav, sr in pf}  # max_samples forces the regrow path
    assert sorted(got) == list(range(10))
    for i, p in enumerate(paths):
        assert got[i][1] == 22050
        np.testing.assert_array_equal(got[i][0], load_wav(p)[0])


def test_prefetcher_skips_undecodable_files(tmp_path):
    good = tmp_path / "good.wav"
    save_wav(good, _tone(300.0), 22050)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"garbage")
    pf = nl.NativePrefetcher([str(good), str(bad), str(tmp_path / "missing.wav")], n_threads=2)
    results = list(pf)
    pf.close()
    pf.close()  # idempotent
    assert [r[0] for r in results] == [0]


def test_library_is_built_under_the_ports_build_dir():
    lib = nl.library_path()
    assert lib.exists() and lib.parent == kernels.BUILD_DIR
    assert not lib.resolve().is_relative_to(REPO_NATIVE.resolve())
    assert lib.name.startswith("dataloader-") and lib.suffix == ".so"


def test_dataset_falls_back_to_the_numpy_reader(tmp_path, monkeypatch):
    """With no native library, TTSDataset reads with the numpy reader and
    extracts the same features."""
    meta = make_toy_dataset(tmp_path / "toy", n=1, seed=2, verbose=False)
    cfg = TTSConfig()
    native = TTSDataset(str(meta), cfg, cache_dir=str(tmp_path / "c1"), device="cpu")
    want = native.load_features(native.utterances[0])
    monkeypatch.setattr(nl, "_lib", False)
    assert not nl.native_available()
    calls = []
    monkeypatch.setattr("sambert_hifigan_tpu_torch.data.dataset.load_wav",
                        lambda p: calls.append(p) or load_wav(p))
    plain = TTSDataset(str(meta), cfg, cache_dir=str(tmp_path / "c2"), device="cpu")
    got = plain.load_features(plain.utterances[0])
    assert len(calls) == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
