"""The port's dataset layer (data/dataset.py, make_toy_dataset) against the
JAX package's, on a toy corpus of 8 utterances made in a temporary
directory, each package with a feature cache of its own.

Equal: the parsed metadata, the cache key and npz field names, every
integer array, mask and frame count, the waveforms, the vocoder crops'
waveforms, the batch order of every seed, and the toy corpus's bytes.
Within bounds: the log-mel (1e-3 where JAX's log10 power is above -6,
1e-2 below, where the power is 1e-9 of the frame's and f32 FFT rounding
of two FFT libraries moves it; 2.6e-4 and 4.0e-3 measured), F0 within
1e-3 (relative) where both are voiced and at most 1% of voiced flags
differing, energy within 1e-6.  Also: the bucket-edge reflect padding of
tests/test_data.py, a JAX-written cache read by the port, the memo's
frozen arrays and byte bound, a resampled stereo file, and an empty epoch
refused.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.config import TTSConfig as JConfig
from sambert_hifigan_tpu.data import dataset as jd

from sambert_hifigan_tpu_torch import make_toy_dataset as toy
from sambert_hifigan_tpu_torch.config import TTSConfig
from sambert_hifigan_tpu_torch.data import dataset as pd
from sambert_hifigan_tpu_torch.data.audio import load_wav, save_wav
from sambert_hifigan_tpu_torch.data.features import extract_energy, extract_f0
from sambert_hifigan_tpu_torch.ops.mel import log_mel_spectrogram
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parents[1]
MEL_TOL_LOUD, MEL_TOL, MEL_LOUD = 1e-3, 1e-2, -6.0
F0_REL, ENERGY_ABS, VOICED_FLIP_SHARE = 1e-3, 1e-6, 0.01
INTS = ("ph_ids", "tone_ids", "boundary_ids", "dur_gt", "phoneme_mask", "pitch_mask",
        "frame_lengths")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    meta = toy.make_toy_dataset(root, n=8, seed=0, verbose=False)
    jds = jd.TTSDataset(str(meta), JConfig(), cache_dir=str(root / "cache_jax"))
    pds = pd.TTSDataset(str(meta), TTSConfig(), cache_dir=str(root / "cache_port"),
                        device="cpu")
    feats = [(jds.load_features(u), pds.load_features(u)) for u in jds.utterances]
    return meta, jds, pds, feats


def _assert_mel_close(ours, theirs):
    d = np.abs(ours - theirs)
    assert d.max() <= MEL_TOL, d.max()
    loud = theirs > MEL_LOUD
    assert d[loud].max() <= MEL_TOL_LOUD, d[loud].max()


def _assert_pitch_close(f0_p, f0_j, v_p, v_j):
    both = v_p & v_j
    assert (v_p != v_j).sum() <= VOICED_FLIP_SHARE * v_j.size
    if both.any():
        assert (np.abs(f0_p - f0_j)[both] / f0_j[both]).max() <= F0_REL


def test_read_metadata_equals_jax(tmp_path):
    meta = tmp_path / "metadata.csv"
    meta.write_text("# a comment\nwavs/a.wav|你好\n\n  wavs/b.wav|he|llo  \n", encoding="utf-8")
    ours, theirs = pd.read_metadata(str(meta)), jd.read_metadata(str(meta))
    assert [(u.wav_path, u.text) for u in ours] == [(u.wav_path, u.text) for u in theirs]
    assert [u.text for u in ours] == ["你好", "he|llo"]
    meta.write_text("no separator\n", encoding="utf-8")
    with pytest.raises(ValueError, match="malformed"):
        pd.read_metadata(str(meta))


def test_cache_key_and_fields_equal_jax(corpus):
    _, jds, pds, feats = corpus
    for u in jds.utterances:
        assert pds._cache_key(u).name == jds._cache_key(u).name
        assert pds._cache_key(u).exists() and jds._cache_key(u).exists()
    for theirs, ours in feats:
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k


def test_features_match_jax(corpus):
    _, _, _, feats = corpus
    for theirs, ours in feats:
        for k in ("ph_ids", "tone_ids", "boundary_ids", "dur", "wav"):
            np.testing.assert_array_equal(ours[k], theirs[k])
        _assert_mel_close(ours["mel"], theirs["mel"])
        _assert_pitch_close(ours["f0"], theirs["f0"], ours["voiced"], theirs["voiced"])
        np.testing.assert_allclose(ours["energy"], theirs["energy"], atol=ENERGY_ABS, rtol=0)
        assert ours["dur"].sum() == ours["mel"].shape[0]


def _assert_batches_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in INTS:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    _assert_mel_close(ours["mel_gt"], theirs["mel_gt"])
    _assert_pitch_close(ours["pitch_gt"], theirs["pitch_gt"], ours["pitch_mask"],
                        theirs["pitch_mask"])
    np.testing.assert_allclose(ours["energy_gt"], theirs["energy_gt"], atol=ENERGY_ABS, rtol=0)


@pytest.mark.parametrize("batch,seed,drop", [(2, 0, True), (3, 1, True), (3, 1, False),
                                             (8, 5, True)])
def test_batches_match_jax(corpus, batch, seed, drop):
    _, jds, pds, _ = corpus
    ours = list(pds.batches(batch, seed=seed, drop_remainder=drop))
    theirs = list(jds.batches(batch, seed=seed, drop_remainder=drop))
    assert len(ours) == len(theirs) == (8 // batch if drop else -(-8 // batch))
    for a, b in zip(ours, theirs):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("ph_buckets,frm_buckets", [((16,), (128, 256)), ((8, 64), (64, 512))])
def test_collate_acoustic_matches_jax(corpus, ph_buckets, frm_buckets):
    _, _, _, feats = corpus
    ours = pd.collate_acoustic([f[1] for f in feats[2:6]], ph_buckets, frm_buckets)
    theirs = jd.collate_acoustic([f[0] for f in feats[2:6]], ph_buckets, frm_buckets)
    _assert_batches_equal(ours, theirs)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        pd.collate_acoustic([f[1] for f in feats], (4,), frm_buckets)


@pytest.mark.parametrize("batch,frames,seed", [(2, 8, 0), (3, 32, 4), (4, 100, 1)])
def test_vocoder_batches_match_jax(corpus, batch, frames, seed):
    _, jds, pds, _ = corpus
    ours = list(pd.vocoder_batches_from_dataset(pds, batch, frames, seed=seed))
    theirs = list(jd.vocoder_batches_from_dataset(jds, batch, frames, seed=seed))
    assert len(ours) == len(theirs) > 0
    for (mel_p, wav_p), (mel_j, wav_j) in zip(ours, theirs):
        assert mel_p.shape == (batch, 80, frames) and wav_p.shape == (batch, 1, frames * 256)
        np.testing.assert_array_equal(wav_p, wav_j)
        _assert_mel_close(mel_p, mel_j)


def test_bucket_edge_padding_matches_unpadded(tmp_path):
    """A wav 100 samples short of a bucket multiple: the reflect pad to the
    next bucket keeps every true frame equal to extraction on the unpadded
    signal (a pad under half a window used to double-reflect the last
    frame; tests/test_data.py)."""
    cfg = TTSConfig()
    hop = cfg.audio.hop_length
    n = hop * 64 - 100
    wav = (0.3 * np.random.default_rng(7).standard_normal(n)).astype(np.float32)
    save_wav(tmp_path / "wavs/edge.wav", wav, cfg.audio.sample_rate)
    (tmp_path / "metadata.csv").write_text("wavs/edge.wav|你好\n", encoding="utf-8")
    ds = pd.TTSDataset(str(tmp_path / "metadata.csv"), cfg, device="cpu")
    feats = ds.load_features(ds.utterances[0])
    x = torch.from_numpy(load_wav(tmp_path / "wavs/edge.wav")[0][0])
    t = n // hop + 1
    assert feats["mel"].shape == (t, 80)
    np.testing.assert_allclose(feats["mel"], log_mel_spectrogram(x, cfg.audio).numpy().T[:t],
                               atol=1e-5, rtol=0)
    f0, voiced = extract_f0(x, cfg.audio)
    np.testing.assert_array_equal(feats["voiced"], voiced.numpy())
    np.testing.assert_allclose(feats["f0"], f0.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(feats["energy"], extract_energy(x, cfg.audio).numpy(), atol=1e-6)


def test_port_reads_a_jax_written_cache(corpus, monkeypatch):
    meta, jds, _, feats = corpus
    ds = pd.TTSDataset(str(meta), TTSConfig(), cache_dir=str(jds.cache_dir), device="cpu")

    def no_extraction(*args):
        raise AssertionError("features were extracted, not read from the cache")

    monkeypatch.setattr(ds, "_extract_features", no_extraction)
    for u, (theirs, _) in zip(ds.utterances, feats):
        ours = ds.load_features(u)
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_memo_is_frozen_and_byte_bounded(corpus, monkeypatch):
    meta, _, pds, _ = corpus
    u = pds.utterances[0]
    a, b = pds.load_features(u), pds.load_features(u)
    assert a is not b and a["mel"] is b["mel"]  # one shared, frozen array
    assert not any(v.flags.writeable for v in a.values())
    with pytest.raises(ValueError):
        a["mel"][0, 0] = 1.0
    a["mel"] = None  # the dict is the caller's own
    assert pds.load_features(u)["mel"] is b["mel"]
    monkeypatch.setenv("SAMBERT_MEM_CACHE_MB", "0")
    cold = pd.TTSDataset(str(meta), TTSConfig(), cache_dir=str(pds.cache_dir), device="cpu")
    f = cold.load_features(u)
    assert cold._mem_cache == {} and cold._mem_bytes == 0
    np.testing.assert_array_equal(f["mel"], b["mel"])


def test_resampled_stereo_file_matches_jax(tmp_path):
    """A 16 kHz stereo file: resampled to 22.05 kHz and downmixed on both
    sides."""
    t = np.arange(12000) / 16000
    x = np.stack([0.4 * np.sin(2 * np.pi * 180 * t), 0.3 * np.sin(2 * np.pi * 270 * t)])
    save_wav(tmp_path / "wavs/st.wav", x.astype(np.float32), 16000)
    (tmp_path / "metadata.csv").write_text("wavs/st.wav|你好世界\n", encoding="utf-8")
    ours = pd.TTSDataset(str(tmp_path / "metadata.csv"), TTSConfig(), device="cpu",
                         cache_dir=str(tmp_path / "cp")).load_features(pd.Utterance(
                             "wavs/st.wav", "你好世界"))
    theirs = jd.TTSDataset(str(tmp_path / "metadata.csv"), JConfig(),
                           cache_dir=str(tmp_path / "cj")).load_features(jd.Utterance(
                               "wavs/st.wav", "你好世界"))
    assert ours["wav"].shape == theirs["wav"].shape == (16538,)
    np.testing.assert_allclose(ours["wav"], theirs["wav"], atol=1e-5, rtol=0)
    _assert_mel_close(ours["mel"], theirs["mel"])
    _assert_pitch_close(ours["f0"], theirs["f0"], ours["voiced"], theirs["voiced"])
    np.testing.assert_array_equal(ours["dur"], theirs["dur"])


def test_empty_epochs_are_refused():
    batches = pd.epochs(lambda n: iter([n] if n < 2 else []))
    assert [next(batches), next(batches)] == [0, 1]
    with pytest.raises(ValueError, match="no batch"):
        next(batches)


def test_make_toy_dataset_writes_the_jax_scripts_bytes(tmp_path):
    ours = toy.main(["--out", str(tmp_path / "port"), "--n", "3", "--seed", "5",
                     "--max-chars", "6"]).parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(REPO / "scripts/make_toy_dataset.py"), "--out",
                    str(tmp_path / "jax"), "--n", "3", "--seed", "5", "--max-chars", "6"],
                   check=True, capture_output=True, env=env, timeout=300)
    files = sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert len(files) == 4 and Path("metadata.csv") in files
    for rel in files:
        assert (ours / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
