"""The port's DSP (STFT, the shared log-mel op, resampling, audio and mel
files) against the JAX package, float32 on the CPU, and against the
committed mel goldens (tests/data/gen_mel_goldens.py: a float64 torch.stft
spectrogram and a float64 loop-form filterbank).

Inputs are numpy arrays from a seed, fed to both sides.  Tolerances are f32
FFT noise (pocketfft against XLA's FFT) and are stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.config import AudioConfig as JAudio
from sambert_hifigan_tpu.data import audio as j_audio
from sambert_hifigan_tpu.losses.vocoder import STFT_PARAMS
from sambert_hifigan_tpu.ops import mel as j_mel
from sambert_hifigan_tpu.ops import stft as j_stft

from sambert_hifigan_tpu_torch.config import AudioConfig
from sambert_hifigan_tpu_torch.data import audio as p_audio
from sambert_hifigan_tpu_torch.ops import mel as p_mel
from sambert_hifigan_tpu_torch.ops import stft as p_stft
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
AUDIO = AudioConfig()
MEL_RES = {"n_fft": AUDIO.n_fft, "hop_length": AUDIO.hop_length, "win_length": AUDIO.win_length}


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("res", list(STFT_PARAMS) + [MEL_RES],
                         ids=["mr1024", "mr2048", "mr512", "mel"])
def test_stft_magnitude_matches_jax(res):
    """Each MR-STFT resolution and the mel's, batch of 2 (one with a silent
    stretch): same frame count, max |diff| <= 1e-5 of the max magnitude."""
    x = _np(0, 2, 5000, scale=0.3)
    x[1, :1700] = 0.0
    ours = p_stft.stft_magnitude(torch.from_numpy(x), **res).numpy()
    theirs = np.asarray(j_stft.stft_magnitude(jnp.asarray(x), **res))
    frames = p_stft.num_stft_frames(5000, res["n_fft"], res["hop_length"])
    assert ours.shape == theirs.shape == (2, res["n_fft"] // 2 + 1, frames)
    assert frames == j_stft.num_stft_frames(5000, res["n_fft"], res["hop_length"])
    assert _rel(ours, theirs) <= 1e-5


def test_stft_gradient_matches_jax_with_silent_frames():
    """d/dx mean(log(|X| + 1e-5)), the MR-STFT loss's term, on a signal
    whose first frames are silent: |X| == 0 there on both sides and both
    gradients are finite; max |diff| <= 1e-5 of the largest gradient."""
    x = _np(1, 2048)
    x[:1500] = 0.0
    res = STFT_PARAMS[2]
    theirs = np.asarray(jax.grad(
        lambda v: jnp.mean(jnp.log(j_stft.stft_magnitude(v, **res) + 1e-5)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    torch.mean(torch.log(p_stft.stft_magnitude(t, **res) + 1e-5)).backward()
    assert np.isfinite(theirs).all() and torch.isfinite(t.grad).all()
    assert _rel(t.grad.numpy(), theirs) <= 1e-5


def test_frame_signal_and_window_match_jax():
    x = _np(2, 3, 700)
    np.testing.assert_array_equal(p_stft.frame_signal(torch.from_numpy(x), 64, 17).numpy(),
                                  np.asarray(j_stft.frame_signal(jnp.asarray(x), 64, 17)))
    np.testing.assert_array_equal(p_stft.hann_window(600).numpy(),
                                  np.asarray(j_stft.hann_window(600)))
    z = p_stft.stft_complex(torch.from_numpy(x), 128, 32, 100).numpy()
    zj = np.asarray(j_stft.stft_complex(jnp.asarray(x), 128, 32, 100))
    assert z.shape == zj.shape and _rel(z, zj) <= 1e-5


@pytest.mark.parametrize("audio", [
    AudioConfig(),
    AudioConfig(mel_scale="htk", norm=None, log_base="e", fmin=50.0, fmax=7600.0),
    AudioConfig(log_base=2.0, n_mels=64),
], ids=["default", "htk-ln", "log2"])
def test_log_mel_matches_jax(audio):
    """The shared mel op, every base of _apply_log and both mel scales,
    [B, T] input: max |diff| <= 1e-5 (on log values of magnitude ~1-20);
    the filterbanks are bit-equal (the same numpy)."""
    jaudio = JAudio(**{f: getattr(audio, f) for f in audio.__dataclass_fields__})
    x = _np(3, 2, 6 * 256 + 100, scale=0.2)
    ours = p_mel.log_mel_spectrogram(torch.from_numpy(x), audio).numpy()
    theirs = np.asarray(j_mel.log_mel_spectrogram(jnp.asarray(x), jaudio))
    assert ours.shape == theirs.shape == (2, audio.n_mels, x.shape[1] // 256 + 1)
    assert np.abs(ours - theirs).max() <= 1e-5
    np.testing.assert_array_equal(p_mel.mel_filterbank(audio).numpy(),
                                  np.asarray(j_mel.mel_filterbank(jaudio)))


def test_log_mel_matches_committed_goldens():
    """The bounds tests/test_mel_golden.py holds the JAX op to: filterbank
    within 1e-6 of the f64 loop form; log-mel mean |diff| < 1e-5 and max
    < 1e-3 against the f64 torch.stft golden; T = time // hop + 1."""
    golden_fb = np.load(os.path.join(DATA, "golden_mel_fbank.npy"))
    assert np.abs(p_mel.mel_filterbank(AUDIO).numpy() - golden_fb).max() < 1e-6
    wav = np.load(os.path.join(DATA, "golden_mel_wav.npy"))
    want = np.load(os.path.join(DATA, "golden_log_mel.npy"))
    got = p_mel.log_mel_spectrogram(torch.from_numpy(wav), AUDIO).numpy()
    assert got.shape == want.shape == (80, wav.shape[0] // AUDIO.hop_length + 1)
    assert np.abs(got - want).mean() < 1e-5
    assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("orig,new", [(16000, 22050), (44100, 22050), (22050, 22050)])
def test_resample_matches_jax(orig, new):
    """Same length; max |diff| <= 1e-5 on a unit-variance signal."""
    x = _np(4, 2, 3001)
    ours = p_mel.resample(torch.from_numpy(x), orig, new).numpy()
    theirs = np.asarray(j_mel.resample(jnp.asarray(x), orig, new))
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 1e-5


def test_audio_files_round_trip_and_extract_mel(tmp_path):
    """A stereo 16 kHz PCM16 file written by the port reads back on both
    sides bit for bit; extract_mel_from_file (resample to 22.05 kHz,
    downmix) agrees with the JAX package's within 1e-5; mel .npy files
    round-trip exactly."""
    x = np.clip(_np(5, 2, 4000, scale=0.3), -1, 1)
    path = tmp_path / "a.wav"
    p_audio.save_wav(path, x, 16000)
    ours, sr = p_audio.load_wav(path)
    theirs, sr_j = j_audio.load_wav(path)
    assert sr == sr_j == 16000 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    assert np.abs(ours - x).max() <= 2.0 / 32767  # truncated to PCM16, read back / 32768
    mel, sr = p_mel.extract_mel_from_file(path, AUDIO)
    mel_j, _ = j_mel.extract_mel_from_file(path, JAudio())
    assert mel.shape == mel_j.shape
    assert np.abs(mel.numpy() - np.asarray(mel_j)).max() <= 1e-5
    p_audio.save_mel(mel.numpy(), tmp_path / "m" / "a.npy")
    np.testing.assert_array_equal(p_audio.load_mel(tmp_path / "m" / "a.npy"), mel.numpy())
