"""The port's feature extraction (data/features.py) against the JAX
package's, float32 on the CPU: centred framing, autocorrelation F0 and its
voicing, RMS energy, and the uniform durations.

Fixtures as tests/test_data.py uses them (pure tones at 110/220/440 Hz,
silence, white noise, a 50 Hz tone below the band) and utterances of a toy
corpus (make_toy_dataset, seed 0).  Bounds: framing and durations equal;
voiced masks equal on the fixtures; F0 within 1e-3 (relative) where both
sides are voiced; energy within 1e-6.  F0's peak is an argmax over the
lag band, and a near-tie can pick a neighbouring lag or flip a voiced flag
between two FFT libraries: on the corpus at most 1% of the frames may
differ in their voiced flag (0 of 918 measured on 8 utterances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.config import AudioConfig as JAudio
from sambert_hifigan_tpu.data import features as jf

from sambert_hifigan_tpu_torch.config import AudioConfig
from sambert_hifigan_tpu_torch.data import features as pf
from sambert_hifigan_tpu_torch.data.audio import load_wav
from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

AUDIO = AudioConfig()
SR = AUDIO.sample_rate
F0_REL, ENERGY_ABS, VOICED_FLIP_SHARE = 1e-3, 1e-6, 0.01


def _tone(freq, n=SR, amp=0.5):
    t = np.arange(n) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


FIXTURES = {
    "tone110": _tone(110.0),
    "tone220": _tone(220.0),
    "tone440": _tone(440.0),
    "tone50": _tone(50.0),
    "silence": np.zeros(SR, np.float32),
    "noise": (np.random.default_rng(0).standard_normal(SR) * 0.1).astype(np.float32),
    "batch": np.stack([_tone(220.0, 9000), _tone(330.0, 9000, amp=0.2)]),
}


def _both(wav):
    """(f0, voiced) of both packages, as numpy."""
    f0_j, v_j = jf.extract_f0(jnp.asarray(wav), JAudio())
    f0_p, v_p = pf.extract_f0(torch.from_numpy(wav), AUDIO)
    return np.asarray(f0_j), np.asarray(v_j), f0_p.numpy(), v_p.numpy()


def _f0_rel(f0_j, v_j, f0_p, v_p):
    both = v_j & v_p
    return float((np.abs(f0_p - f0_j)[both] / f0_j[both]).max()) if both.any() else 0.0


@pytest.mark.parametrize("name", list(FIXTURES))
def test_f0_matches_jax_on_fixtures(name):
    wav = FIXTURES[name]
    f0_j, v_j, f0_p, v_p = _both(wav)
    assert f0_p.shape == f0_j.shape == wav.shape[:-1] + (wav.shape[-1] // AUDIO.hop_length + 1,)
    np.testing.assert_array_equal(v_p, v_j)
    assert _f0_rel(f0_j, v_j, f0_p, v_p) <= F0_REL
    assert (f0_p[~v_p] == 0).all()
    if name.startswith("tone") and name != "tone50":
        assert v_p[5:-5].mean() > 0.9


@pytest.mark.parametrize("name", list(FIXTURES))
def test_energy_matches_jax_on_fixtures(name):
    wav = FIXTURES[name]
    for normalize in (True, False):
        ours = pf.extract_energy(torch.from_numpy(wav), AUDIO, normalize=normalize).numpy()
        theirs = np.asarray(jf.extract_energy(jnp.asarray(wav), JAudio(), normalize=normalize))
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, atol=ENERGY_ABS, rtol=0)


@pytest.mark.parametrize("frame_length,hop", [(1024, 256), (400, 100), (64, 17)])
def test_centered_framing_equals_jax(frame_length, hop):
    x = np.random.default_rng(1).standard_normal((2, 3000)).astype(np.float32)
    ours = pf.frame_waveform_centered(torch.from_numpy(x), frame_length, hop).numpy()
    theirs = np.asarray(jf.frame_waveform_centered(jnp.asarray(x), frame_length, hop))
    np.testing.assert_array_equal(ours, theirs)
    one = pf.frame_waveform_centered(torch.from_numpy(x[0]), frame_length, hop).numpy()
    np.testing.assert_array_equal(one, theirs[0])


@pytest.mark.parametrize("n_ph,n_frames", [(7, 100), (10, 10), (3, 8), (1, 5), (12, 131)])
def test_uniform_durations_equal_jax(n_ph, n_frames):
    ours = pf.uniform_durations(n_ph, n_frames)
    np.testing.assert_array_equal(ours, jf.uniform_durations(n_ph, n_frames))
    assert ours.dtype == np.int32 and ours.sum() == n_frames


def test_corpus_f0_voicing_within_bounds(tmp_path):
    """Four toy-corpus utterances (harmonic vowels, noise bursts, silences):
    the share of frames whose voiced flag differs stays within 1%, F0
    within 1e-3 where both are voiced, energy within 1e-6."""
    meta = make_toy_dataset(tmp_path, n=4, seed=0, verbose=False)
    flips = frames = 0
    for line in meta.read_text(encoding="utf-8").splitlines():
        wav = load_wav(tmp_path / line.split("|")[0])[0][0]
        f0_j, v_j, f0_p, v_p = _both(wav)
        flips += int((v_j != v_p).sum())
        frames += v_j.size
        assert v_j.any() and _f0_rel(f0_j, v_j, f0_p, v_p) <= F0_REL
        np.testing.assert_allclose(
            pf.extract_energy(torch.from_numpy(wav), AUDIO).numpy(),
            np.asarray(jf.extract_energy(jnp.asarray(wav), JAudio())), atol=ENERGY_ABS, rtol=0)
    assert flips <= VOICED_FLIP_SHARE * frames, (flips, frames)
