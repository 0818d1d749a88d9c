"""The port's vocoder losses against the JAX package's, float32 on the CPU.

The same waveforms, critic outputs and feature maps (numpy, from a seed, in
the shapes of the tiny vocoder's 3 MSD + 5 MPD critics) go to
`vocoder_generator_loss` / `vocoder_discriminator_loss` on both sides; every
metric key must match and every value agree within 1e-5 (relative), and the
generator loss's gradients agree too (tolerances in the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu.config import AudioConfig as JAudio
from sambert_hifigan_tpu.losses import vocoder as j_loss

from sambert_hifigan_tpu_torch.config import AudioConfig
from sambert_hifigan_tpu_torch.losses import vocoder as p_loss
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

T_WAV = 8 * 256
# per critic: the feature-map shapes (the last is the logits)
MSD_MAPS = [[(2, c, t) for c, t in ((8, 2048), (8, 1024), (16, 512), (32, 128), (64, 32),
                                    (64, 32), (64, 32), (1, 32))]] * 3
MPD_MAPS = [[(2, c, h, p) for c, h in ((2, 342), (8, 114), (32, 38), (64, 13), (64, 13),
                                       (1, 13))] for p in (2, 3, 5, 7, 11)]
MAPS = MSD_MAPS + MPD_MAPS


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed):
    real, fake = _np(seed, 2, 1, T_WAV, scale=0.2), _np(seed + 1, 2, 1, T_WAV, scale=0.2)
    real_maps = [[_np(seed + 100 * i + j, *s) for j, s in enumerate(critic)]
                 for i, critic in enumerate(MAPS)]
    fake_maps = [[_np(seed + 5000 + 100 * i + j, *s) for j, s in enumerate(critic)]
                 for i, critic in enumerate(MAPS)]
    return real, fake, real_maps, fake_maps


def _assert_metrics_match(ours, theirs, rel=1e-5):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        a, b = float(ours[k].detach()), float(np.asarray(theirs[k]))
        assert abs(a - b) <= rel * max(abs(b), 1e-12), (k, a, b)


def test_discriminator_loss_matches_jax():
    _, _, real_maps, fake_maps = _inputs(0)
    real_outs = [c[-1] for c in real_maps]
    fake_outs = [c[-1] for c in fake_maps]
    loss, ours = p_loss.vocoder_discriminator_loss(
        [torch.from_numpy(x) for x in real_outs], [torch.from_numpy(x) for x in fake_outs])
    _, theirs = j_loss.vocoder_discriminator_loss(
        [jnp.asarray(x) for x in real_outs], [jnp.asarray(x) for x in fake_outs])
    assert ours["disc_loss"] is loss
    _assert_metrics_match(ours, theirs)


@pytest.mark.parametrize("mode", ["mel_only", "adv_mel", "adv_mel_fm"])
def test_generator_loss_and_gradients_match_jax(mode):
    """Every key of the mode's schema (zeros for inactive terms, the 8
    gen_fm_loss_disc_i in adv_mel_fm) within 1e-5; the gradients of
    gen_loss with respect to the fake logits and maps within 1e-4 of the
    largest, the fake waveform's within 5e-3 (below), and none through the
    real maps."""
    real, fake, real_maps, fake_maps = _inputs(1)
    audio, jaudio = AudioConfig(), JAudio()

    def jax_loss(wav_fake, fake_outs, fake_fm):
        return j_loss.vocoder_generator_loss(
            jnp.asarray(real), wav_fake, jaudio, loss_mode=mode, disc_fake_outputs=fake_outs,
            real_feature_maps=[[jnp.asarray(x) for x in c] for c in real_maps],
            fake_feature_maps=fake_fm)

    j_args = (jnp.asarray(fake), [jnp.asarray(c[-1]) for c in fake_maps],
              [[jnp.asarray(x) for x in c] for c in fake_maps])
    (_, theirs), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(*j_args)

    t_fake = torch.from_numpy(fake).requires_grad_(True)
    t_fm = [[torch.from_numpy(x).requires_grad_(True) for x in c] for c in fake_maps]
    t_real_fm = [[torch.from_numpy(x).requires_grad_(True) for x in c] for c in real_maps]
    t_outs = [c[-1] for c in t_fm]
    loss, ours = p_loss.vocoder_generator_loss(
        torch.from_numpy(real), t_fake, audio, loss_mode=mode, disc_fake_outputs=t_outs,
        real_feature_maps=t_real_fm, fake_feature_maps=t_fm)
    _assert_metrics_match(ours, theirs)
    fm_keys = [k for k in ours if k.startswith("gen_fm_loss_disc_")]
    assert len(fm_keys) == (8 if mode == "adv_mel_fm" else 0)

    loss.backward()
    j_wav, j_outs, j_fm = j_grads
    got = [t_fake.grad] + [x.grad for c in t_fm for x in c]
    # the logits' gradient reaches them as the last map of each critic
    want = [np.asarray(j_wav)] + [
        np.asarray(g) + (np.asarray(j_outs[i]) if j == len(c) - 1 else 0)
        for i, c in enumerate(j_fm) for j, g in enumerate(c)]
    # the waveform's: 5e-3, since d log|X| = dX / |X| turns f32 FFT noise
    # (pocketfft against XLA, ~3e-7 absolute) in the MR-STFT's smallest bins
    # (|X| ~ 2e-4 at n_fft 512) into ~1.5e-3 of the largest gradient
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.abs(g - w).max() <= (5e-3 if i == 0 else 1e-4) * max(np.abs(w).max(), 1e-12)
    assert all(x.grad is None for c in t_real_fm for x in c)


def test_generator_loss_refusals_and_modes():
    wav = torch.zeros(1, 1, T_WAV)
    with pytest.raises(ValueError, match="Invalid loss_mode"):
        p_loss.vocoder_generator_loss(wav, wav, AudioConfig(), loss_mode="adv")
    with pytest.raises(ValueError, match="disc_fake_outputs"):
        p_loss.vocoder_generator_loss(wav, wav, AudioConfig(), loss_mode="adv_mel")
    with pytest.raises(ValueError, match="feature_maps"):
        p_loss.vocoder_generator_loss(wav, wav, AudioConfig(), loss_mode="adv_mel_fm",
                                      disc_fake_outputs=[wav])
    for mode in ("mel_only", "adv_mel", "adv_mel_fm"):
        assert p_loss.should_train_discriminator(mode) == j_loss.should_train_discriminator(mode)
