"""Module parity of the PyTorch port against the JAX package, float32 on the
CPU, at a small size (d=32, 2 layers, 4 heads, FFN 64).

Weights come from the JAX side's init and are carried into the port with
`sambert_hifigan_tpu_torch.weights`; inputs are made with numpy from a seed
and fed to both sides.  Integer outputs (durations, frame indices, masks,
totals) must be EXACTLY equal.  Float tolerances are f32 reassociation noise
(different op order, oneDNN vs XLA:CPU kernels) and are stated per test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.models import acoustic_model as j_am
from sambert_hifigan_tpu.models import ar_decoder as j_ar
from sambert_hifigan_tpu.models import encoder as j_enc
from sambert_hifigan_tpu.models import hifigan as j_hg
from sambert_hifigan_tpu.models import phoneme_embedding as j_pe
from sambert_hifigan_tpu.models import transformer as j_tf
from sambert_hifigan_tpu.models import variance_adaptor as j_va
from sambert_hifigan_tpu.ops import length_regulator as j_lr

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel
from sambert_hifigan_tpu_torch.models.hifigan import MRF, HiFiGANGenerator
from sambert_hifigan_tpu_torch.ops import length_regulator as p_lr
from sambert_hifigan_tpu_torch.ops.mrf import mrf, pack_mrf
from sambert_hifigan_tpu_torch.weights import (
    acoustic_state_dict_from_flax,
    generator_state_dict_from_flax,
    mrf_state_dict_from_flax,
)

D, MELS, TPH = 32, 80, 10


def _acoustic_cfg(c):
    return c.AcousticModelConfig(
        d_model=D,
        encoder=c.EncoderConfig(n_layers=2, n_heads=4, d_ff=64),
        decoder=c.DecoderConfig(n_layers=2, n_heads=4, d_ff=64, max_len=64),
    )


@pytest.fixture(scope="module")
def acoustic():
    """(flax params tree as numpy, port model with the same weights).  The
    duration predictor's output bias is raised so durations spread over
    several frames (random init alone rounds nearly all to 1)."""
    model = j_am.SAMBERTAcousticModel(_acoustic_cfg(jcfg))
    ph = jnp.zeros((1, 8), jnp.int32)
    params = model.init(
        jax.random.PRNGKey(0), ph, ph, ph, jnp.zeros((1, 16, MELS)),
        jnp.full((1, 8), 2, jnp.int32),
    )
    params = jax.device_get(params)
    lin = params["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    lin["bias"] = np.full_like(lin["bias"], 1.2)
    port = SAMBERTAcousticModel(_acoustic_cfg(pcfg))
    port.load_state_dict(acoustic_state_dict_from_flax(params))
    return params["params"], port.eval()


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ids(seed, b, high):
    return np.random.default_rng(seed).integers(0, high, (b, TPH)).astype(np.int32)


def _phoneme_mask(lengths):
    return np.arange(TPH)[None, :] < np.asarray(lengths)[:, None]


def test_phoneme_embedding(acoustic):
    p, port = acoustic
    ph, tone, bound = _ids(0, 2, 300), _ids(1, 2, 10), _ids(2, 2, 5)
    ref = j_pe.PhonemeEmbedding(d_model=D).apply(
        {"params": p["phoneme_embedding"]}, ph, tone, bound
    )
    out = port.phoneme_embedding(*(torch.from_numpy(a).long() for a in (ph, tone, bound)))
    # a sum of three table rows: exact up to f32 addition order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("whole", [False, True], ids=["one_layer", "encoder"])
def test_encoder_with_key_padding(acoustic, whole):
    p, port = acoustic
    x = _np(3, 2, TPH, D)
    kpm = ~_phoneme_mask([TPH, 6])
    if whole:
        ref = j_enc.BERTEncoder(D, _acoustic_cfg(jcfg).encoder).apply(
            {"params": p["bert_encoder"]}, x, key_padding_mask=kpm
        )
        out = port.bert_encoder(torch.from_numpy(x), torch.from_numpy(kpm))
    else:
        ref = j_tf.TransformerEncoderLayer(D, 4, 64).apply(
            {"params": p["bert_encoder"]["layer_0"]}, x, None, kpm
        )
        out = port.bert_encoder.layers[0](torch.from_numpy(x), torch.from_numpy(kpm))
    # post-norm outputs are O(1); 2e-5 covers f32 reassociation
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_length_regulator_integers_and_gather():
    rng = np.random.default_rng(4)
    dur = rng.integers(0, 4, (3, TPH)).astype(np.int32)
    dur[0, :3] = 0  # zero-duration phonemes emit no frames
    dur[2] = 0  # a row with no frames at all
    h = _np(5, 3, TPH, D)
    ji, jm, jt = j_lr.regulate_indices(jnp.asarray(dur), 24)
    pi, pm, pt = p_lr.regulate_indices(torch.from_numpy(dur), 24)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    ref = j_lr.gather_frames(jnp.asarray(h), ji, jm)
    out = p_lr.gather_frames(torch.from_numpy(h), pi, pm)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))  # a pure gather


@pytest.mark.parametrize("controls", [(1.0, 0.0, 1.0), (1.6, 40.0, 0.7)],
                         ids=["default", "prosody"])
def test_variance_adaptor(acoustic, controls):
    p, port = acoustic
    henc = _np(6, 2, TPH, D)
    pmask = _phoneme_mask([TPH, 7])
    va_cfg = _acoustic_cfg(jcfg).variance_adaptor
    ref = j_va.VarianceAdaptor(D, va_cfg).apply(
        {"params": p["variance_adaptor"]}, henc, 64, phoneme_mask=pmask,
        duration_scale=controls[0], pitch_shift=controls[1], energy_scale=controls[2],
    )
    out = port.variance_adaptor(torch.from_numpy(henc), 64, torch.from_numpy(pmask), *controls)
    dur = np.asarray(ref.predictions["dur"])
    assert dur.max() > 1, "durations should spread over several frames"
    np.testing.assert_array_equal(out.predictions["dur"].numpy(), dur)
    np.testing.assert_array_equal(out.total_frames.numpy(), np.asarray(ref.total_frames))
    np.testing.assert_array_equal(out.frame_mask.numpy(), np.asarray(ref.frame_mask))
    # embeddings gathered by equal integer bins + f32 predictor noise
    np.testing.assert_allclose(out.hvar.detach().numpy(), np.asarray(ref.hvar), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,t,pads", [(1, 12, {0: 10}), (3, 12, {0: 10, 1: 8}),
                                      (9, 10, {2: 7, 8: 4})], ids=["B1", "B3", "B9"])
def test_decoder_plain_f32_matches_ar_decode_packed(acoustic, b, t, pads):
    """K1's plain version with f32 weights is ar_decode_packed in f32, with
    per-row memory masks."""
    p, port = acoustic
    hvar = _np(7 + b, b, t, D)
    mask = np.zeros((b, t), bool)
    for row, start in pads.items():
        mask[row, start:] = True
    model = j_ar.PNCAARDecoder(D, MELS, _acoustic_cfg(jcfg).decoder)
    ref = j_ar.ar_decode_packed(model, {"params": p["ar_decoder"]}, hvar, t, mask)
    w = p_ar.pack_decoder(port.ar_decoder, torch.float32)
    out = p_ar.ar_decode(port.ar_decoder, torch.from_numpy(hvar), t,
                         torch.from_numpy(mask), weights=w)
    assert out.shape == (b, t, MELS)
    # 12 autoregressive steps of f32 reassociation noise
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


GEN_CFG = dict(upsample_initial_channel=64)


def test_generator_matches_flax():
    cfg_j = jcfg.GeneratorConfig(**GEN_CFG)
    mel = _np(20, 2, MELS, 8)
    model = j_hg.HiFiGANGenerator(cfg_j)
    params = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.asarray(mel)))
    ref = np.asarray(model.apply(params, jnp.asarray(mel)))
    port = HiFiGANGenerator(pcfg.GeneratorConfig(**GEN_CFG))
    port.load_state_dict(generator_state_dict_from_flax(params))
    with torch.no_grad():
        out = port(torch.from_numpy(mel), port.pack(torch.float32)).numpy()
    assert out.shape == ref.shape == (2, 1, 8 * 256)
    # tanh output; f32 conv reassociation over 4 stages
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_mrf_alone_matches_flax_including_edges():
    """The MRF function (K2's plain version, f32) against the flax MRF over
    the whole sequence: every conv zero-pads its own input at the ends."""
    c = 32
    x = _np(21, 2, 40, c)  # flax layout [B, T, C]
    model = j_hg.MRF(c)
    params = jax.device_get(model.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    port = MRF(c)
    port.load_state_dict(mrf_state_dict_from_flax(params))
    out = mrf(torch.from_numpy(x).transpose(1, 2).contiguous(), pack_mrf(port, torch.float32))
    out = out.transpose(1, 2).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    edge = np.abs(out - ref)[:, list(range(12)) + list(range(28, 40))].max()
    assert edge < 1e-5, edge
