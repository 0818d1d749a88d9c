"""The port's acoustic training forward against the JAX package's, float32 on
the CPU, at a tiny size (d 32, 2 + 2 layers, 2 heads, FFN 64, Tph 8, 48
frames): the teacher-forced `SAMBERTAcousticModel` forward in eval mode,
the variance adaptor's ground-truth branches and the four acoustic losses;
then what dropout and remat must keep, and the teacher-forced decoder
against the port's own autoregressive decode.

JAX parameters are random numpy arrays of the shapes `jax.eval_shape` gives
for `SAMBERTAcousticModel.init` (no init compile), carried into the port
with `weights.acoustic_state_dict_from_flax`; inputs come from the JAX
package's `synthetic_batch`, made with numpy from a seed.  Integer outputs
(durations, frame masks, totals) must be exactly equal; floats are within
1e-5 (f32 reassociation, oneDNN against XLA:CPU).  Dropout cannot match
JAX's bit for bit (another generator): eval mode is held against JAX and
train mode by its own properties.  The helpers are shared with
tests/test_torch_acoustic_train*.py.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.utils.checkpoint and torch.optim import torch._dynamo, and so
# cProfile, at first use
import cProfile  # noqa: F401
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.data.dataset import synthetic_batch as j_synthetic_batch
from sambert_hifigan_tpu.losses import acoustic as j_losses
from sambert_hifigan_tpu.models import acoustic_model as j_am
from sambert_hifigan_tpu.models import variance_adaptor as j_va

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
from sambert_hifigan_tpu_torch.losses import acoustic as p_losses
from sambert_hifigan_tpu_torch.models import ar_decoder as p_ar
from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel
from sambert_hifigan_tpu_torch.models.layers import dropout
from sambert_hifigan_tpu_torch.weights import acoustic_state_dict_from_flax
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

D, TPH, FRAMES = 32, 8, 48
EMBEDDINGS = ("ph_emb", "tone_emb", "boundary_emb", "pitch_emb", "energy_emb")


def acoustic_cfg(c, dropout=0.1, remat=False, **stage):
    """The tiny acoustic model in the config module `c` of either package,
    every dropout at `dropout`; `stage` overrides training.acoustic (mixed
    precision off unless given)."""
    am = c.AcousticModelConfig(
        d_model=D,
        encoder=c.EncoderConfig(n_layers=2, n_heads=2, d_ff=64, dropout=dropout, remat=remat),
        variance_adaptor=c.VarianceAdaptorConfig(predictor_dropout=dropout),
        decoder=c.DecoderConfig(n_layers=2, n_heads=2, d_ff=64, dropout=dropout, max_len=64,
                                remat=remat),
    )
    cfg = c.TTSConfig()
    tr = dataclasses.replace(cfg.training.acoustic, **{"mixed_precision": False, **stage})
    return dataclasses.replace(cfg, acoustic_model=am,
                               training=dataclasses.replace(cfg.training, acoustic=tr))


def _fill(tree, rng, name=""):
    """Random values for an abstract flax tree: embedding tables N(0, 1);
    kernels and attention matrices U(+-1/sqrt(fan_in)); LayerNorm scales
    1 + U(+-0.1); biases U(+-0.1)."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, k) for k, v in tree.items()}
    shape = tree.shape
    if name in EMBEDDINGS:
        x = rng.standard_normal(shape)
    elif name == "kernel" or name in ("wq", "wk", "wv", "wo"):
        bound = 1 / math.sqrt(math.prod(shape[:-1]))
        x = rng.uniform(-bound, bound, shape)
    elif name == "scale":
        x = 1 + rng.uniform(-0.1, 0.1, shape)
    else:
        x = rng.uniform(-0.1, 0.1, shape)
    return x.astype(np.float32)


def jax_acoustic(cfg_j, seed=0):
    """(flax SAMBERTAcousticModel, its random numpy variables)."""
    model = j_am.SAMBERTAcousticModel(cfg_j.acoustic_model)
    ph = jnp.zeros((1, TPH), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), ph, ph, ph, jnp.zeros((1, 16, 80)), jnp.ones((1, TPH), jnp.int32)))
    return model, {"params": _fill(dict(shapes["params"]), np.random.default_rng(seed))}


def port_acoustic(cfg_p, variables) -> SAMBERTAcousticModel:
    port = SAMBERTAcousticModel(cfg_p.acoustic_model)
    port.load_state_dict(acoustic_state_dict_from_flax(variables))
    return port


def make_batch(cfg, b=2, tfrm=FRAMES, seed=0, valid=None):
    """The JAX package's synthetic batch (numpy); `valid` gives each row's
    number of real phonemes (the rest padded: mask False, duration 0)."""
    batch = j_synthetic_batch(cfg, b, tph=TPH, tfrm=tfrm, seed=seed)
    batch.pop("frame_lengths")
    if valid is not None:
        mask = np.arange(TPH)[None, :] < np.asarray(valid)[:, None]
        batch["phoneme_mask"] = mask
        batch["dur_gt"] = batch["dur_gt"] * mask
    return batch


def close(ours, theirs, atol=1e-5):
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, variables, port model in eval) of the tiny config with
    dropout 0.1 everywhere."""
    cfg_j = acoustic_cfg(jcfg)
    model, variables = jax_acoustic(cfg_j)
    return model, variables, port_acoustic(acoustic_cfg(pcfg), variables).eval()


def test_synthetic_batch_matches_jax():
    cfg = acoustic_cfg(pcfg)
    ours = synthetic_batch(cfg, 3, tph=TPH, tfrm=FRAMES, seed=4)
    theirs = j_synthetic_batch(acoustic_cfg(jcfg), 3, tph=TPH, tfrm=FRAMES, seed=4)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert (ours["frame_lengths"] <= FRAMES).all()


@pytest.mark.parametrize("valid", [None, (TPH, 5)], ids=["full", "padded"])
def test_teacher_forced_forward_matches_jax(pair, valid):
    """Eval mode (no generator; the config's dropout 0.1 unused): mel_pred,
    every prediction within 1e-5; dur, frame_mask, total_frames equal."""
    model, variables, port = pair
    batch = make_batch(acoustic_cfg(pcfg), seed=1, valid=valid)
    args = [batch[k] for k in ("ph_ids", "tone_ids", "boundary_ids", "mel_gt", "dur_gt",
                               "pitch_gt", "energy_gt", "phoneme_mask")]
    ref = jax.jit(lambda v, *a: model.apply(v, *a))(variables, *args)
    t = batch_to_device(batch, "cpu")
    with torch.no_grad():
        out = port(t["ph_ids"], t["tone_ids"], t["boundary_ids"], t["mel_gt"], t["dur_gt"],
                   t["pitch_gt"], t["energy_gt"], t["phoneme_mask"])
    np.testing.assert_array_equal(out.frame_mask.numpy(), np.asarray(ref.frame_mask))
    np.testing.assert_array_equal(out.total_frames.numpy(), np.asarray(ref.total_frames))
    np.testing.assert_array_equal(out.predictions["dur"].numpy(),
                                  np.asarray(ref.predictions["dur"]))
    assert sorted(out.predictions) == sorted(ref.predictions)
    close(out.mel_pred, ref.mel_pred)
    for k in ("log_dur_pred", "pitch_tok", "pitch_frm", "energy_tok", "energy_frm"):
        close(out.predictions[k], ref.predictions[k])


@pytest.mark.parametrize("gt", ["dur", "dur+pitch+energy", "pitch+energy"])
def test_variance_adaptor_ground_truth_branches(pair, gt):
    """dur_gt expands the phonemes (the predicted durations are not used;
    padded rows keep their zero durations); pitch_gt / energy_gt choose the
    embedded bins in place of the predictions shifted and scaled by the
    controls, which they override.  hvar within 1e-5, integers equal."""
    _, variables, port = pair
    batch = make_batch(acoustic_cfg(pcfg), seed=2, valid=(TPH, 6))
    henc = np.random.default_rng(3).standard_normal((2, TPH, D)).astype(np.float32)
    kw = {}
    if "dur" in gt:
        kw["dur_gt"] = batch["dur_gt"]
    if "pitch" in gt:
        kw["pitch_gt"], kw["energy_gt"] = batch["pitch_gt"], batch["energy_gt"]
    controls = dict(duration_scale=1.3, pitch_shift=25.0, energy_scale=0.8)
    va_j = j_va.VarianceAdaptor(D, acoustic_cfg(jcfg).acoustic_model.variance_adaptor)
    ref = va_j.apply({"params": variables["params"]["variance_adaptor"]}, henc, FRAMES,
                     phoneme_mask=batch["phoneme_mask"], **kw, **controls)
    with torch.no_grad():
        out = port.variance_adaptor(
            torch.from_numpy(henc), FRAMES, torch.from_numpy(batch["phoneme_mask"]),
            controls["duration_scale"], controls["pitch_shift"], controls["energy_scale"],
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    if "dur" in gt:
        np.testing.assert_array_equal(out.predictions["dur"].numpy(), batch["dur_gt"])
    np.testing.assert_array_equal(out.predictions["dur"].numpy(),
                                  np.asarray(ref.predictions["dur"]))
    np.testing.assert_array_equal(out.frame_mask.numpy(), np.asarray(ref.frame_mask))
    np.testing.assert_array_equal(out.total_frames.numpy(), np.asarray(ref.total_frames))
    close(out.hvar, ref.hvar)


@pytest.mark.parametrize("masks", ["none", "all"])
def test_acoustic_losses_match_jax(masks):
    """The four terms and the weighted total, with and without the masks
    (mel and energy over frames, dur over phonemes, pitch over voiced
    frames), relative 1e-6; the key schema."""
    rng = np.random.default_rng(5)
    b, t = 3, 20
    arrays = dict(
        mel_pred=rng.standard_normal((b, t, 80)), mel_gt=rng.standard_normal((b, t, 80)),
        log_dur_pred=rng.standard_normal((b, TPH)), dur_gt=rng.integers(0, 6, (b, TPH)),
        pitch_pred=rng.uniform(80, 600, (b, t)), pitch_gt=rng.uniform(80, 600, (b, t)),
        energy_pred=rng.uniform(0, 1, (b, t)), energy_gt=rng.uniform(0, 1, (b, t)))
    arrays = {k: v.astype(np.int32 if k == "dur_gt" else np.float32) for k, v in arrays.items()}
    kw = {}
    if masks == "all":
        kw = dict(mel_mask=np.arange(t)[None] < np.array([[20], [13], [0]]),
                  phoneme_mask=np.arange(TPH)[None] < np.array([[8], [5], [0]]),
                  pitch_mask=rng.random((b, t)) > 0.3)
    weights = dict(mel=1.0, dur=0.5, pitch=1e-4, energy=2.0)
    total_j, ref = j_losses.acoustic_loss(**arrays, **kw, weights=jcfg.LossWeights(**weights))
    total_p, out = p_losses.acoustic_loss(
        **{k: torch.from_numpy(v) for k, v in {**arrays, **kw}.items()},
        weights=pcfg.LossWeights(**weights))
    assert sorted(out) == sorted(ref) == ["dur_loss", "energy_loss", "mel_loss", "pitch_loss",
                                          "total_loss"]
    assert torch.equal(out["total_loss"], total_p)
    for k, want in ref.items():
        want = float(want)
        assert abs(float(out[k]) - want) <= 1e-6 * abs(want), (k, float(out[k]), want)


# ---- dropout and remat -------------------------------------------------------


def _forward(model, batch, rng=None, dtype=torch.float32):
    t = batch_to_device(batch, "cpu")
    return model(t["ph_ids"], t["tone_ids"], t["boundary_ids"], t["mel_gt"], t["dur_gt"],
                 t["pitch_gt"], t["energy_gt"], t["phoneme_mask"], rng=rng, dtype=dtype)


def test_dropout_keeps_flax_semantics():
    """Each element kept with probability 1 - rate and scaled by
    1 / (1 - rate): the kept share within 5 sigma of 0.7 over 40000
    elements, kept values exactly x / 0.7; rate 0 or no generator is the
    identity; the same seed gives the same mask."""
    x = torch.rand(200, 200) + 0.5
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - 0.7) <= 5 * math.sqrt(0.21 / x.numel()), share
    assert torch.equal(y[kept], x[kept] / 0.7)
    assert dropout(x, 0.3, None) is x and dropout(x, 0.0, torch.Generator()) is x
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(0)))


def test_train_mode_draws_dropout_from_its_generator(pair):
    """A forward given a host generator applies dropout (differs from
    eval), the same seed gives the same output, another seed another; the
    integers do not depend on dropout."""
    _, _, port = pair
    batch = make_batch(acoustic_cfg(pcfg), seed=6)
    with torch.no_grad():
        ev = _forward(port, batch)
        a = _forward(port, batch, torch.Generator().manual_seed(1))
        b = _forward(port, batch, torch.Generator().manual_seed(1))
        c = _forward(port, batch, torch.Generator().manual_seed(2))
    assert torch.equal(a.mel_pred, b.mel_pred)
    for k in a.predictions:
        assert torch.equal(a.predictions[k], b.predictions[k])
    assert (a.mel_pred - ev.mel_pred).abs().max() > 1e-2
    assert (a.mel_pred - c.mel_pred).abs().max() > 1e-2
    assert torch.equal(a.total_frames, ev.total_frames)
    assert torch.equal(a.predictions["dur"], ev.predictions["dur"])


def test_remat_gradients_equal_plain_with_dropout_on():
    """Encoder and decoder layers under torch.utils.checkpoint recompute
    with the masks of their first pass: with dropout 0.3 and one seed,
    the loss and every parameter's gradient equal those without remat (to
    1e-6 of the gradient's max; the recompute repeats the same kernels)."""
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model

    grads, losses = [], []
    for remat in (False, True):
        cfg = acoustic_cfg(pcfg, dropout=0.3, remat=remat)
        model = random_acoustic_model(cfg, torch.Generator().manual_seed(3))
        out = _forward(model, make_batch(cfg, seed=7), torch.Generator().manual_seed(4))
        loss = out.mel_pred.square().mean() + sum(
            out.predictions[k].square().mean() for k in ("log_dur_pred", "pitch_frm",
                                                         "energy_frm"))
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(losses[0], losses[1])
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-6 * max(a.abs().max(), 1e-12)
    assert sum(float(g.abs().sum()) for g in grads[1]) > 0


def test_teacher_forcing_reproduces_the_autoregressive_decode(pair):
    """The port's plain `ar_decode` (K1's plain version, f32 weights), fed
    back as the ground truth, is what the teacher-forced decoder predicts,
    frame for frame, within 1e-5: the shift by a zero frame and the causal
    mask are those of the decode, with a padded memory row."""
    _, _, port = pair
    dec = port.ar_decoder
    b, t = 2, 40
    rng = np.random.default_rng(8)
    hvar = torch.from_numpy(rng.standard_normal((b, t, D)).astype(np.float32))
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[1, 27:] = True
    hvar = hvar * (~pad)[:, :, None]
    mel = p_ar.ar_decode(dec, hvar, t, pad, weights=p_ar.pack_decoder(dec, torch.float32))
    with torch.no_grad():
        tf = dec(hvar, mel, pad)
    assert tf.shape == mel.shape == (b, t, 80)
    close(tf, mel.numpy())
