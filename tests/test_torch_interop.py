"""The port's reference-checkpoint interop (interop.py, `python -m
sambert_hifigan_tpu_torch.convert_torch_checkpoint`) against the JAX
package's, float32 on the CPU, at a tiny size.

No reference checkpoint exists here, so reference-format state dicts are
made from the JAX models' flax trees (random numpy values of the shapes
`jax.eval_shape` gives) through the inverse of interop.py's primitive
transforms: Linear, Conv1d, the tap-flipped ConvTranspose1d, weight norm's
g/v, spectral norm's weight_orig/u/v and the packed MHA in_proj.

* The inverse round-trips exactly: the JAX package's converters and the
  port's copy give back the flax tree, bit for bit.
* The JAX interop -> flax -> JAX model and the port's interop -> port model
  give the same outputs within the existing parity bounds: the acoustic
  model's teacher-forced mel within 1e-5
  (tests/test_torch_acoustic_model.py), the generator's wav and every
  discriminator output within 1e-5 of the largest value
  (tests/test_torch_discriminators.py), for `acoustic`, `hifigan` (weight
  and spectral norm) and a bare `generator`.
* The converter's checkpoint (nested under 'state_dict', 'model' or
  'generator', or bare) loads in `inference --device cpu`, and a
  mismatched --model is refused with the JAX script's message.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu import interop as j_interop
from sambert_hifigan_tpu.models import hifigan as j_hg

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import convert_torch_checkpoint, inference
from sambert_hifigan_tpu_torch import interop as p_interop
from sambert_hifigan_tpu_torch.data.audio import load_wav
from sambert_hifigan_tpu_torch.data.dataset import batch_to_device
from sambert_hifigan_tpu_torch.models import hifigan as p_hg
from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel
from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_acoustic_model import acoustic_cfg, jax_acoustic, make_batch
from tests.test_torch_discriminators import (  # noqa: F401 (a fixture)
    _close,
    jax_variables,
    jax_vocoder,
    one_torch_thread,
    tiny_voc,
)

# ---- the inverse of interop.py's primitive transforms --------------------------


def _linear(sd, name, p):
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv1d(sd, name, p):
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).transpose(2, 1, 0))
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv_transpose1d(sd, name, p):
    # effective conv [K, C_in, C_out] with taps flipped -> torch [C_in, C_out, K]
    w = np.asarray(p["kernel"])[::-1].transpose(1, 2, 0)
    sd[f"{name}.weight"] = np.ascontiguousarray(w)
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv_wn(sd, name, p):
    v = np.asarray(p["kernel_wn"]["v"])
    order = (2, 1, 0) if v.ndim == 3 else (3, 2, 0, 1)
    sd[f"{name}.weight_v"] = np.ascontiguousarray(v.transpose(order))
    g = np.asarray(p["kernel_wn"]["g"])
    sd[f"{name}.weight_g"] = g.reshape((-1,) + (1,) * (v.ndim - 1))
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv_sn(sd, name, p, s):
    k = np.asarray(p["kernel"])
    order = (2, 1, 0) if k.ndim == 3 else (3, 2, 0, 1)
    sd[f"{name}.weight_orig"] = np.ascontiguousarray(k.transpose(order))
    sd[f"{name}.weight_u"] = np.asarray(s["u"])
    sd[f"{name}.weight_v"] = np.asarray(s["v"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _layer_norm(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _mha(sd, name, p):
    sd[f"{name}.in_proj_weight"] = np.concatenate([np.asarray(p[w]).T for w in ("wq", "wk", "wv")])
    sd[f"{name}.in_proj_bias"] = np.concatenate([np.asarray(p[b]) for b in ("bq", "bk", "bv")])
    sd[f"{name}.out_proj.weight"] = np.ascontiguousarray(np.asarray(p["wo"]).T)
    sd[f"{name}.out_proj.bias"] = np.asarray(p["bo"])


def _layers(tree, prefix):
    n = 0
    while f"{prefix}{n}" in tree:
        yield n, tree[f"{prefix}{n}"]
        n += 1


def acoustic_to_torch(params):
    """flax SAMBERTAcousticModel params -> the reference's state_dict."""
    p = params.get("params", params)
    sd = {f"phoneme_embedding.{n}.weight": np.asarray(p["phoneme_embedding"][n])
          for n in ("ph_emb", "tone_emb", "boundary_emb")}
    enc = p["bert_encoder"]
    for i, lp in _layers(enc, "layer_"):
        pre = f"bert_encoder.encoder.layers.{i}"
        _mha(sd, f"{pre}.self_attn", lp["self_attn"])
        for n in ("norm1", "norm2"):
            _layer_norm(sd, f"{pre}.{n}", lp[n])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{pre}.{n}", lp["ffn"][n])
    _layer_norm(sd, "bert_encoder.encoder.norm", enc["final_norm"])
    va = p["variance_adaptor"]
    for pred, name in (("duration_predictor", "duration_predictor"),
                       ("pitch_predictor", "pitch_predictor.predictor"),
                       ("energy_predictor", "energy_predictor.predictor")):
        for i, cp in _layers(va[pred], "conv_"):
            _conv1d(sd, f"variance_adaptor.{name}.conv_layers.{i}", cp)
            _layer_norm(sd, f"variance_adaptor.{name}.layer_norms.{i}", va[pred][f"norm_{i}"])
        _linear(sd, f"variance_adaptor.{name}.linear", va[pred]["linear"])
    sd["variance_adaptor.pitch_predictor.pitch_emb.weight"] = np.asarray(va["pitch_emb"])
    sd["variance_adaptor.energy_predictor.energy_emb.weight"] = np.asarray(va["energy_emb"])
    dec = p["ar_decoder"]
    _linear(sd, "ar_decoder.prenet.0", dec["prenet1"])
    _linear(sd, "ar_decoder.prenet.3", dec["prenet2"])
    _linear(sd, "ar_decoder.mel_proj", dec["mel_proj"])
    for i, lp in _layers(dec, "layer_"):
        pre = f"ar_decoder.decoder.layers.{i}"
        _mha(sd, f"{pre}.self_attn", lp["self_attn"])
        _mha(sd, f"{pre}.multihead_attn", lp["cross_attn"])
        for n in ("norm1", "norm2", "norm3"):
            _layer_norm(sd, f"{pre}.{n}", lp[n])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{pre}.{n}", lp["ffn"][n])
    return sd


def generator_to_torch(p, prefix=""):
    sd = {}
    _conv1d(sd, f"{prefix}conv_pre", p["conv_pre"])
    _conv1d(sd, f"{prefix}conv_post", p["conv_post"])
    for i, up in _layers(p, "up_"):
        _conv_transpose1d(sd, f"{prefix}ups.{i}", up)
        for j, rb in _layers(p[f"mrf_{i}"], "resblock_"):
            for k, _ in _layers(rb, "conv1_"):
                for c in ("1", "2"):
                    _conv1d(sd, f"{prefix}mrfs.{i}.resblocks.{j}.convs{c}.{k}", rb[f"conv{c}_{k}"])
    return sd


def critics_to_torch(p, prefix, names, spectral=None):
    """MSD (disc_i) or MPD (disc_p<period>) params, weight- or spectral-normed."""
    sd = {}
    for i, name in enumerate(names):
        convs = [(f"convs.{j}", f"conv_{j}") for j, _ in _layers(p[name], "conv_")]
        for ours, theirs in convs + [("conv_post", "conv_post")]:
            key = f"{prefix}discriminators.{i}.{ours}"
            if spectral is None:
                _conv_wn(sd, key, p[name][theirs])
            else:
                _conv_sn(sd, key, p[name][theirs], spectral[name][theirs])
    return sd


def hifigan_to_torch(variables, voc):
    p, s = variables["params"], variables.get("spectral", {})
    msd_names = [f"disc_{i}" for i in range(voc.discriminator.msd_scales)]
    mpd_names = [f"disc_p{q}" for q in voc.discriminator.mpd_periods]
    sd = generator_to_torch(p["generator"], "generator.")
    sd.update(critics_to_torch(p["msd"], "msd.", msd_names, s.get("msd")))
    sd.update(critics_to_torch(p["mpd"], "mpd.", mpd_names, s.get("mpd")))
    return sd


def generator_sizes(voc):
    g = voc.generator
    return dict(n_stages=len(g.upsample_rates), n_resblocks=len(g.resblock_kernel_sizes),
                n_dilations=len(g.resblock_dilation_sizes[0]))


def _assert_trees_equal(ours, theirs, path=""):
    assert sorted(ours) == sorted(theirs), path
    for k, v in theirs.items():
        if isinstance(v, dict):
            _assert_trees_equal(ours[k], v, f"{path}/{k}")
        else:
            a, b = np.asarray(ours[k]), np.asarray(v)
            assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), f"{path}/{k}"


# ---- models --------------------------------------------------------------------


@pytest.fixture(scope="module")
def acoustic():
    """(JAX model, variables, the reference-format state_dict, port config)."""
    cfg_j = acoustic_cfg(jcfg, dropout=0.0)
    model, variables = jax_acoustic(cfg_j, seed=11)
    return model, variables, acoustic_to_torch(variables), acoustic_cfg(pcfg, dropout=0.0)


@pytest.fixture(scope="module", params=[False, True], ids=["weight-norm", "spectral-norm"])
def vocoder(request):
    """(JAX HiFiGAN, variables, the reference-format state_dict, JAX and
    port configs), critics weight- or spectral-normed."""
    voc_j = tiny_voc(jcfg, spectral=request.param)
    model, variables = jax_vocoder(voc_j, seed=12)
    return model, variables, hifigan_to_torch(variables, voc_j), voc_j, tiny_voc(
        pcfg, spectral=request.param)


def test_acoustic_inverse_round_trips_exactly(acoustic):
    _, variables, sd, cfg = acoustic
    am = cfg.acoustic_model
    kw = dict(n_encoder_layers=am.encoder.n_layers, n_decoder_layers=am.decoder.n_layers)
    _assert_trees_equal(j_interop.acoustic_params_from_torch(sd, **kw), variables["params"])
    _assert_trees_equal(p_interop.acoustic_params_from_torch(sd, **kw), variables["params"])


def test_vocoder_inverse_round_trips_exactly(vocoder):
    _, variables, sd, voc_j, _ = vocoder
    periods = voc_j.discriminator.mpd_periods
    p = variables["params"]
    for interop in (j_interop, p_interop):
        _assert_trees_equal(interop.generator_params_from_torch(
            sd, "generator.", **generator_sizes(voc_j)), p["generator"])
        if "spectral" in variables:
            msd = interop.msd_spectral_params_from_torch(sd, "msd.")
            mpd = interop.mpd_spectral_params_from_torch(sd, "mpd.", periods)
            _assert_trees_equal(msd[1], variables["spectral"]["msd"])
            _assert_trees_equal(mpd[1], variables["spectral"]["mpd"])
            msd, mpd = msd[0], mpd[0]
        else:
            msd = interop.msd_params_from_torch(sd, "msd.")
            mpd = interop.mpd_params_from_torch(sd, "mpd.", periods)
        _assert_trees_equal(msd, p["msd"])
        _assert_trees_equal(mpd, p["mpd"])


def test_acoustic_outputs_match_the_jax_interop(acoustic):
    """The teacher-forced mel of the JAX model on the JAX interop's tree and
    of the port's model on the port's interop, within 1e-5."""
    model_j, _, sd, cfg = acoustic
    am = cfg.acoustic_model
    params = {"params": j_interop.acoustic_params_from_torch(
        sd, n_encoder_layers=am.encoder.n_layers, n_decoder_layers=am.decoder.n_layers)}
    port = SAMBERTAcousticModel(am)
    port.load_state_dict(p_interop.acoustic_state_dict_from_torch(sd, cfg))
    port.eval()
    batch = make_batch(cfg, seed=13, valid=(8, 5))
    keys = ("ph_ids", "tone_ids", "boundary_ids", "mel_gt", "dur_gt", "pitch_gt", "energy_gt",
            "phoneme_mask")
    theirs = jax.jit(lambda p, *a: model_j.apply(p, *a, deterministic=True))(
        params, *(jnp.asarray(batch[k]) for k in keys))
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        ours = port(*(tb[k] for k in keys))
    np.testing.assert_allclose(ours.mel_pred.numpy(), np.asarray(theirs.mel_pred), atol=1e-5,
                               rtol=0)
    assert np.array_equal(ours.frame_mask.numpy(), np.asarray(theirs.frame_mask))


def test_vocoder_outputs_match_the_jax_interop(vocoder):
    """The generator's wav and every discriminator output (real and fake)
    of the JAX HiFiGAN on the JAX interop's trees and of the port's on the
    port's interop, within 1e-5 of the largest value; the bare generator
    path too."""
    model_j, variables, sd, voc_j, voc_p = vocoder
    cfg = pcfg.TTSConfig(vocoder=voc_p)
    periods = voc_j.discriminator.mpd_periods
    spectral = "spectral" in variables
    if spectral:
        msd, msd_s = j_interop.msd_spectral_params_from_torch(sd, "msd.")
        mpd, mpd_s = j_interop.mpd_spectral_params_from_torch(sd, "mpd.", periods)
    else:
        msd = j_interop.msd_params_from_torch(sd, "msd.")
        mpd = j_interop.mpd_params_from_torch(sd, "mpd.", periods)
    jvars = {"params": {"generator": j_interop.generator_params_from_torch(
        sd, "generator.", **generator_sizes(voc_j)), "msd": msd, "mpd": mpd}}
    if spectral:
        jvars["spectral"] = {"msd": msd_s, "mpd": mpd_s}
    port = p_hg.HiFiGAN(voc_p)
    port.load_state_dict(p_interop.hifigan_state_dict_from_torch(sd, cfg))
    mel = np.random.default_rng(14).standard_normal((2, 80, 8)).astype(np.float32)
    wav_j = np.asarray(jax.jit(lambda v, m: model_j.apply(v, m))(jvars, mel))
    with torch.no_grad():
        wav_p = port.generator(torch.from_numpy(mel))
    _close(wav_p.numpy(), wav_j, 1e-5)
    gen_only = p_hg.HiFiGANGenerator(voc_p.generator)
    gen_only.load_state_dict(p_interop.generator_state_dict_from_torch(
        {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}, cfg))
    with torch.no_grad():
        assert torch.equal(gen_only(torch.from_numpy(mel)), wav_p)

    real = np.random.default_rng(15).standard_normal((2, 1, 8 * 256)).astype(np.float32) * 0.1
    kwargs = {"mutable": ["spectral"]} if spectral else {}
    theirs = jax.jit(lambda v, a, b: model_j.apply(
        v, a, b, method=j_hg.HiFiGAN.discriminate, **kwargs))(jvars, real, wav_j)
    theirs = theirs[0] if spectral else theirs
    with torch.no_grad():
        ours = port.discriminate(torch.from_numpy(real), torch.from_numpy(wav_j),
                                 advance=spectral)
    for i in (0, 2, 4, 6):  # logits
        for o, t in zip(ours[i], theirs[i]):
            _close(o.numpy(), t, 1e-5)
    for i in (1, 3, 5, 7):  # feature maps
        for critic_o, critic_t in zip(ours[i], theirs[i]):
            assert len(critic_o) == len(critic_t)
            for o, t in zip(critic_o, critic_t):
                _close(o.numpy(), t, 1e-5)


# ---- the converter's command line ------------------------------------------------


def _tiny_model_config(path):
    path.write_text(yaml.safe_dump({
        "acoustic_model": {"d_model": 32, "encoder": {"n_layers": 2, "n_heads": 2, "d_ff": 64},
                           "decoder": {"n_layers": 2, "n_heads": 2, "d_ff": 64}},
        "vocoder": {"generator": {"upsample_initial_channel": 32,
                                  "resblock_kernel_sizes": [3],
                                  "resblock_dilation_sizes": [[1, 3]]},
                    "discriminator": {"channel_div": 16}}}))
    return str(path)


@pytest.mark.parametrize("nest", [None, "state_dict", "model", "generator"])
def test_converted_checkpoints_load_in_inference(tmp_path, capsys, acoustic, nest):
    """Convert a reference-format acoustic model and a bare generator (each
    nested under `nest`, or not), then synthesize from both checkpoints with
    `inference --device cpu`; the carried weights are the ones loaded."""
    model_cfg = _tiny_model_config(tmp_path / "model.yaml")
    cfg = pcfg.load_config(None, model_cfg)
    _, _, ac_sd, _ = acoustic
    voc_j = jcfg.load_config(None, model_cfg).vocoder
    jgen = j_hg.HiFiGANGenerator(voc_j.generator)
    gen_sd = generator_to_torch(jax_variables(jgen, 16, jnp.zeros((1, 80, 8)))["params"])

    def save(sd, name):
        tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        path = tmp_path / name
        torch.save(tensors if nest is None else {nest: tensors, "epoch": 3}, path)
        return str(path)

    ac, voc = str(tmp_path / "ac"), str(tmp_path / "voc")
    convert_torch_checkpoint.main(["--model", "acoustic", "--input", save(ac_sd, "a.pt"),
                                   "--output", ac, "--model-config", model_cfg])
    convert_torch_checkpoint.main(["--model", "generator", "--input", save(gen_sd, "g.pt"),
                                   "--output", voc, "--model-config", model_cfg])
    assert CheckpointManager(ac, cfg.audio).all_steps() == [0]
    tree, _ = CheckpointManager(voc, cfg.audio).restore_tree()
    want = p_interop.generator_state_dict_from_torch(gen_sd, cfg)
    assert all(torch.equal(tree["generator"][k], v) for k, v in want.items())
    out = tmp_path / "out.wav"
    inference.main(["--text", "你好", "--output", str(out), "--device", "cpu",
                    "--model-config", model_cfg, "--acoustic-checkpoint", ac,
                    "--vocoder-checkpoint", voc])
    wav, sr = load_wav(str(out))
    assert sr == cfg.audio.sample_rate and wav.size > 0 and wav.size % cfg.audio.hop_length == 0
    assert "[convert] wrote acoustic checkpoint" in capsys.readouterr().out


def test_converter_refuses_the_wrong_model(tmp_path, acoustic):
    _, _, ac_sd, _ = acoustic
    path = tmp_path / "a.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ac_sd.items()}, path)
    with pytest.raises(SystemExit, match="does not look like a reference-format 'hifigan'"):
        convert_torch_checkpoint.main(["--model", "hifigan", "--input", str(path),
                                       "--output", str(tmp_path / "out")])
