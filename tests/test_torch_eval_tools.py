"""The port's offline evaluation tools (`eval_teacher_forced`, `copy_synth`,
`eval_vocoder_waveform`) against what the JAX package's scripts compute,
float32 on the CPU, on a `make_toy_dataset` corpus of 3 utterances and
tiny models with carried-over weights.

The JAX package's scripts run only at the default config, so their
computation is repeated here with the JAX package's own functions at the
tiny size: TTSDataset features (which the port then reads from the same
cache, so both sides see the same mels), `collate_acoustic`, the flax
model's deterministic teacher-forced forward and `mel_l1_loss`; the flax
generator (the JAX pipeline's fused generator differs from the flax MRF
only in its edge padding, ROADMAP Queue 3); `utils/eval_metrics`.

Bounds: teacher-forced mel L1 within 1e-4 (relative) for the EMA and the
raw weights; copy-synthesized wavs within 1e-4 of the flax generator's
(16-bit PCM files: 6e-5 of quantisation); mel-MAE, MCD and STFT-MAE within
1e-4 (relative), F0-RMSE within 1e-3 (relative), voicing F1 within 1e-3
(tests/test_torch_eval_metrics.py).
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.data import dataset as jds
from sambert_hifigan_tpu.losses.acoustic import mel_l1_loss as j_mel_l1
from sambert_hifigan_tpu.models import hifigan as j_hg
from sambert_hifigan_tpu.utils import eval_metrics as je

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import copy_synth, eval_teacher_forced, eval_vocoder_waveform
from sambert_hifigan_tpu_torch.data.audio import load_wav
from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
from sambert_hifigan_tpu_torch.models.hifigan import HiFiGAN
from sambert_hifigan_tpu_torch.training.acoustic_trainer import init_acoustic_state
from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
from sambert_hifigan_tpu_torch.training.optim import ema_copy
from sambert_hifigan_tpu_torch.training.vocoder_trainer import vocoder_state_from_model
from sambert_hifigan_tpu_torch.weights import generator_state_dict_from_flax
from tests.test_torch_acoustic_model import jax_acoustic, port_acoustic
from tests.test_torch_discriminators import (  # noqa: F401 (a fixture)
    jax_variables,
    one_torch_thread,
    tiny_voc,
)

REL, F0_REL, F1_ABS = 1e-4, 1e-3, 1e-3
KEYS = ("ph_ids", "tone_ids", "boundary_ids", "mel_gt", "dur_gt", "pitch_gt", "energy_gt",
        "phoneme_mask")


def _cfg(c):
    """The tiny acoustic model (every dropout 0) and vocoder in config
    module `c`, at the default buckets and decoder length."""
    am = c.AcousticModelConfig(
        d_model=32, encoder=c.EncoderConfig(n_layers=2, n_heads=2, d_ff=64, dropout=0.0),
        variance_adaptor=c.VarianceAdaptorConfig(predictor_dropout=0.0),
        decoder=c.DecoderConfig(n_layers=2, n_heads=2, d_ff=64, dropout=0.0))
    return dataclasses.replace(c.TTSConfig(), acoustic_model=am, vocoder=tiny_voc(c))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(metadata path, JAX dataset): the JAX package extracts the features
    into the corpus's cache, which the port's TTSDataset reads."""
    root = tmp_path_factory.mktemp("toy")
    meta = make_toy_dataset(root, n=3, seed=0, verbose=False)
    ds = jds.TTSDataset(str(meta), _cfg(jcfg))
    for utt in ds.utterances:
        ds.load_features(utt)
    return meta, ds


@pytest.fixture(scope="module")
def acoustic_ckpt(tmp_path_factory):
    """A port checkpoint whose model and EMA carry two different JAX
    weight sets; (directory, JAX model, raw variables, EMA variables)."""
    cfg_p = _cfg(pcfg)
    model_j, raw = jax_acoustic(_cfg(jcfg), seed=21)
    _, ema = jax_acoustic(_cfg(jcfg), seed=22)
    state = init_acoustic_state(port_acoustic(cfg_p, raw), cfg_p)
    state.ema = ema_copy(port_acoustic(cfg_p, ema))
    path = tmp_path_factory.mktemp("ac")
    CheckpointManager(path, cfg_p.audio).save(7, state)
    return str(path), model_j, raw, ema


def _jax_teacher_forced(corpus, model_j, variables):
    _, ds = corpus
    cfg = _cfg(jcfg)
    fwd = jax.jit(lambda v, *a: model_j.apply(v, *a, deterministic=True))
    vals = []
    for utt in ds.utterances:
        batch = jds.collate_acoustic([ds.load_features(utt)], cfg.runtime.phoneme_buckets,
                                     cfg.runtime.frame_buckets)
        out = fwd(variables, *(jnp.asarray(batch[k]) for k in KEYS))
        vals.append(float(j_mel_l1(out.mel_pred, jnp.asarray(batch["mel_gt"]),
                                   out.frame_mask)))
    return vals


@pytest.mark.parametrize("params", ["ema", "raw"])
def test_eval_teacher_forced_matches_jax(corpus, acoustic_ckpt, params):
    meta, _ = corpus
    path, model_j, raw, ema = acoustic_ckpt
    step, which, vals = eval_teacher_forced.teacher_forced_mel_l1(
        _cfg(pcfg), str(meta), path, params=params, device="cpu")
    assert (step, which) == (7, params) and len(vals) == 3
    want = _jax_teacher_forced(corpus, model_j, ema if params == "ema" else raw)
    np.testing.assert_allclose([v for _, v in vals], want, rtol=REL, atol=0)


def test_eval_teacher_forced_entry_point(corpus, acoustic_ckpt, tmp_path, capsys):
    import yaml

    meta, _ = corpus
    path = acoustic_ckpt[0]
    yml = tmp_path / "model.yaml"
    yml.write_text(yaml.safe_dump({"acoustic_model": {
        "d_model": 32, "encoder": {"n_layers": 2, "n_heads": 2, "d_ff": 64, "dropout": 0.0},
        "decoder": {"n_layers": 2, "n_heads": 2, "d_ff": 64, "dropout": 0.0}}}))
    out = eval_teacher_forced.main(["--metadata", str(meta), "--acoustic-checkpoint", path,
                                    "--model-config", str(yml), "--n", "2", "--params", "raw",
                                    "--device", "cpu"])
    assert out["step"] == 7 and out["params"] == "raw" and len(out["values"]) == 2
    assert "mean tf mel L1" in capsys.readouterr().out


@pytest.fixture(scope="module")
def vocoder_ckpt(tmp_path_factory):
    """A port vocoder checkpoint whose generator and EMA generator carry two
    JAX weight sets; (directory, flax generator, raw, EMA variables)."""
    cfg_p = _cfg(pcfg)
    jgen = j_hg.HiFiGANGenerator(tiny_voc(jcfg).generator)
    raw, ema = (jax_variables(jgen, s, jnp.zeros((1, 80, 8))) for s in (31, 32))
    model = HiFiGAN(cfg_p.vocoder)
    model.generator.load_state_dict(generator_state_dict_from_flax(raw))
    state = vocoder_state_from_model(model, cfg_p)
    state.g_ema = ema_copy(model.generator)
    state.g_ema.load_state_dict(generator_state_dict_from_flax(ema))
    path = tmp_path_factory.mktemp("voc")
    CheckpointManager(path, cfg_p.audio).save(5, state)
    return str(path), jgen, raw, ema


@pytest.fixture(scope="module")
def copies(corpus, vocoder_ckpt, tmp_path_factory):
    """{params: (output directory, written [(path, samples)])}."""
    meta, _ = corpus
    out = {}
    for params in ("auto", "raw"):
        d = tmp_path_factory.mktemp(f"copy_{params}")
        step, which, written = copy_synth.copy_synthesize(
            _cfg(pcfg), str(meta), vocoder_ckpt[0], str(d), params=params, device="cpu")
        assert step == 5 and which == ("ema" if params == "auto" else "raw")
        out[params] = (d, written)
    return out


@pytest.mark.parametrize("params", ["auto", "raw"])
def test_copy_synth_matches_the_flax_generator(corpus, vocoder_ckpt, copies, params):
    _, ds = corpus
    _, jgen, raw, ema = vocoder_ckpt
    variables = ema if params == "auto" else raw
    d, written = copies[params]
    assert len(written) == 3
    for utt, (path, samples) in zip(ds.utterances, written):
        mel = ds.load_features(utt)["mel"]  # [T, n_mels]
        want = np.asarray(jax.jit(jgen.apply)(variables, mel.T[None]))[0, 0]
        got, sr = load_wav(path)
        assert path == Path(d) / f"{Path(utt.wav_path).stem}_copy.wav"
        assert sr == 22050 and got.shape == (1, samples) and samples == mel.shape[0] * 256
        np.testing.assert_allclose(got[0], want, atol=1e-4, rtol=0)


def test_copy_synth_entry_point(corpus, vocoder_ckpt, tmp_path, capsys):
    import yaml

    meta, _ = corpus
    yml = tmp_path / "model.yaml"
    yml.write_text(yaml.safe_dump({"vocoder": {"generator": {
        "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 3]]}}}))
    written = copy_synth.main(["--metadata", str(meta), "--vocoder-checkpoint", vocoder_ckpt[0],
                               "--output-dir", str(tmp_path / "out"), "--n", "1",
                               "--model-config", str(yml), "--device", "cpu"])
    assert len(written) == 1 and written[0][0].exists()
    assert "params: ema" in capsys.readouterr().out


def test_eval_vocoder_waveform_matches_jax(corpus, copies, capsys):
    """Both copy syntheses scored against the corpus's recordings, by the
    port's tool and by the JAX script's loop over its metric functions."""
    meta, _ = corpus
    gt_dir = Path(meta).parent / "wavs"
    systems = [(p, d) for p, (d, _) in copies.items()]
    ours = eval_vocoder_waveform.score_systems(pcfg.TTSConfig(), gt_dir, systems,
                                               device="cpu")
    audio = jcfg.TTSConfig().audio
    for label, d in systems:
        mm, mc, sm, fr, vf = [], [], [], [], []
        for g in sorted(gt_dir.glob("utt_*.wav")):
            gt, syn = load_wav(g)[0][0], load_wav(d / f"{g.stem}_copy.wav")[0][0]
            mm.append(je.mel_mae(gt, syn, audio))
            mc.append(je.mcd(gt, syn, audio))
            sm.append(je.stft_logmag_mae(gt, syn))
            f0m = je.f0_metrics(gt, syn, audio)
            if np.isfinite(f0m["f0_rmse_hz"]):
                fr.append(f0m["f0_rmse_hz"])
            vf.append(f0m["voicing_f1"])
        s = ours[label]
        assert s["utterances"] == 3
        np.testing.assert_allclose([s["mel_mae"], s["mcd"], s["stft_mae"]],
                                   [np.mean(mm), np.mean(mc), np.mean(sm)], rtol=REL)
        assert (s["f0_rmse"] is None) == (not fr)
        if fr:
            np.testing.assert_allclose(s["f0_rmse"], np.mean(fr), rtol=F0_REL)
        assert abs(s["voicing_f1"] - np.mean(vf)) <= F1_ABS
    eval_vocoder_waveform.main(["--gt-dir", str(gt_dir), "--syn-dir", f"auto={systems[0][1]}",
                                "--device", "cpu"])
    assert "3 matched utterances" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no matched utterances"):
        eval_vocoder_waveform.main(["--gt-dir", str(gt_dir), "--syn-dir",
                                    f"auto={systems[0][1]}", "--suffix", "_none",
                                    "--device", "cpu"])
