"""The port's slice as a whole, text -> wav, against the JAX package on the
CPU, and the port's import and device rules.

The JAX pipeline is built from a seed; its weights are carried into the port
with `sambert_hifigan_tpu_torch.weights`, and both synthesize the same texts
through `synthesize_batch` (B = 3, padded to batch bucket 4).  The duration
predictor's output bias is raised so one text overflows its first frame
bucket and both pipelines take the re-run.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.pipeline import build_pipeline_from_random_init as j_build

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import inference
from sambert_hifigan_tpu_torch import pipeline as pipeline_mod
from sambert_hifigan_tpu_torch.pipeline import TTSPipeline, build_pipeline_from_random_init
from sambert_hifigan_tpu_torch.weights import (
    acoustic_state_dict_from_flax,
    generator_state_dict_from_flax,
)

REPO = Path(__file__).resolve().parent.parent
TEXTS = ["你好", "今天天气", "abc"]


def _small_cfg(c):
    return c.TTSConfig(
        acoustic_model=c.AcousticModelConfig(
            d_model=32,
            encoder=c.EncoderConfig(n_layers=2, n_heads=4, d_ff=64),
            decoder=c.DecoderConfig(n_layers=2, n_heads=4, d_ff=64, max_len=256),
        ),
        vocoder=c.VocoderConfig(generator=c.GeneratorConfig(upsample_initial_channel=64)),
        runtime=c.RuntimeConfig(phoneme_buckets=(8, 16), frame_buckets=(96, 160)),
    )


@pytest.fixture(scope="module")
def pipelines():
    jp = j_build(_small_cfg(jcfg), 0)
    ap = jax.device_get(jp.acoustic_params)
    gp = jax.device_get(jp.generator_params)
    # ~15 frames a phoneme: the second text needs 106 frames, over the 96
    # that the first pass estimates for its phoneme bucket
    lin = ap["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    lin["bias"] = np.full_like(lin["bias"], 2.9)
    lin["kernel"] = lin["kernel"] * 0.1
    jp.acoustic_params = jax.tree.map(jnp.asarray, ap)
    pp = TTSPipeline(
        _small_cfg(pcfg), acoustic_state_dict_from_flax(ap),
        generator_state_dict_from_flax(gp), device="cpu",
    )
    return jp, pp


def test_slice_matches_jax_pipeline(pipelines):
    jp, pp = pipelines
    padded = TEXTS + [TEXTS[-1]]  # the batch bucket synthesize_batch pads to
    jo = jp.text_to_mel(padded, max_frames=160)
    po = pp.text_to_mel(padded, max_frames=160)
    totals = np.asarray(jo.total_frames)
    np.testing.assert_array_equal(po.total_frames.numpy(), totals)
    np.testing.assert_array_equal(po.frame_mask.numpy(), np.asarray(jo.frame_mask))
    assert totals.max() > 96, "one text must overflow the first frame bucket"
    # f32 decode of 160 autoregressive steps, reassociation noise only
    np.testing.assert_allclose(po.mel_pred.numpy(), np.asarray(jo.mel_pred), atol=1e-4, rtol=0)

    jw = jp.synthesize_batch(TEXTS)
    pw = pp.synthesize_batch(TEXTS)
    assert [len(w) for w in pw] == [len(w) for w in jw] == [int(t) * 256 for t in totals[:3]]
    for a, b in zip(pw, jw):
        # tanh waveform through the f32 decode and four generator stages
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
    one = pp.synthesize(TEXTS[0])
    np.testing.assert_allclose(one, pw[0], atol=1e-5, rtol=0)


def test_pipeline_computes_without_tf32(pipelines, monkeypatch):
    """The plain layers around the kernels run in IEEE f32 whatever the
    caller's TF32 settings, and those settings come back afterwards."""
    _, pp = pipelines
    seen = []

    def spy(fn):
        def call(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(pipeline_mod, "acoustic_inference", spy(pipeline_mod.acoustic_inference))
    monkeypatch.setattr(pp.generator, "forward", spy(pp.generator.forward))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    pp.synthesize(TEXTS[0])
    assert len(seen) >= 2 and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_imports_no_jax_flax_yaml_or_jax_package():
    """The port and chip_smoke.py import torch and numpy, never JAX, flax,
    yaml (only inside load_config) or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sambert_hifigan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'yaml', 'sambert_hifigan_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    # a fresh interpreter: this process has imported jax already
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.split()[-1]) >= 20  # every submodule was imported


def test_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_cfg(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline_from_random_init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--text", "你好", "--output", str(tmp_path / "a.wav")])
    pipe = build_pipeline_from_random_init(cfg, seed=0, device="cpu")
    assert pipe.device.type == "cpu"
    wav = pipe.synthesize("你好")
    assert wav.ndim == 1 and wav.size % 256 == 0 and np.isfinite(wav).all()
