"""The port's vocoder train step against the JAX package's under the step's
options, on the CPU: a spectral-norm discriminator; d_update_every,
accumulate_steps and the EMA together over three steps; and one bf16
mixed-precision step.  Same weights, batches and bounds as
tests/test_torch_vocoder_train.py (split from it so that the suite's
workers compile the JAX steps in parallel).
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import numpy as np
import pytest
import torch

from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_vocoder_train import (
    Pair,
    _numpy,
    assert_metrics_match,
    assert_params_match,
    batches,
)


def test_spectral_norm_step_matches_jax():
    """adv_mel_fm with spectral norm in MSD and MPD: metrics, post-step
    parameters, and the u, v that the D pass advanced (twice per critic)
    and the G pass left alone."""
    pair = Pair("adv_mel_fm", spectral=True, seed=4)
    (_, (mel, wav)), = batches(1, seed=4)
    mj, mp = pair.run(mel, wav)
    assert_metrics_match(mj, mp)
    assert_params_match(_numpy(pair.state_p.model.state_dict()), pair.jax_state_dict(),
                        pair.applied_grads(), pair.lrs())


def test_update_gating_accumulation_and_ema_match_jax():
    """d_update_every = 2, accumulate_steps = 2, ema_decay = 0.9 and a D
    rate of half G's, three steps.  G applies its one update at step 1 (the
    mean of steps 0 and 1); D's updates are gated to steps 0 and 2, so its
    accumulation applies at step 2.  Before its update a side has not moved
    by a bit on either side; the metrics match at every step (lr counts
    applied updates); after step 2 each side has made one applied update,
    held as a single step is, and so is the EMA of the generator."""
    stage = dict(d_update_every=2, accumulate_steps=2, ema_decay=0.9,
                 learning_rate_discriminator=1e-4)
    pair = Pair("adv_mel", stage=stage, seed=5)
    before = _numpy(pair.state_p.model.state_dict())
    theirs_before = pair.jax_state_dict()
    for k in before:
        np.testing.assert_array_equal(before[k], theirs_before[k])
    for i, (mel, wav) in batches(3, seed=5):
        mj, mp = pair.run(mel, wav)
        assert_metrics_match(mj, mp)
        ours, theirs = _numpy(pair.state_p.model.state_dict()), pair.jax_state_dict()
        still = {0: ("generator", "msd", "mpd"), 1: ("msd", "mpd")}.get(i, ())
        for k, v in ours.items():
            if k.split(".")[0] in still:
                np.testing.assert_array_equal(v, before[k])
                np.testing.assert_array_equal(theirs[k], before[k])
    assert [len(pair.grads["g"]), len(pair.grads["d"])] == [3, 2]
    # the last recorded G gradient starts G's next accumulation: leave it out
    pair.grads["g"] = pair.grads["g"][:2]
    grads = pair.applied_grads()
    assert_params_match(ours, theirs, grads, pair.lrs())
    ema = _numpy(pair.state_p.g_ema.state_dict())
    assert_params_match({f"generator.{k}": v for k, v in ema.items()},
                        {f"generator.{k}": v for k, v in pair.jax_ema_state_dict().items()},
                        grads, pair.lrs())


@pytest.mark.parametrize("mode", ["mel_only", "adv_mel_fm"])
def test_bf16_step_stays_near_jax(mode):
    """mixed_precision: G and D compute in bf16 on both sides, losses and
    optimizers in f32, parameters stay f32.  The packages round in the same
    places but sum in other orders (oneDNN against XLA:CPU), so the
    waveform departs by ~1e-3 and the bound is loose: every loss metric
    within 2e-2 (relative) and the grad norms within 5e-2.  Except G's grad
    norm in adv_mel_fm: there the MR-STFT term's d log|X| = dX / |X| in the
    smallest bins makes it chaotic in the waveform, and it is only checked
    finite.  Measured on this batch: 442.5 in f32 on both sides; in bf16
    1398 (JAX) and 350.9 (port); mel_only's 313.2 and 312.3 agree."""
    pair = Pair(mode, stage={"mixed_precision": True}, seed=6)
    (_, (mel, wav)), = batches(1, seed=6)
    mj, mp = pair.run(mel, wav)
    assert all(np.isfinite(v) for v in mp.values()) and mp["g_grad_norm"] > 0
    if mode == "adv_mel_fm":
        mj.pop("g_grad_norm")
        mp.pop("g_grad_norm")
    assert_metrics_match(mj, mp, rel=2e-2, rel_norms=5e-2)
    assert all(p.dtype == torch.float32 for p in pair.state_p.model.parameters())


@pytest.mark.parametrize("save", ["f32", "bf16"])
def test_options_survive_a_checkpoint(tmp_path, save):
    """Accumulation half-way (one micro-step in G's buffer) and the EMA
    survive save and restore: the next step from the restored state equals
    the next step from the original, metrics and parameters (f32 save),
    or to bf16 rounding of the discriminators' state (bf16 save)."""
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
        init_vocoder_state,
        make_vocoder_step,
    )
    from tests.test_torch_vocoder_train import configs

    _, cfg = configs("adv_mel", stage=dict(accumulate_steps=2, ema_decay=0.9))
    state = init_vocoder_state(cfg, torch.Generator().manual_seed(7), "cpu")
    step = make_vocoder_step(cfg)
    (_, (mel0, wav0)), (_, (mel1, wav1)) = batches(2, seed=7)
    step(state, torch.from_numpy(mel0), torch.from_numpy(wav0))
    ckpt = CheckpointManager(tmp_path, cfg.audio)
    ckpt.save(1, state, precision=save)
    fresh = init_vocoder_state(cfg, torch.Generator().manual_seed(8), "cpu")
    ckpt.restore(fresh)
    a = step(state, torch.from_numpy(mel1), torch.from_numpy(wav1))
    b = step(fresh, torch.from_numpy(mel1), torch.from_numpy(wav1))
    rel = 0.0 if save == "f32" else 2e-2
    for k in a:
        assert abs(float(a[k]) - float(b[k])) <= rel * abs(float(a[k])), k
    if save == "f32":
        for x, y in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
            assert torch.equal(x, y)
        for x, y in zip(state.g_ema.parameters(), fresh.g_ema.parameters()):
            assert torch.equal(x, y)


def test_train_vocoder_from_metadata(tmp_path):
    """`train_vocoder --metadata` on a toy corpus (6 utterances), the tiny
    vocoder on the CPU, batch 2 of 8-frame crops: trains 2 steps to a
    checkpoint, and --prefetch on and off log the same metrics and train
    the same weights, bit for bit."""
    import json

    from sambert_hifigan_tpu_torch import train_vocoder
    from sambert_hifigan_tpu_torch.config import load_config
    from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
    from tests.test_torch_vocoder_train import _tiny_model_config

    meta = str(make_toy_dataset(tmp_path / "toy", n=6, seed=4, verbose=False))
    model_cfg = _tiny_model_config(tmp_path / "model.yaml")
    cfg = load_config(None, model_cfg)
    logs, states = {}, {}
    for mode in ("on", "off"):
        states[mode] = train_vocoder.main([
            "--metadata", meta, "--steps", "2", "--device", "cpu", "--model-config", model_cfg,
            "--batch-size", "2", "--segment-frames", "8", "--prefetch", mode,
            "--checkpoint-dir", str(tmp_path / mode), "--log-dir", str(tmp_path / f"logs_{mode}")])
        assert states[mode].step == 2
        assert CheckpointManager(tmp_path / mode, cfg.audio).all_steps() == [2]
        lines = (tmp_path / f"logs_{mode}" / "vocoder_metrics.jsonl").read_text().splitlines()
        logs[mode] = [{k: v for k, v in json.loads(line).items() if k != "wall_time_s"}
                      for line in lines]
    assert len(logs["on"]) == 1 and logs["on"] == logs["off"]  # step 1 is logged
    for k, v in states["on"].model.state_dict().items():
        assert torch.equal(v, states["off"].model.state_dict()[k]), k
