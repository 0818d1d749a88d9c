"""The port's acoustic train step against the JAX package's under the step's
options, on the CPU: accumulation with the EMA over three steps, the
exponential and warmup-cosine schedules over three steps, and bf16 mixed
precision.  Same weights, batches and bounds as
tests/test_torch_acoustic_train.py (split from it so that the suite's
workers compile the JAX steps in parallel).
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401

import numpy as np
import pytest
import torch

from tests.test_torch_acoustic_model import make_batch
from tests.test_torch_acoustic_train import (
    Pair,
    _numpy,
    assert_metrics_match,
    assert_params_match,
)
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)


def test_accumulation_and_ema_match_jax():
    """accumulate_steps = 2 and ema_decay = 0.9 over three steps: the one
    update applies at step 1 (the mean of steps 0 and 1) and step 2 starts
    the next accumulation, so the parameters do not move at steps 0 and 2
    on either side; the metrics match at every step (lr counts applied
    updates); the parameters and the EMA after step 2 are held as a single
    step's are."""
    pair = Pair(seed=3, accumulate_steps=2, ema_decay=0.9)
    before = _numpy(pair.state_p.model.state_dict())
    for i in range(3):
        mj, mp = pair.run(make_batch(pair.cfg_p, seed=20 + i, valid=(8, 7)))
        assert_metrics_match(mj, mp)
        ours = _numpy(pair.state_p.model.state_dict())
        if i == 0:
            for k, v in ours.items():
                np.testing.assert_array_equal(v, before[k])
                np.testing.assert_array_equal(pair.jax_state_dict()[k], before[k])
        if i == 1:
            after_update = ours
    assert pair.state_p.opt.applied == 1 and len(pair.grads) == 3
    for k, v in ours.items():
        np.testing.assert_array_equal(v, after_update[k])
    grads = pair.applied_grads(pair.grads[:2])
    assert_params_match(ours, pair.jax_state_dict(), grads, pair.lr)
    assert_params_match(_numpy(pair.state_p.ema.state_dict()), pair.jax_state_dict(ema=True),
                        grads, pair.lr)


@pytest.mark.parametrize("stage", [
    dict(lr_schedule="exponential", lr_decay_steps=1, lr_decay_gamma=0.5),
    dict(lr_schedule="warmup_cosine", warmup_steps=1, lr_total_steps=4, lr_end_ratio=0.1),
], ids=["exponential", "warmup-cosine"])
def test_schedules_match_jax(stage):
    """Three steps under a schedule whose rate changes every step (the
    warmup's first rate is 0, so step 0 moves nothing): the metrics, lr
    included, at every step; the parameters after the last, held as after
    one step, within 1e-5 where every step's gradient is above 1e-5 of its
    norm and within 2 lr per step everywhere."""
    pair = Pair(seed=4, **stage)
    lrs = []
    for i in range(3):
        mj, mp = pair.run(make_batch(pair.cfg_p, seed=30 + i))
        assert_metrics_match(mj, mp)
        lrs.append(mp["lr"])
    assert len(set(lrs)) == 3
    recorded = [pair.applied_grads([g]) for g in pair.grads]
    grads = {k: (np.min([np.abs(r[k][0]) / r[k][1] for r in recorded], axis=0), 1.0)
             for k in recorded[0]}
    assert_params_match(_numpy(pair.state_p.model.state_dict()), pair.jax_state_dict(),
                        grads, sum(lrs))


@pytest.mark.parametrize("weights", [None, dict(mel=1.0, dur=0.0, pitch=0.0, energy=0.0)],
                         ids=["default-weights", "mel-only"])
def test_bf16_step_stays_near_jax(weights):
    """mixed_precision: the model computes in bf16 on both sides, the
    losses and the optimizer in f32 on f32 masters.  The packages round in
    the same places but sum in other orders (oneDNN against XLA:CPU), so
    every loss and the grad norm are held within 2e-2 (relative), the
    parameters not at all.  With the default weights the grad norm is the
    pitch loss's (raw Hz); the mel loss alone gives the decoder's.
    Measured on such batches: losses within 6.2e-3, the grad norm within
    5.0e-3 (default) and 2.9e-3 (mel only); in f32, 5.9e-7."""
    pair = Pair(seed=2, weights=weights, mixed_precision=True)
    mj, mp = pair.run(make_batch(pair.cfg_p, seed=2, valid=(8, 6)))
    assert all(np.isfinite(v) for v in mp.values()) and mp["grad_norm"] > 0
    assert_metrics_match(mj, mp, rel=2e-2, rel_norm=2e-2)
    assert all(p.dtype == torch.float32 for p in pair.state_p.model.parameters())


def test_train_acoustic_from_metadata(tmp_path, capsys):
    """`train_acoustic --metadata` on a toy corpus (6 utterances), the tiny
    model on the CPU, batch 2: trains 2 steps to a checkpoint, reports the
    collated batch's real shape (the corpus's phoneme and frame buckets),
    and --prefetch on and off log the same metrics and train the same
    weights, bit for bit."""
    import json

    from sambert_hifigan_tpu_torch import train_acoustic
    from sambert_hifigan_tpu_torch.config import load_config
    from sambert_hifigan_tpu_torch.data.dataset import TTSDataset
    from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset
    from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
    from tests.test_torch_acoustic_train import _tiny_model_config

    meta = str(make_toy_dataset(tmp_path / "toy", n=6, seed=4, verbose=False))
    model_cfg = _tiny_model_config(tmp_path / "model.yaml")
    cfg = load_config(None, model_cfg)
    logs, states = {}, {}
    for mode in ("on", "off"):
        state = states[mode] = train_acoustic.main([
            "--metadata", meta, "--steps", "2", "--device", "cpu", "--model-config", model_cfg,
            "--batch-size", "2", "--prefetch", mode, "--checkpoint-dir", str(tmp_path / mode),
            "--log-dir", str(tmp_path / f"logs_{mode}")])
        assert state.step == 2
        assert CheckpointManager(tmp_path / mode, cfg.audio).all_steps() == [2]
        lines = (tmp_path / f"logs_{mode}" / "acoustic_metrics.jsonl").read_text().splitlines()
        logs[mode] = [{k: v for k, v in json.loads(line).items() if k != "wall_time_s"}
                      for line in lines]
    assert len(logs["on"]) == 1 and logs["on"] == logs["off"]  # step 1 is logged
    for k, v in states["on"].model.state_dict().items():
        assert torch.equal(v, states["off"].model.state_dict()[k]), k
    first = next(TTSDataset(meta, cfg, device="cpu").batches(2, seed=0))
    b, tph = first["ph_ids"].shape
    out = capsys.readouterr().out
    assert f"first batch: {b} x {tph} phonemes x {first['mel_gt'].shape[1]} frames" in out
    assert (tph, first["mel_gt"].shape[1]) != (16, 64)  # the corpus's buckets, not the synthetic



@pytest.fixture(scope="module")
def corpus_features(tmp_path_factory):
    from sambert_hifigan_tpu_torch.config import TTSConfig
    from sambert_hifigan_tpu_torch.data.dataset import TTSDataset
    from sambert_hifigan_tpu_torch.make_toy_dataset import make_toy_dataset

    meta = make_toy_dataset(tmp_path_factory.mktemp("toy"), n=4, seed=6, max_chars=6,
                            verbose=False)
    ds = TTSDataset(str(meta), TTSConfig(), device="cpu")
    feats = sorted((ds.load_features(u) for u in ds.utterances), key=lambda f: len(f["mel"]))
    assert len(feats[1]["mel"]) <= 128
    return feats[:2]  # the two shortest, so that the 128-frame bucket takes them


@pytest.mark.parametrize("bucket", [128, 256, 512, 1024, 2048])
def test_step_takes_every_frame_bucket(corpus_features, bucket):
    """Two corpus utterances collated into each of the config's frame
    buckets: with dropout 0 in f32, padding changes no metric (1e-5
    relative of the 128-frame batch's; the mask hides every padded frame);
    with dropout 0.1, remat and bf16, each bucket's step is finite."""
    import dataclasses

    from sambert_hifigan_tpu_torch import config as pcfg
    from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, collate_acoustic
    from sambert_hifigan_tpu_torch.training.acoustic_trainer import (
        init_acoustic_state,
        make_acoustic_step,
    )
    from sambert_hifigan_tpu_torch.training.metrics import to_host
    from sambert_hifigan_tpu_torch.weights import random_acoustic_model
    from tests.test_torch_acoustic_model import acoustic_cfg

    def metrics(frames, **kw):
        cfg = acoustic_cfg(pcfg, **kw)
        am = cfg.acoustic_model
        cfg = dataclasses.replace(cfg, acoustic_model=dataclasses.replace(
            am, decoder=dataclasses.replace(am.decoder, max_len=2048)))
        batch = collate_acoustic(corpus_features, (32,), (frames,))
        state = init_acoustic_state(random_acoustic_model(cfg, torch.Generator().manual_seed(0)),
                                    cfg)
        out = make_acoustic_step(cfg)(state, batch_to_device(batch, "cpu"),
                                      torch.Generator().manual_seed(1))
        return to_host(out)

    ref, got = metrics(128, dropout=0.0), metrics(bucket, dropout=0.0)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1.0), (k, got[k], v)
    bf16 = metrics(bucket, remat=True, mixed_precision=True)
    assert sorted(bf16) == sorted(ref) and all(np.isfinite(v) for v in bf16.values())
