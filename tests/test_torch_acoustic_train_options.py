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
