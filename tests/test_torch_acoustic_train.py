"""The port's acoustic train step against the JAX package's, float32 on the
CPU, from the same weights and batch (the tiny model of
tests/test_torch_acoustic_model.py with every dropout at 0, B = 2, Tph 8,
48 frames): pure teacher forcing, and scheduled sampling at p = 1, where
JAX's Bernoulli mask is all-true so both sides feed the decoder its own
pass-1 prediction; the share of frames replaced at p in (0, 1);
checkpoints (f32, bf16, background); and `python -m
sambert_hifigan_tpu_torch.train_acoustic` end to end, then `inference
--acoustic-checkpoint` on what it wrote.

Bounds of a step: every loss within 1e-4 (relative), the grad norm within
1e-3; post-step parameters within 1e-5 wherever the gradient is above 1e-5
of its global norm, and within 2 lr everywhere.  Adam's first step is ~lr
sign(g), so an element whose gradient is a near-cancelling f32 sum moves
either way on either side (tests/test_torch_vocoder_train.py measures
it); the mask is read off the port's gradients.  The helpers are shared
with tests/test_torch_acoustic_train_options.py.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.training.acoustic_trainer import (
    make_acoustic_optimizer,
    make_jitted_acoustic_step,
)
from sambert_hifigan_tpu.training.train_state import AcousticTrainState as JState

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import inference, train_acoustic
from sambert_hifigan_tpu_torch.data.dataset import batch_to_device
from sambert_hifigan_tpu_torch.training import optim as p_optim
from sambert_hifigan_tpu_torch.training.acoustic_trainer import (
    acoustic_params_from_tree,
    init_acoustic_state,
    make_acoustic_step,
)
from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
from sambert_hifigan_tpu_torch.weights import acoustic_state_dict_from_flax, random_acoustic_model
from tests.test_torch_acoustic_model import (
    acoustic_cfg,
    jax_acoustic,
    make_batch,
    port_acoustic,
)
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

LOSSES = ("total_loss", "mel_loss", "dur_loss", "pitch_loss", "energy_loss")


def _numpy(sd):
    return {k: v.detach().cpu().float().numpy().copy() for k, v in sd.items()}


class Pair:
    """The JAX step and the port's step from the same random weights, every
    dropout at 0; `stage` overrides training.acoustic."""

    def __init__(self, seed=0, weights=None, **stage):
        self.cfg_j = acoustic_cfg(jcfg, dropout=0.0, **stage)
        self.cfg_p = acoustic_cfg(pcfg, dropout=0.0, **stage)
        if weights:
            self.cfg_j = dataclasses.replace(self.cfg_j, loss_weights=jcfg.LossWeights(**weights))
            self.cfg_p = dataclasses.replace(self.cfg_p, loss_weights=pcfg.LossWeights(**weights))
        self.model_j, variables = jax_acoustic(self.cfg_j, seed)
        params = variables
        ema = self.cfg_j.training.acoustic.ema_decay > 0
        self.state_j = JState(params=params,
                              opt_state=make_acoustic_optimizer(self.cfg_j).init(params),
                              step=jnp.zeros((), jnp.int32), ema_params=params if ema else None)
        self.step_j = make_jitted_acoustic_step(self.model_j, self.cfg_j)
        self.state_p = init_acoustic_state(port_acoustic(self.cfg_p, variables), self.cfg_p)
        self.step_p = make_acoustic_step(self.cfg_p)
        self.rng = torch.Generator().manual_seed(seed)
        self.names = [n for n, _ in self.state_p.model.named_parameters()]
        self.grads = []  # the gradients the optimizer was given
        opt_step = self.state_p.opt.step

        def record(grads, **kw):
            self.grads.append([g.detach().clone() for g in grads])
            opt_step(grads, **kw)

        self.state_p.opt.step = record

    def run(self, batch):
        """One step on both sides -> (JAX metrics as floats, the port's)."""
        self.state_j, mj = self.step_j(jax.tree.map(jnp.array, self.state_j),
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(1))
        mp = self.step_p(self.state_p, batch_to_device(batch, "cpu"), self.rng)
        return ({k: float(v) for k, v in jax.device_get(mj).items()},
                {k: float(v) for k, v in mp.items()})

    def applied_grads(self, recorded=None):
        """{name: (mean of the recorded gradients, its global norm)}: the
        gradient of a first applied update (accumulated or not)."""
        recorded = self.grads if recorded is None else recorded
        mean = [sum(gs) / len(recorded) for gs in zip(*recorded)]
        norm = float(p_optim.global_norm(mean))
        return {n: (g.numpy(), norm) for n, g in zip(self.names, mean)}

    def jax_state_dict(self, ema=False):
        s = jax.device_get(self.state_j)
        return _numpy(acoustic_state_dict_from_flax(s.ema_params if ema else s.params))

    @property
    def lr(self):
        return self.cfg_p.training.acoustic.learning_rate


def assert_metrics_match(mj, mp, rel=1e-4, rel_norm=1e-3, keys=None):
    assert sorted(mj) == sorted(mp) == sorted(LOSSES + ("grad_norm", "lr"))
    for k in keys or mj:
        tol = rel_norm if k == "grad_norm" else rel
        assert abs(mp[k] - mj[k]) <= tol * max(abs(mj[k]), 1e-8), (k, mp[k], mj[k])


def assert_params_match(ours, theirs, grads, lr):
    """Post-step parameters: within 1e-5 where |g| > 1e-5 ||g||, within 2 lr
    everywhere."""
    assert sorted(ours) == sorted(theirs)
    for k, want in theirs.items():
        diff = np.abs(ours[k] - want)
        assert diff.max() <= 2 * lr, (k, diff.max())
        g, norm = grads[k]
        big = np.abs(g) > 1e-5 * norm
        assert diff[big].max(initial=0.0) <= 1e-5, (k, diff[big].max())


# ---- one f32 step --------------------------------------------------------------

_STEPS = {}


@pytest.fixture(params=[0.0, 1.0], ids=["teacher-forcing", "scheduled-sampling-1"])
def one_step(request):
    """(pair, parameters before, JAX metrics, port metrics) of one f32 step
    with scheduled sampling p."""
    p = request.param
    if p not in _STEPS:
        pair = Pair(seed=1, scheduled_sampling=p)
        before = _numpy(pair.state_p.model.state_dict())
        _STEPS[p] = (pair, before, *pair.run(make_batch(pair.cfg_p, seed=1, valid=(8, 6))))
    return _STEPS[p]


def test_step_metrics_match_jax(one_step):
    """The key schema (total_loss, mel/dur/pitch/energy_loss, grad_norm,
    lr) and every value."""
    _, _, mj, mp = one_step
    assert_metrics_match(mj, mp)


def test_step_parameters_match_jax(one_step):
    """Every parameter after the step, and the step count."""
    pair, before, _, _ = one_step
    ours = _numpy(pair.state_p.model.state_dict())
    assert_params_match(ours, pair.jax_state_dict(), pair.applied_grads(), pair.lr)
    assert any(np.abs(ours[k] - before[k]).max() > 0 for k in ours)
    assert pair.state_p.step == int(pair.state_j.step) == 1


def test_scheduled_sampling_replaces_its_share_of_frames(monkeypatch):
    """p = 0.3: pass 2 feeds the decoder pass 1's prediction at a share of
    the B x T frames within 5 sigma of 0.3 (whole frames: every mel bin of
    a frame from the same source), and the ground truth elsewhere; pass 1
    and pass 2 see the same dropout masks (one seed a step)."""
    cfg = acoustic_cfg(pcfg, dropout=0.1, scheduled_sampling=0.3)
    state = init_acoustic_state(random_acoustic_model(cfg, torch.Generator().manual_seed(2)),
                                cfg)
    batch = batch_to_device(make_batch(cfg, b=8, tfrm=64, seed=3), "cpu")
    seen = []
    forward = state.model.forward

    def spy(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen.append((args[3], out.mel_pred.detach(), kwargs["rng"].initial_seed()))
        return out

    monkeypatch.setattr(state.model, "forward", spy)
    make_acoustic_step(cfg)(state, batch, torch.Generator().manual_seed(4))
    (teacher1, own, seed1), (teacher2, _, seed2) = seen
    assert torch.equal(teacher1, batch["mel_gt"]) and seed1 == seed2
    from_own = (teacher2 == own).all(dim=-1)
    from_gt = (teacher2 == batch["mel_gt"]).all(dim=-1)
    assert bool((from_own | from_gt).all())
    share = from_own.float().mean().item()
    n = from_own.numel()
    assert abs(share - 0.3) <= 5 * (0.21 / n) ** 0.5, share


# ---- checkpoints ---------------------------------------------------------------


@pytest.mark.parametrize("precision,background", [("f32", False), ("bf16", False),
                                                  ("f32", True)],
                         ids=["f32", "bf16", "background"])
def test_checkpoint_round_trip(tmp_path, precision, background):
    """Three steps with an EMA and accumulation, a save after each, restore
    into a fresh state: the model and the EMA exact, the optimizer's
    moments exact (bf16: as stored, rounded to bf16), its counts and the
    step; keep=2 keeps the last two; another mel config is refused.  A
    background save writes the state as it was at the call, while the next
    step updates it in place."""
    cfg = acoustic_cfg(pcfg, dropout=0.1, ema_decay=0.9, accumulate_steps=2)
    state = init_acoustic_state(random_acoustic_model(cfg, torch.Generator().manual_seed(1)),
                                cfg)
    step = make_acoustic_step(cfg)
    rng = torch.Generator().manual_seed(5)
    ckpt = CheckpointManager(tmp_path / "ck", cfg.audio, keep=2)
    snapshots = {}
    for i in range(3):
        step(state, batch_to_device(make_batch(cfg, seed=10 + i), "cpu"), rng)
        snapshots[i + 1] = {k: v.clone() for k, v in state.model.state_dict().items()}
        ckpt.save(i + 1, state, precision=precision, background=background)
    if background:  # the last save is still in flight: step on, then wait
        step(state, batch_to_device(make_batch(cfg, seed=13), "cpu"), rng)
        ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and ckpt.has_ema()
    fresh = init_acoustic_state(random_acoustic_model(cfg, torch.Generator().manual_seed(2)),
                                cfg)
    assert ckpt.restore(fresh) == 3 and fresh.step == 3
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, snapshots[3][k]), k
    if background:
        return
    for a, b in zip(state.ema.state_dict().values(), fresh.ema.state_dict().values()):
        assert torch.equal(a, b)
    rnd = (lambda t: t.bfloat16().float()) if precision == "bf16" else (lambda t: t)  # noqa: E731
    assert state.opt.applied == fresh.opt.applied == 1
    assert state.opt.mini_step == fresh.opt.mini_step == 1
    for a, b in zip(state.opt.acc, fresh.opt.acc):
        assert torch.equal(rnd(a), b)
    sa, sb = state.opt.adamw.state_dict()["state"], fresh.opt.adamw.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k] if k == "step" else rnd(sa[i][k]), sb[i][k])
    other = dataclasses.replace(cfg.audio, fmax=7600.0)
    with pytest.raises(pcfg.ConfigError, match="mel configuration"):
        CheckpointManager(tmp_path / "ck", other).restore(fresh)


def test_background_save_error_surfaces(tmp_path, monkeypatch):
    """A failed background write raises at the next wait(); drain() returns
    it instead, and the next save works."""
    cfg = acoustic_cfg(pcfg)
    state = init_acoustic_state(random_acoustic_model(cfg, torch.Generator().manual_seed(1)),
                                cfg)
    ckpt = CheckpointManager(tmp_path, cfg.audio)
    real = torch.save

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    ckpt.save(1, state, background=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.save(2, state, background=True)
    assert isinstance(ckpt.drain(), OSError)
    monkeypatch.setattr(torch, "save", real)
    ckpt.save(3, state, background=True)
    assert ckpt.drain() is None and ckpt.all_steps() == [3]


# ---- the entry points ------------------------------------------------------------


def _tiny_model_config(path):
    path.write_text(yaml.safe_dump({"acoustic_model": {
        "d_model": 32,
        "encoder": {"n_layers": 2, "n_heads": 2, "d_ff": 64},
        "decoder": {"n_layers": 2, "n_heads": 2, "d_ff": 64},
    }, "vocoder": {"generator": {"upsample_initial_channel": 32,
                                 "resblock_kernel_sizes": [3],
                                 "resblock_dilation_sizes": [[1, 3]]}}}))
    return str(path)


def test_train_acoustic_then_inference(tmp_path, monkeypatch, capsys):
    """train_acoustic --synthetic 2 on the CPU writes a checkpoint (with an
    EMA); --resume continues from step 2 to 3; inference
    --acoustic-checkpoint loads it (the EMA copy) and writes a wav whose
    length is a whole number of frames; a run under another mel config
    refuses to resume; with no card and no --device cpu it raises;
    --metadata with no card raises too, and
    neither --metadata nor --synthetic is refused."""
    model_cfg = _tiny_model_config(tmp_path / "model.yaml")
    ck = str(tmp_path / "ck")
    common = ["--model-config", model_cfg, "--batch-size", "2", "--checkpoint-dir", ck,
              "--log-dir", str(tmp_path / "logs")]
    state = train_acoustic.main(["--device", "cpu", "--synthetic", "2", "--ema-decay", "0.9",
                                 *common])
    assert state.step == 2 and state.ema is not None
    manager = CheckpointManager(ck, pcfg.AudioConfig())
    assert manager.all_steps() == [2] and manager.has_ema()
    state = train_acoustic.main(["--device", "cpu", "--synthetic", "3", "--resume",
                                 "--ema-decay", "0.9", "--sync-save",
                                 "--save-precision", "bf16", *common])
    assert state.step == 3 and "resumed from step 2" in capsys.readouterr().out
    assert (tmp_path / "logs" / "acoustic_metrics.jsonl").read_text().count("\n") == 2
    tree, step = manager.restore_tree()
    assert step == 3
    for k, v in state.ema.state_dict().items():
        assert torch.equal(acoustic_params_from_tree(tree)[k], v), k

    from sambert_hifigan_tpu_torch.pipeline import build_pipeline

    cfg = pcfg.load_config(None, model_cfg)
    pipe = build_pipeline(cfg, device="cpu", acoustic_checkpoint=ck)
    for k, v in state.ema.state_dict().items():
        assert torch.equal(pipe.acoustic.state_dict()[k], v), k
    out = tmp_path / "out.wav"
    inference.main(["--text", "你好", "--output", str(out), "--device", "cpu",
                    "--model-config", model_cfg, "--acoustic-checkpoint", ck])
    from sambert_hifigan_tpu_torch.data.audio import load_wav

    wav, sr = load_wav(str(out))
    assert sr == cfg.audio.sample_rate and wav.size > 0 and wav.size % cfg.audio.hop_length == 0
    assert f"acoustic: {ck}" in capsys.readouterr().out

    other = tmp_path / "config.yaml"
    other.write_text(yaml.safe_dump({"audio": {"fmax": 7600.0}}))
    with pytest.raises(pcfg.ConfigError, match="mel configuration"):
        train_acoustic.main(["--device", "cpu", "--synthetic", "4", "--resume",
                             "--config", str(other), *common])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_acoustic.main(["--synthetic", "1", *common])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_acoustic.main(["--metadata", "data/train/metadata.csv", *common])
    with pytest.raises(SystemExit, match="--metadata or --synthetic"):
        train_acoustic.main(common)
