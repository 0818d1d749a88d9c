"""The port's vocoder train step against the JAX package's, float32 on the
CPU, one step per loss mode from the same weights (the tiny vocoder of
tests/test_training.py, B = 2, 8 frames); the learning-rate schedules
against optax; checkpoints; and `python -m
sambert_hifigan_tpu_torch.train_vocoder` end to end.

Bounds of a step: every metric within 1e-4 (relative), both grad norms
within 1e-3; post-step parameters within 1e-5 wherever the gradient is
above 1e-5 of its side's global norm, and within 2 lr everywhere.  Adam's
first step is ~lr sign(g): an element whose gradient is a near-cancelling
f32 sum moves either way on either side.  Measured: gradients up to 7.6e-7
of the norm flip sign between the two packages (4 of conv_pre's 17920
weights at |g| ~ 2e-5 against a norm of 350; one at 5e-4 against 676 with
spectral norm), so the mask is relative to the norm, and read off the
port's gradients (they agree with JAX's within the grad-norm bound).  The
JAX steps are compiled once per case.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.training import optim as j_optim
from sambert_hifigan_tpu.training.train_state import VocoderTrainState as JState
from sambert_hifigan_tpu.training.vocoder_trainer import (
    make_jitted_vocoder_step,
    make_vocoder_optimizers,
)

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import train_vocoder
from sambert_hifigan_tpu_torch.training import optim as p_optim
from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
    init_vocoder_state,
    make_vocoder_step,
    vocoder_state_from_model,
)
from sambert_hifigan_tpu_torch.weights import vocoder_state_dicts_from_flax
from tests.test_torch_discriminators import (  # noqa: F401 (a fixture)
    jax_vocoder,
    one_torch_thread,
    port_vocoder,
    tiny_voc,
)

B, FRAMES, HOP = 2, 8, 256
GRAD_NORMS = ("d_grad_norm", "g_grad_norm")


def configs(loss_mode="adv_mel_fm", spectral=False, stage=None, disc=None):
    """(JAX config, port config) of the tiny vocoder; `stage` overrides
    training.vocoder (mixed precision off unless given)."""
    stage = {"mixed_precision": False, **(stage or {})}
    out = []
    for c in (jcfg, pcfg):
        cfg = c.TTSConfig()
        tr = dataclasses.replace(cfg.training.vocoder, **stage)
        out.append(dataclasses.replace(
            cfg, vocoder=dataclasses.replace(tiny_voc(c, spectral, **(disc or {})),
                                             loss_mode=loss_mode),
            training=dataclasses.replace(cfg.training, vocoder=tr)))
    return tuple(out)


def batches(n, seed=0):
    return list(zip(range(n), train_vocoder.synthetic_pairs(B, FRAMES, HOP, seed=seed)))


class Pair:
    """The JAX step and the port's step from the same random weights."""

    def __init__(self, loss_mode="adv_mel_fm", spectral=False, stage=None, seed=0, disc=None):
        self.cfg_j, self.cfg_p = configs(loss_mode, spectral, stage, disc)
        self.model_j, variables = jax_vocoder(self.cfg_j.vocoder, seed)
        self.variables = variables
        params = variables["params"]
        g_params = {"params": {"generator": params["generator"]}}
        d_params = {"params": {"msd": params["msd"], "mpd": params["mpd"]}}
        g_opt, d_opt = make_vocoder_optimizers(self.cfg_j)
        ema = self.cfg_j.training.vocoder.ema_decay > 0
        self.state_j = JState(
            g_params=g_params,
            d_params={**d_params, "spectral": variables["spectral"]} if spectral else d_params,
            g_opt_state=g_opt.init(g_params), d_opt_state=d_opt.init(d_params),
            step=jnp.zeros((), jnp.int32), g_ema_params=g_params if ema else None)
        self.step_j = make_jitted_vocoder_step(self.model_j, self.cfg_j, loss_mode=loss_mode)
        self.state_p = vocoder_state_from_model(port_vocoder(self.cfg_p.vocoder, variables),
                                                self.cfg_p)
        self.step_p = make_vocoder_step(self.cfg_p, loss_mode=loss_mode)
        self.grads = {"g": [], "d": []}  # the gradients each optimizer was given
        for side, opt in (("g", self.state_p.g_opt), ("d", self.state_p.d_opt)):
            opt.step = self._recording(opt.step, self.grads[side])

    @staticmethod
    def _recording(step, store):
        def record(grads, **kw):
            store.append([g.detach().clone() for g in grads])
            step(grads, **kw)
        return record

    def applied_grads(self):
        """{parameter name: the mean of the gradients recorded so far} (the
        accumulated gradient of a first applied update), and each side's
        global norm of it."""
        model = self.state_p.model
        names = {"g": [f"generator.{n}" for n, _ in model.generator.named_parameters()],
                 "d": [f"msd.{n}" for n, _ in model.msd.named_parameters()]
                 + [f"mpd.{n}" for n, _ in model.mpd.named_parameters()]}
        out, norms = {}, {}
        for side, recorded in self.grads.items():
            if not recorded:
                continue
            mean = [sum(gs) / len(recorded) for gs in zip(*recorded)]
            norms[side] = float(p_optim.global_norm(mean))
            out.update({n: (g.numpy(), norms[side]) for n, g in zip(names[side], mean)})
        return out

    def run(self, mel, wav):
        """One step on both sides -> (JAX metrics as floats, the port's)."""
        self.state_j, mj = self.step_j(jax.tree.map(jnp.array, self.state_j), mel, wav)
        mp = self.step_p(self.state_p, torch.from_numpy(mel), torch.from_numpy(wav))
        return ({k: float(v) for k, v in jax.device_get(mj).items()},
                {k: float(v) for k, v in mp.items()})

    def lrs(self):
        tr = self.cfg_p.training.vocoder
        d_lr = tr.learning_rate_discriminator or tr.learning_rate
        return {"generator": tr.learning_rate, "msd": d_lr, "mpd": d_lr}

    def jax_state_dict(self, state=None):
        """The JAX state's parameters (and spectral u, v) in the port's keys."""
        s = jax.device_get(state or self.state_j)
        params = {"generator": s.g_params["params"]["generator"], **s.d_params["params"]}
        return _numpy(vocoder_state_dicts_from_flax(params, s.d_params.get("spectral")))

    def jax_ema_state_dict(self):
        s = jax.device_get(self.state_j)
        params = {"generator": s.g_ema_params["params"]["generator"],
                  **s.d_params["params"]}
        return {k[len("generator."):]: v for k, v in
                _numpy(vocoder_state_dicts_from_flax(params)).items() if k.startswith("generator.")}


def assert_metrics_match(mj, mp, rel=1e-4, rel_norms=1e-3):
    assert sorted(mj) == sorted(mp)
    for k, want in mj.items():
        tol = rel_norms if k in GRAD_NORMS else rel
        assert abs(mp[k] - want) <= tol * max(abs(want), 1e-8), (k, mp[k], want)


def assert_params_match(ours, theirs, grads, lr):
    """Post-step state dicts (numpy) after one applied update per side:
    within 1e-5 wherever |g| > 1e-5 * ||g|| (`grads`: name -> (g, ||g||))
    and within 2 lr everywhere; parameters without a gradient (a side that
    never updated) unchanged on both; buffers (spectral u, v) within 1e-5
    (relative)."""
    assert sorted(ours) == sorted(theirs)
    for k, want in theirs.items():
        got = ours[k]
        if "spectral_" in k:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
            continue
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr[k.split(".")[0]], (k, diff.max())
        g, norm = grads[k]
        big = np.abs(g) > 1e-5 * norm
        assert diff[big].max(initial=0.0) <= 1e-5, (k, diff[big].max())


def _numpy(sd):
    return {k: v.detach().cpu().float().numpy().copy() for k, v in sd.items()}


# ---- one f32 step per loss mode ------------------------------------------------

_PAIRS = {}


@pytest.fixture(params=["mel_only", "adv_mel", "adv_mel_fm"])
def mode_step(request):
    """(pair, parameters before, JAX metrics, port metrics) of one f32 step."""
    mode = request.param
    if mode not in _PAIRS:
        pair = Pair(mode)
        before = _numpy(pair.state_p.model.state_dict())
        (_, (mel, wav)), = batches(1)
        _PAIRS[mode] = (pair, before, *pair.run(mel, wav))
    return _PAIRS[mode]


def test_step_metrics_match_jax(mode_step):
    """The full key schema (disc_loss, gen_* with gen_fm_loss_disc_0..7 in
    adv_mel_fm, d_grad_norm, g_grad_norm, lr) and every value."""
    pair, _, mj, mp = mode_step
    assert_metrics_match(mj, mp)
    mode = pair.cfg_p.vocoder.loss_mode
    assert (sum(k.startswith("gen_fm_loss_disc_") for k in mp)
            == (8 if mode == "adv_mel_fm" else 0))
    if mode == "mel_only":
        assert mp["disc_loss"] == mp["d_grad_norm"] == mp["gen_adv_loss"] == 0.0


def test_step_parameters_match_jax(mode_step):
    """Both sides' post-step parameters; in mel_only the discriminators do
    not move at all."""
    pair, before, _, _ = mode_step
    ours = _numpy(pair.state_p.model.state_dict())
    grads = pair.applied_grads()
    if pair.cfg_p.vocoder.loss_mode == "mel_only":
        theirs = pair.jax_state_dict()
        for k, v in ours.items():
            if not k.startswith("generator."):
                np.testing.assert_array_equal(v, before[k])
                np.testing.assert_array_equal(theirs[k], before[k])
                grads[k] = (np.zeros_like(v), 1.0)
    assert_params_match(ours, pair.jax_state_dict(), grads, pair.lrs())
    assert pair.state_p.step == int(pair.state_j.step) == 1


# ---- schedules -----------------------------------------------------------------


@pytest.mark.parametrize("stage", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="constant", warmup_steps=4),
    dict(lr_schedule="exponential", lr_decay_steps=3, lr_decay_gamma=0.5),
    dict(lr_schedule="exponential", lr_decay_steps=3, lr_decay_gamma=0.5, warmup_steps=2),
    dict(lr_schedule="warmup_cosine", warmup_steps=3, lr_total_steps=12, lr_end_ratio=0.1),
    dict(lr_schedule="warmup_cosine", warmup_steps=0, lr_total_steps=5),
    dict(lr_schedule="constant", accumulate_steps=3, warmup_steps=2),
], ids=["constant", "constant-warmup", "exponential", "exponential-warmup",
        "warmup-cosine", "cosine-no-warmup", "accumulated"])
def test_lr_schedules_match_optax(stage):
    """The schedule at every count 0..15 and current_lr at every micro-step
    (applied updates = step // accumulate_steps), within 1e-6 relative."""
    tr_j = dataclasses.replace(jcfg.TrainStageConfig(), **stage)
    tr_p = dataclasses.replace(pcfg.TrainStageConfig(), **stage)
    sched_j = j_optim.make_lr_schedule(tr_j, base_lr=3e-4)
    sched_p = p_optim.make_lr_schedule(tr_p, base_lr=3e-4)
    for count in range(16):
        want = float(sched_j(count))
        assert abs(sched_p(count) - want) <= 1e-6 * max(abs(want), 1e-12), count
        want = float(j_optim.current_lr(tr_j, jnp.int32(count)))
        assert abs(p_optim.current_lr(tr_p, count) - want) <= 1e-6 * max(abs(want), 1e-12)


def test_clip_by_global_norm_matches_optax():
    """gradient_clip = 1: two applied AdamW updates, on gradients of norm 5
    (clipped) then 0.5 (not), against optax's chain(clip_by_global_norm,
    adamw) on the same gradients, within 1e-6 (parameters of magnitude ~1).
    Adam's first step does not see a gradient's scale; the second does."""
    tr_j = dataclasses.replace(jcfg.TrainStageConfig(), gradient_clip=1.0)
    tr_p = dataclasses.replace(pcfg.TrainStageConfig(), gradient_clip=1.0)
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((3, 4)).astype(np.float32),
          rng.standard_normal(5).astype(np.float32)]
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    ours = p_optim.Optimizer(params, tr_p)
    opt = j_optim.build_optimizer(tr_j)
    theirs, opt_state = [jnp.asarray(x) for x in p0], opt.init(p0)
    for norm in (5.0, 0.5):
        g = [rng.standard_normal(x.shape).astype(np.float32) for x in p0]
        g = [x * (norm / np.sqrt(sum((y ** 2).sum() for y in g))) for x in g]
        ours.step([torch.from_numpy(x) for x in g])
        updates, opt_state = opt.update([jnp.asarray(x) for x in g], opt_state, theirs)
        theirs = optax.apply_updates(theirs, updates)
    for p, want in zip(params, theirs):
        assert np.abs(p.detach().numpy() - np.asarray(want)).max() <= 1e-6


# ---- checkpoints and the entry point -------------------------------------------


def _tiny_model_config(path):
    path.write_text(yaml.safe_dump({"vocoder": {
        "generator": {"upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                      "resblock_dilation_sizes": [[1, 3]]},
        "discriminator": {"channel_div": 16}}}))
    return str(path)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_checkpoint_round_trip(tmp_path, precision):
    """Two steps with an EMA, save, restore into a fresh state: every
    tensor equal (bf16: the discriminators and the optimizer moments as
    stored, rounded to bf16; the generator and its EMA exact), the step,
    the optimizers' counts; keep=2 keeps the last two; another mel config
    is refused."""
    _, cfg = configs("adv_mel", stage={"ema_decay": 0.9})
    state = init_vocoder_state(cfg, torch.Generator().manual_seed(1), "cpu")
    step = make_vocoder_step(cfg)
    ckpt = CheckpointManager(tmp_path / "ck", cfg.audio, keep=2)
    for i, (mel, wav) in batches(3):
        step(state, torch.from_numpy(mel), torch.from_numpy(wav))
        ckpt.save(i + 1, state, precision=precision)
    assert ckpt.all_steps() == [2, 3] and ckpt.has_ema()
    fresh = init_vocoder_state(cfg, torch.Generator().manual_seed(2), "cpu")
    assert ckpt.restore(fresh) == 3 and fresh.step == 3
    rnd = (lambda t: t.bfloat16().float()) if precision == "bf16" else (lambda t: t)  # noqa: E731
    for name in ("generator", "msd", "mpd"):
        cast = rnd if name != "generator" else (lambda t: t)  # noqa: E731
        for (k, a), b in zip(getattr(state.model, name).state_dict().items(),
                             getattr(fresh.model, name).state_dict().values()):
            assert torch.equal(cast(a), b), (name, k)
    for a, b in zip(state.g_ema.state_dict().values(), fresh.g_ema.state_dict().values()):
        assert torch.equal(a, b)
    for opt_a, opt_b in ((state.g_opt, fresh.g_opt), (state.d_opt, fresh.d_opt)):
        assert opt_a.applied == opt_b.applied == 3
        sa, sb = opt_a.adamw.state_dict()["state"], opt_b.adamw.state_dict()["state"]
        for i in sa:
            for k in sa[i]:
                want = sa[i][k] if k == "step" else rnd(sa[i][k])
                assert torch.equal(want, sb[i][k])
    other = dataclasses.replace(cfg.audio, fmax=7600.0)
    with pytest.raises(pcfg.ConfigError, match="mel configuration"):
        CheckpointManager(tmp_path / "ck", other).restore(fresh)


def test_train_vocoder_entry_point(tmp_path, monkeypatch, capsys):
    """Trains 2 steps on the CPU and saves; --resume continues from step 2
    to 3; a run under another mel config refuses to resume; with no card
    and no --device cpu it raises; --metadata with no card raises too, and
    neither --metadata nor --synthetic is refused."""
    model_cfg = _tiny_model_config(tmp_path / "model.yaml")
    common = ["--model-config", model_cfg, "--batch-size", "2", "--segment-frames", "8",
              "--checkpoint-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "logs")]
    state = train_vocoder.main(["--device", "cpu", "--synthetic", "2", *common])
    assert state.step == 2
    ckpt_steps = CheckpointManager(tmp_path / "ck", pcfg.AudioConfig()).all_steps()
    assert ckpt_steps == [2]
    state = train_vocoder.main(["--device", "cpu", "--synthetic", "3", "--resume",
                                "--save-precision", "bf16", *common])
    assert state.step == 3 and "resumed from step 2" in capsys.readouterr().out
    assert (tmp_path / "logs" / "vocoder_metrics.jsonl").read_text().count("\n") == 2

    other = tmp_path / "config.yaml"
    other.write_text(yaml.safe_dump({"audio": {"fmax": 7600.0}}))
    with pytest.raises(pcfg.ConfigError, match="mel configuration"):
        train_vocoder.main(["--device", "cpu", "--synthetic", "4", "--resume",
                            "--config", str(other), *common])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocoder.main(["--synthetic", "1", *common])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocoder.main(["--metadata", "data/train/metadata.csv", *common])
    with pytest.raises(SystemExit, match="--metadata or --synthetic"):
        train_vocoder.main(common)


def test_optimizer_runs_after_scripts_shadow_profile():
    """tests/test_serving.py's HTTP fixture puts scripts/ on sys.path, where
    scripts/profile.py shadows the stdlib `profile` for every later first
    import; torch.optim's first step imports torch._dynamo, which imports
    cProfile, which imports `profile`.  In one process, in that order, the
    port's optimizer test still passes (this module binds cProfile first)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist", "-p", "no:cacheprovider",
           "-p", "no:randomly", "tests/test_serving.py::TestHTTPServer",
           "tests/test_torch_vocoder_train.py::test_clip_by_global_norm_matches_optax"]
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-2000:]
    assert "5 passed" in run.stdout, run.stdout[-2000:]
