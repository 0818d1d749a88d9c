"""HiFi-GAN GAN training, one step.

The order of the step is the reference's:
  1. wav_fake = G(mel)
  2. the discriminators' loss on (wav_real, wav_fake detached) -> update D
     (every d_update_every-th step; the gradients are computed every step)
  3. the generator's loss against the UPDATED discriminators -> update G
The JAX package regenerates wav_fake for step 3; G's parameters have not
changed by then, so this step keeps step 1's graph, which gives the same
numbers in float32 and in bf16.  In mel_only mode the discriminators take no
part, and the metrics still carry every key, with zeros.

The spectral-norm power iteration advances on the D pass only (both of its
critic calls, real then fake), whether or not the D update is applied; the
G pass reads u and v as they are.

Mixed precision (mixed_precision=True): G and D compute in bf16 (weights,
biases and inputs cast at every conv; the tanh in f32), the waveform and
the feature maps are cast to f32 at the loss boundary, so every loss and
both optimizers run in f32 on f32 masters.  bf16 shares f32's exponent
range: no loss scale.

Data parallel (parallel/mesh.py, in a process group): each rank holds a
replica and its rows of the global batch.  Every loss is a plain mean over
equal shards, so the global loss is the mean of the ranks' losses: the D
and the G gradients, with their metrics, are SUM-reduced in one collective
each and divided by the world size before their norms.  The spectral-norm
u, v advance from the weights alone, so they stay identical on every rank.

Tensor parallel (a sharded state, `VocoderTrainState.shard_`): "ranks"
above means the data axis, whose size divides.  The step gathers G's and
D's whole weights over the model group first; the D update returns D to
its slices, updates them and gathers D again, so that the G pass meets
the updated discriminators; after the G update both return to their
slices.  Spectral norm's u, v advance on the D pass from the gathered
weight, and weight norm's per-channel norm is taken of the gathered v.
The replicated leaves' gradients of the model group's first rank are
given to the others, and the norms are of the whole gradients.

Optimizers: AdamW(lr 2e-4, betas (0.8, 0.99)) for G and for MSD + MPD
jointly, each with the stage's schedule, clip and accumulation
(training/optim.py); D keeps its own base rate.  Metrics stay on the
device: nothing here waits for it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from ..config import AudioConfig, LossWeights, TrainStageConfig, TTSConfig
from ..losses.vocoder import (
    should_train_discriminator,
    vocoder_discriminator_loss,
    vocoder_generator_loss,
)
from ..models.hifigan import HiFiGAN, HiFiGANGenerator
from ..models.layers import init_defaults_
from ..parallel import mesh
from .optim import (
    Optimizer,
    current_lr,
    ema_update,
    global_norm,
    inference_params,
    maybe_init_ema,
)
from .train_state import VocoderTrainState


def make_vocoder_optimizers(model: HiFiGAN, cfg: TTSConfig):
    tr = cfg.training.vocoder
    g_opt = Optimizer(model.generator.parameters(), tr)
    d_opt = Optimizer(model.discriminator_parameters(), tr,
                      base_lr=tr.learning_rate_discriminator or tr.learning_rate)
    return g_opt, d_opt


def init_vocoder_state(cfg: TTSConfig, gen: torch.Generator, device) -> VocoderTrainState:
    """Seeded random weights (torch's default families) on `device`."""
    model = HiFiGAN(cfg.vocoder)
    init_defaults_(model, gen)
    return vocoder_state_from_model(model.to(device), cfg)


def vocoder_state_from_model(model: HiFiGAN, cfg: TTSConfig) -> VocoderTrainState:
    """A fresh train state (zero optimizer moments, step 0) around `model`,
    with an EMA generator when training.vocoder.ema_decay > 0."""
    g_opt, d_opt = make_vocoder_optimizers(model, cfg)
    return VocoderTrainState(model=model, g_opt=g_opt, d_opt=d_opt, step=0,
                             g_ema=maybe_init_ema(cfg.training.vocoder, model.generator))


def generator_for_inference(state: VocoderTrainState) -> HiFiGANGenerator:
    """The EMA generator when the state carries one, else the trained one."""
    return inference_params(state.model.generator, state.g_ema)


def generator_params_from_tree(tree: dict) -> dict:
    """The same choice from a checkpoint's payload (`restore_tree`): a
    state_dict of the generator."""
    return tree.get("g_ema") or tree["generator"]


def _f32(tensors) -> List:
    """Every tensor of a (nested) list cast to float32."""
    return [_f32(t) if isinstance(t, list) else t.float() for t in tensors]


def _mean_over_ranks(grads, metrics: Dict[str, torch.Tensor]):
    """The data axis's mean of the gradients and the metrics (one
    collective); identity on a data axis of one rank."""
    if mesh.data_size() == 1:
        return grads, metrics
    terms = [v.detach().reshape(1).clone() for v in metrics.values()]
    grads = list(grads)
    n = mesh.data_size()
    for t in mesh.all_reduce_(grads + terms):
        t.div_(n)
    return grads, {k: t[0] for k, t in zip(metrics, terms)}


def vocoder_train_step(
    state: VocoderTrainState,
    mel: torch.Tensor,  # [B, n_mels, Tfrm]
    wav_real: torch.Tensor,  # [B, 1, Tfrm * hop]
    *,
    audio: AudioConfig,
    loss_mode: str,
    weights: LossWeights = LossWeights(),
    mixed_precision: bool = False,
    d_update_every: int = 1,
    stage: TrainStageConfig = TrainStageConfig(),
    mark: Optional[Callable[[str], None]] = None,
) -> Dict[str, torch.Tensor]:
    """One step; updates `state` in place and returns the step's metrics
    (0-dim float32 tensors on the device).  `mark(name)`, if given, is
    called where each part of the step has been enqueued: "g_forward",
    "d_step" (the discriminators' forward, backward and update) and
    "g_step" (the generator's losses, backward and update)."""
    mark = mark or (lambda name: None)
    model = state.model
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    dev = wav_real.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    metrics: Dict[str, torch.Tensor] = {}
    train_d = should_train_discriminator(loss_mode)
    state.g_opt.gather_()  # the whole weights, where the state is sharded
    if train_d:
        state.d_opt.gather_()

    wav_fake = model.generator(mel, dtype=dtype)  # f32 (tanh in f32)
    mark("g_forward")

    # ---- D step on detached fakes ----
    if train_d:
        d_params = state.d_opt.params
        msd_ro, _, msd_fo, _, mpd_ro, _, mpd_fo, _ = model.discriminate(
            wav_real, wav_fake.detach(), dtype, advance=True)
        d_loss, d_metrics = vocoder_discriminator_loss(_f32(msd_ro + mpd_ro), _f32(msd_fo + mpd_fo))
        d_grads = torch.autograd.grad(d_loss, d_params)
        d_grads, d_metrics = _mean_over_ranks(d_grads, d_metrics)
        state.d_opt.sync_replicated_(d_grads)
        metrics["d_grad_norm"] = global_norm(d_grads)
        if d_update_every <= 1 or state.step % d_update_every == 0:
            state.d_opt.release_()
            state.d_opt.step(d_grads, norm=metrics["d_grad_norm"])
            state.d_opt.gather_()  # the G pass meets the updated D
        metrics.update(d_metrics)
    else:
        metrics["disc_loss"] = zero
    mark("d_step")

    # ---- G step against the updated D ----
    kwargs = {}
    if train_d:
        msd_fo, msd_ff = model.msd(wav_fake, dtype)
        mpd_fo, mpd_ff = model.mpd(wav_fake, dtype)
        kwargs["disc_fake_outputs"] = _f32(msd_fo + mpd_fo)
        if loss_mode == "adv_mel_fm":
            with torch.no_grad():  # the real maps are detached in the loss anyway
                _, msd_rf = model.msd(wav_real, dtype)
                _, mpd_rf = model.mpd(wav_real, dtype)
            kwargs["real_feature_maps"] = _f32(msd_rf + mpd_rf)
            kwargs["fake_feature_maps"] = _f32(msd_ff + mpd_ff)
    g_loss, g_metrics = vocoder_generator_loss(
        wav_real, wav_fake, audio, loss_mode=loss_mode, weights=weights, **kwargs)
    g_grads = torch.autograd.grad(g_loss, state.g_opt.params)
    g_grads, g_metrics = _mean_over_ranks(g_grads, g_metrics)
    state.g_opt.sync_replicated_(g_grads)
    metrics["g_grad_norm"] = global_norm(g_grads)
    state.g_opt.release_()
    state.d_opt.release_()
    state.g_opt.step(g_grads, norm=metrics["g_grad_norm"])
    mark("g_step")
    metrics.update(g_metrics)
    metrics["lr"] = torch.full((), current_lr(stage, state.step), dtype=torch.float32, device=dev)
    if not train_d:
        metrics["d_grad_norm"] = zero
    if state.g_ema is not None:
        ema_update(state.g_ema, model.generator, stage.ema_decay)
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def make_vocoder_step(cfg: TTSConfig, loss_mode: Optional[str] = None) -> Callable:
    """The step bound to the config: (state, mel, wav) -> metrics."""
    tr = cfg.training.vocoder
    return functools.partial(
        vocoder_train_step,
        audio=cfg.audio,
        loss_mode=loss_mode or cfg.vocoder.loss_mode,
        weights=cfg.loss_weights,
        mixed_precision=tr.mixed_precision,
        d_update_every=tr.d_update_every,
        stage=tr,
    )
