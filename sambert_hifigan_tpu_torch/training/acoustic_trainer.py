"""Acoustic-model training, one step: the teacher-forced forward, the
acoustic losses on the batch's masks, clip -> AdamW(schedule) with optional
accumulation (training/optim.py), and the EMA.

Scheduled sampling (p > 0) is two passes: pass 1 is the ordinary
teacher-forced forward, without gradient; pass 2 runs again with each
decoder-input frame replaced, with probability p (a per-frame Bernoulli
mask from the step's generator), by pass 1's prediction, and the loss is
taken on pass 2.  Both passes draw the same dropout masks, as the JAX step
gives both the same key.  Targets never change.

Mixed precision (mixed_precision=True): the model computes in bf16 (weights
cast at use, LayerNorm and softmax in f32) and its outputs are cast to f32
at the loss boundary, so the losses, the gradients' reductions and the
optimizer run in f32 on f32 masters.  bf16 shares f32's exponent range: no
loss scale.

Data parallel (parallel/mesh.py, in a process group): each rank holds a
replica and its rows of the global batch, and the step computes the JAX
step's global math.  The four loss denominators are summed over the ranks
before the losses (one collective of 4 scalars), so each rank's terms are
its share of the global masked means; the gradients and the terms are then
SUM-reduced together (one collective), and the norm, the clip, AdamW,
accumulation (each micro-step reduced) and the EMA run on the reduced
gradients, the same on every rank.  The scheduled-sampling mask is drawn
for the global batch and sliced to the rank's rows; the dropout seed is
drawn in lockstep and the rank folded into it (rank 0 keeps it).

Tensor parallel (a sharded state, `AcousticTrainState.shard_`): "ranks"
above means the data axis.  The ranks of one model group hold the same
rows and draw the same masks (the data index is what is folded); the step
gathers the whole weights over the model group first (one collective),
runs the unchanged forward and backward, reduces the whole gradients over
the data axis only, gives the replicated leaves' gradients of the group's
first rank to the others, takes the norm of the whole gradients (JAX's
global norm), and returns to the slices, which AdamW and the EMA update
elementwise.  No activation moves between ranks.

The training path reaches no hand-written kernel: the JAX trainer reaches
neither Pallas call (they sit behind `ar_decode` and the fused generator),
so it is plain torch (cuBLAS, cuDNN).  Metrics stay on the device.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from ..config import LossWeights, TrainStageConfig, TTSConfig
from ..losses.acoustic import acoustic_loss, loss_counts
from ..models.acoustic_model import SAMBERTAcousticModel
from ..models.layers import draw_seed, generator_from_seed
from ..parallel import mesh
from .optim import (Optimizer, current_lr, ema_update, global_norm, inference_params,
                    maybe_init_ema)
from .train_state import AcousticTrainState


def make_acoustic_optimizer(model: SAMBERTAcousticModel, cfg: TTSConfig) -> Optimizer:
    return Optimizer(model.parameters(), cfg.training.acoustic)


def init_acoustic_state(model: SAMBERTAcousticModel, cfg: TTSConfig) -> AcousticTrainState:
    """A fresh train state (zero optimizer moments, step 0) around `model`,
    with an EMA copy when training.acoustic.ema_decay > 0."""
    return AcousticTrainState(model=model, opt=make_acoustic_optimizer(model, cfg), step=0,
                              ema=maybe_init_ema(cfg.training.acoustic, model))


def acoustic_inference_params(state: AcousticTrainState) -> SAMBERTAcousticModel:
    """The EMA model when the state carries one, else the trained one."""
    return inference_params(state.model, state.ema)


def acoustic_params_from_tree(tree: dict) -> dict:
    """The same choice from a checkpoint's payload (`restore_tree`): a
    state_dict of the acoustic model."""
    return tree.get("ema") or tree["model"]


def sampling_mask(seed: int, shape, p: float, device) -> torch.Tensor:
    """Scheduled sampling's per-frame Bernoulli(p) mask [B, T, 1] for this
    rank's rows: drawn for the global batch (B x data-axis size rows), as
    JAX draws it over the global array, and sliced."""
    b, t = shape[:2]
    gen = generator_from_seed(seed, device)
    draw = torch.rand((b * mesh.data_size(), t, 1), generator=gen, device=device) < p
    return mesh.shard_rows(draw)


def acoustic_train_step(
    state: AcousticTrainState,
    batch: Dict[str, torch.Tensor],
    rng: torch.Generator,
    *,
    weights: LossWeights = LossWeights(),
    scheduled_sampling: float = 0.0,
    mixed_precision: bool = False,
    stage: TrainStageConfig = TrainStageConfig(),
    mark: Optional[Callable[[str], None]] = None,
) -> Dict[str, torch.Tensor]:
    """One step; updates `state` in place and returns the metrics (0-dim
    float32 tensors on the device): total_loss, mel_loss, dur_loss,
    pitch_loss, energy_loss, grad_norm (before clipping), lr.

    batch (tensors on the model's device): ph_ids, tone_ids, boundary_ids,
    dur_gt [B, Tph] int; mel_gt [B, T, n_mels]; pitch_gt, energy_gt [B, T];
    phoneme_mask [B, Tph] and pitch_mask [B, T] bool.  `rng` is a host
    generator: the step draws its dropout and sampling seeds from it.
    `mark(name)`, if given, is called where "forward", "backward" and
    "optimizer" have been enqueued."""
    mark = mark or (lambda name: None)
    model = state.model
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    dropout_seed, sampling_seed = draw_seed(rng), draw_seed(rng)
    dropout_seed = mesh.fold_rank(dropout_seed)  # shards must not share masks
    state.opt.gather_()  # the whole weights, where the state is sharded

    def forward(teacher_mel):
        return model(batch["ph_ids"], batch["tone_ids"], batch["boundary_ids"], teacher_mel,
                     batch["dur_gt"], batch.get("pitch_gt"), batch.get("energy_gt"),
                     batch.get("phoneme_mask"),
                     rng=torch.Generator().manual_seed(dropout_seed), dtype=dtype)

    teacher = batch["mel_gt"]
    if scheduled_sampling > 0.0:
        with torch.no_grad():
            own = forward(teacher).mel_pred
        keep_own = sampling_mask(sampling_seed, teacher.shape, scheduled_sampling,
                                 teacher.device)
        teacher = torch.where(keep_own, own.to(teacher.dtype), teacher)
    out = forward(teacher)
    pred = out.predictions
    counts = None
    if mesh.data_size() > 1:  # the global denominators, before the losses
        counts = mesh.all_reduce_([loss_counts(
            batch["mel_gt"], batch["dur_gt"], batch["pitch_gt"], out.frame_mask,
            batch.get("phoneme_mask"), batch.get("pitch_mask"))])[0]
    total, metrics = acoustic_loss(
        out.mel_pred.float(), batch["mel_gt"],
        pred["log_dur_pred"].float(), batch["dur_gt"],
        pred["pitch_frm"].float(), batch["pitch_gt"],
        pred["energy_frm"].float(), batch["energy_gt"],
        mel_mask=out.frame_mask, phoneme_mask=batch.get("phoneme_mask"),
        pitch_mask=batch.get("pitch_mask"), weights=weights, counts=counts,
    )
    mark("forward")
    grads = torch.autograd.grad(total, state.opt.params)
    if mesh.data_size() > 1:  # gradients and loss terms: global sums
        terms = [metrics[k].detach().reshape(1).clone() for k in metrics]
        mesh.all_reduce_(list(grads) + terms)
        metrics = {k: t[0] for k, t in zip(metrics, terms)}
    state.opt.sync_replicated_(grads)
    mark("backward")
    metrics["grad_norm"] = global_norm(grads)
    state.opt.release_()
    state.opt.step(grads, norm=metrics["grad_norm"])
    metrics["lr"] = torch.full((), current_lr(stage, state.step), dtype=torch.float32,
                               device=teacher.device)
    if state.ema is not None:
        ema_update(state.ema, model, stage.ema_decay)
    mark("optimizer")
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def make_acoustic_step(cfg: TTSConfig) -> Callable:
    """The step bound to the config: (state, batch, rng) -> metrics."""
    tr = cfg.training.acoustic
    return functools.partial(
        acoustic_train_step, weights=cfg.loss_weights,
        scheduled_sampling=tr.scheduled_sampling, mixed_precision=tr.mixed_precision,
        stage=tr,
    )
