"""The optimizer of a training stage: learning-rate schedules, optional
global-norm clipping, AdamW, gradient accumulation, and the EMA.

The JAX package builds `MultiSteps(chain(clip?, adamw(schedule)))` in optax;
this is the same function in torch:

* Schedules (`make_lr_schedule`): constant, exponential (staircase: lr *=
  gamma every lr_decay_steps) and warmup_cosine (linear from 0 to lr over
  warmup_steps, then a cosine to lr * lr_end_ratio at lr_total_steps), each
  optionally behind a linear warmup, in optax's formulas.  The step they
  take counts APPLIED updates.
* Clipping: optax's clip_by_global_norm (g unchanged below max_norm, else
  g / ||g|| * max_norm).
* AdamW: torch.optim.AdamW, whose decoupled decay and eps (1e-8, outside
  the square root) are optax's adamw.  optax applies the schedule at the
  update count before the increment; `Optimizer.step` sets each group's lr
  from the schedule at that count before each applied update.
* Accumulation (accumulate_steps = k > 1): optax MultiSteps; the running
  mean acc += (g - acc) / (n + 1) of k gradients is applied as ONE update,
  and the others change nothing.
* EMA: ema <- decay * ema + (1 - decay) * params after every step.
* Tensor parallelism (`Optimizer.shard_`, parallel/sharding_rules.py):
  between steps each rank holds only its model-axis slice of every
  sharded parameter, of its two Adam moments and of its accumulator (and
  `shard_module_` slices the EMA copy alike).  A step gathers the whole
  parameters (`gather_`), computes whole gradients, returns to the slices
  (`release_`), and `step` keeps its own slice of each gradient: clipping,
  AdamW, accumulation and the EMA are elementwise, so each slice is
  updated as the whole tensor would be.  The clip's norm is the whole
  gradient's: given by the caller, or, for an accumulated update, taken
  from the accumulator gathered whole.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from ..config import ConfigError, TrainStageConfig
from ..parallel import mesh, sharding_rules


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (a polynomial of power 1)."""
    if steps <= 0:
        return lambda count: init

    def sched(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return sched


def _join(first: Callable, then: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules."""
    return lambda count: first(count) if count < boundary else then(count - boundary)


def make_lr_schedule(tr: TrainStageConfig,
                     base_lr: Optional[float] = None) -> Callable[[int], float]:
    """applied-update count -> learning rate; `base_lr` overrides
    tr.learning_rate (the discriminator's own rate)."""
    lr = tr.learning_rate if base_lr is None else base_lr
    kind = tr.lr_schedule
    if kind == "constant":
        sched = lambda count: lr  # noqa: E731
    elif kind == "exponential":
        steps, gamma = tr.lr_decay_steps, tr.lr_decay_gamma
        def sched(count):
            if steps <= 0 or gamma == 0 or count <= 0:
                return lr
            return lr * gamma ** math.floor(count / steps)
    elif kind == "warmup_cosine":
        warmup = max(tr.warmup_steps, 1)
        decay = max(tr.lr_total_steps, tr.warmup_steps + 1) - warmup
        end = lr * tr.lr_end_ratio
        alpha = 0.0 if lr == 0.0 else end / lr

        def cosine(count):
            c = min(count, decay)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

        sched = _join(_linear(0.0, lr, warmup), cosine, warmup)
    else:
        raise ConfigError(
            f"unknown lr_schedule {kind!r}; expected constant | exponential | warmup_cosine"
        )
    if kind != "warmup_cosine" and tr.warmup_steps > 0:
        sched = _join(_linear(0.0, lr, tr.warmup_steps), sched, tr.warmup_steps)
    return sched


def current_lr(tr: TrainStageConfig, step: int, base_lr: Optional[float] = None) -> float:
    """The schedule's value at train-loop `step` (micro-steps): the applied
    update count is step // accumulate_steps."""
    return make_lr_schedule(tr, base_lr)(step // max(tr.accumulate_steps, 1))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), from
    one foreach launch of the per-tensor norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer:
    """clip? -> AdamW(schedule), accumulated over accumulate_steps
    micro-steps.  `step(grads, norm)` takes the (whole) gradients of
    `params` in order and, optionally, their `global_norm` when the caller
    has it already: the clip reuses it unless accumulating.  `dims` gives
    each parameter's model-axis dimension once sharded (`shard_`), None
    for a whole one."""

    def __init__(self, params: Sequence[nn.Parameter], tr: TrainStageConfig,
                 base_lr: Optional[float] = None):
        self.params = list(params)
        self.schedule = make_lr_schedule(tr, base_lr)
        self.clip = tr.gradient_clip
        self.k = tr.accumulate_steps
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(tr.beta1, tr.beta2),
                                       eps=1e-8, weight_decay=tr.weight_decay)
        self.applied = 0  # updates applied: the schedule's count
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else []
        self.dims: List[Optional[int]] = [None] * len(self.params)
        self.sharded = False
        self._shards: Optional[List[torch.Tensor]] = None  # the slices while gathered

    # ---- tensor parallelism ----

    def _sharded(self, tensors):
        return [t for t, d in zip(tensors, self.dims) if d is not None]

    @torch.no_grad()
    def shard_(self, dims: Sequence[Optional[int]]) -> None:
        """Keep this rank's slice of every parameter with a dimension in
        `dims`, of its moments and of its accumulator."""
        self.dims, self.sharded = list(dims), True
        for p, d in zip(self.params, self.dims):
            if d is None:
                continue
            p.data = sharding_rules.own([p.data], [d])[0]
            st = self.adamw.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = sharding_rules.own([st[k]], [d])[0]
        self.acc = sharding_rules.own(self.acc, self.dims) if self.acc else []

    @torch.no_grad()
    def gather_(self) -> None:
        """The whole parameters in place of the slices (one collective), for
        a forward and backward; a no-op unless sharded."""
        if not self.sharded or self._shards is not None:
            return
        self._shards = self._sharded([p.data for p in self.params])
        dims = self._sharded(self.dims)
        for p, full in zip(self._sharded(self.params),
                           sharding_rules.gather(self._shards, dims)):
            p.data = full

    def release_(self) -> None:
        """Back to the slices (the whole copies are freed); a no-op unless
        gathered."""
        if self._shards is None:
            return
        for p, s in zip(self._sharded(self.params), self._shards):
            p.data = s
        self._shards = None

    def sync_replicated_(self, grads: Sequence[torch.Tensor]) -> None:
        """The whole (replicated) parameters' gradients of the model group's
        first rank on every rank of the group, so that those parameters stay
        bit-equal across the group; a no-op unless sharded."""
        if self.sharded:
            mesh.broadcast_model_([g for g, d in zip(grads, self.dims) if d is None])

    def whole_norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """`global_norm` of the whole tensors of which `tensors` (one per
        parameter) hold this rank's slices."""
        if self.sharded:
            tensors = sharding_rules.gather(tensors, self.dims)
        return global_norm(tensors)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             norm: Optional[torch.Tensor] = None) -> None:
        if self.sharded:
            if self._shards is not None:
                raise RuntimeError("Optimizer.step on gathered parameters: release_() first")
            grads = [g if d is None else mesh.own_slice(g, d).contiguous()
                     for g, d in zip(grads, self.dims)]
        if self.k > 1:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return
            grads, norm = self.acc, None
        if self.clip is not None:
            norm = self.whole_norm(grads) if norm is None else norm
            grads = [torch.where(norm < self.clip, g, g / norm * self.clip) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.applied)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.applied += 1
        if self.k > 1:
            self.mini_step = 0
            for a in self.acc:
                a.zero_()

    def state_dict(self) -> dict:
        """The state with whole tensors: sharded moments and accumulator
        gathered (one collective, on every rank of the model group)."""
        sd = {"adamw": self.adamw.state_dict(), "applied": self.applied,
              "mini_step": self.mini_step, "acc": list(self.acc)}
        if self.sharded:
            state = {i: dict(st) for i, st in sd["adamw"]["state"].items()}
            slots = [(i, k) for i, d in enumerate(self.dims) if d is not None
                     for k in ("exp_avg", "exp_avg_sq") if k in state.get(i, {})]
            acc_at = [i for i, d in enumerate(self.dims) if d is not None] if self.acc else []
            full = sharding_rules.gather(
                [state[i][k] for i, k in slots] + [self.acc[i] for i in acc_at],
                [self.dims[i] for i, _ in slots] + [self.dims[i] for i in acc_at])
            for (i, k), t in zip(slots, full):
                state[i][k] = t
            for i, t in zip(acc_at, full[len(slots):]):
                sd["acc"][i] = t
            sd["adamw"] = dict(sd["adamw"], state=state)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        if self.sharded:
            raise RuntimeError("restore a checkpoint into the whole state, before it is sharded")
        self.adamw.load_state_dict(sd["adamw"])
        self.applied = int(sd["applied"])
        self.mini_step = int(sd["mini_step"])
        if len(sd["acc"]) != len(self.acc):
            raise ValueError("checkpoint's accumulation state does not match accumulate_steps")
        with torch.no_grad():
            for a, s in zip(self.acc, sd["acc"]):
                a.copy_(s)


@torch.no_grad()
def ema_update(ema: nn.Module, module: nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    for e, p in zip(ema.parameters(), module.parameters()):
        e.copy_(e * decay + p * (1.0 - decay))


def ema_copy(module: nn.Module) -> nn.Module:
    """A copy of the module to average into, outside autograd."""
    return copy.deepcopy(module).requires_grad_(False)


def maybe_init_ema(tr: TrainStageConfig, module: nn.Module) -> Optional[nn.Module]:
    """The EMA starts as a copy of the parameters; None when ema_decay is 0."""
    return ema_copy(module) if tr.ema_decay > 0.0 else None


def inference_params(module: nn.Module, ema: Optional[nn.Module]) -> nn.Module:
    """Prefer the EMA copy for inference and eval when it exists."""
    return module if ema is None else ema


# ---- the trainers' command lines ----------------------------------------------

# (flag, field of TrainStageConfig, type, help) shared by both trainers
_STAGE_FLAGS = (
    ("--lr-schedule", "lr_schedule", str, "learning-rate schedule: constant | exponential | "
     "warmup_cosine"),
    ("--lr-decay-gamma", "lr_decay_gamma", float,
     "exponential: multiply lr by this every --lr-decay-steps"),
    ("--warmup-steps", "warmup_steps", int, "linear LR warmup steps (any schedule)"),
    ("--lr-total-steps", "lr_total_steps", int,
     "warmup_cosine: the step at which the cosine reaches its floor"),
    ("--lr-decay-steps", "lr_decay_steps", int, "exponential: decay interval in steps"),
    ("--ema-decay", "ema_decay", float,
     "EMA decay of the trained parameters (0 = off; inference prefers the EMA copy)"),
    ("--accumulate-steps", "accumulate_steps", int,
     "average k micro-batch gradients into one optimizer update"),
)


def add_stage_flags(p: argparse.ArgumentParser) -> None:
    """The optimizer flags both trainers take, each overriding a field of
    the stage's TrainStageConfig when given."""
    for flag, field, typ, help_ in _STAGE_FLAGS:
        kw = {"choices": ["constant", "exponential", "warmup_cosine"]} if field == "lr_schedule" \
            else {}
        p.add_argument(flag, dest=field, metavar=field.split('_')[-1].upper(), type=typ,
                       default=None, help=help_, **kw)


def stage_overrides(tr: TrainStageConfig, args: argparse.Namespace,
                    extra: Sequence[str] = ()) -> TrainStageConfig:
    """`tr` with the flags of `add_stage_flags` (and the `extra` fields of
    the same names in `args`) that were given."""
    for field in [f for _, f, _, _ in _STAGE_FLAGS] + list(extra):
        val = getattr(args, field)
        if val is not None:
            tr = dataclasses.replace(tr, **{field: val})
    return tr
