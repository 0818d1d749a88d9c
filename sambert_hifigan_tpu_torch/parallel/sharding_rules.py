"""The shape rule of tensor parallelism over the 'model' axis, the port's own
form of the JAX package's `parallel/sharding_rules.py`.

JAX rule: every leaf of rank >= 2 whose last (output) dimension divides the
model axis's size is sharded on that dimension; vectors and scalars are
replicated; the ConvTranspose kernels `up_*` are replicated (their
partitioned backward is a flood of tiny all-to-alls there).  The port's
tensors hold the same leaves in torch layouts (`weights.py`), so the rule
names the torch dimension that holds the JAX last one:

  Linear      weight [out, in]          dim 0  (flax kernel [in, out])
  Conv1d/2d   weight [Cout, Cin, ...]   dim 0  (flax kernel [..., Cin, Cout]);
              weight norm's `weight_v` and spectral norm's `weight` too
  Embedding   weight [n, d]             dim 1  (flax embedding [n, d])

and replicates what JAX replicates: every vector (biases, LayerNorm,
weight norm's `weight_g` [Cout], which flax stores as a vector too),
the spectral-norm `spectral_u`/`spectral_v` (buffers here, vectors there),
the Adam step counts (scalars), and the upsamplers `ups.{i}` (JAX `up_{i}`).

The rule applies alike to the parameters, to both Adam moments of their
optimizer and to the EMA copy (`training/optim.py`: `Optimizer.shard_`,
`shard_module_`), as JAX `shard_tree` applies it to the whole train state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from . import mesh

# module names whose parameters always stay whole (see the module docstring)
TP_EXCLUDE = ("ups",)


def tp_dim(name: str, param: torch.Tensor, owner: nn.Module, model: int) -> Optional[int]:
    """The dimension of parameter `name` (of module `owner`) split over a
    model axis of `model` ranks, or None where it stays whole."""
    if model <= 1 or param.dim() < 2 or any(p in TP_EXCLUDE for p in name.split(".")):
        return None
    dim = 1 if isinstance(owner, nn.Embedding) else 0
    return dim if param.shape[dim] % model == 0 else None


def param_dims(modules: Sequence[nn.Module], model: int) -> List[Optional[int]]:
    """`tp_dim` of every parameter of `modules`, in the order of their
    `parameters()` (the order of an optimizer built on them)."""
    dims = []
    for module in modules:
        owners = dict(module.named_modules())
        for name, p in module.named_parameters():
            dims.append(tp_dim(name, p, owners[name.rpartition(".")[0]], model))
    return dims


def own(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """This rank's slices (new contiguous tensors) of the sharded ones of
    `tensors`; the others as they are."""
    return [t if d is None else mesh.own_slice(t, d).clone(memory_format=torch.contiguous_format)
            for t, d in zip(tensors, dims)]


def gather(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """The whole tensors of `tensors`, the sharded ones gathered over the
    model group in one collective; the others as they are."""
    tensors = list(tensors)
    at = [i for i, d in enumerate(dims) if d is not None]
    for i, full in zip(at, mesh.all_gather_([tensors[i] for i in at], [dims[i] for i in at])):
        tensors[i] = full
    return tensors


@torch.no_grad()
def shard_module_(module: nn.Module, dims: Sequence[Optional[int]]) -> None:
    """Keep this rank's slice of each sharded parameter of `module`, in
    place (`.data`); `dims` in the order of its parameters."""
    for p, d in zip(module.parameters(), dims):
        if d is not None:
            p.data = own([p.data], [d])[0]


def full_module_state(module: nn.Module, dims: Sequence[Optional[int]]) -> dict:
    """`module.state_dict()` with its sharded parameters whole (one gather)."""
    sd = module.state_dict()
    names = [n for n, _ in module.named_parameters()]
    full = gather([sd[n] for n in names], dims)
    sd.update(zip(names, full))
    return sd
