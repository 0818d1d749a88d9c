"""Plain layers, the discriminators' normalised convolutions, and the
random-init families of the port.

The JAX package's `models/layers.py` re-implements torch's Conv1d,
ConvTranspose1d and Linear in flax, with TPU lane-filling rewrites
(`fold`, `chain`) and weight/spectral norm for the discriminators.  The port
needs only the plain forms, which PyTorch has natively, so `Conv1d`,
`ConvTranspose1d` and `Linear` are torch's own modules with torch's weight
layouts (Conv1d [Cout, Cin, K], ConvTranspose1d [Cin, Cout, K], Linear
[out, in]).  LayerNorm is computed in float32 with eps 1e-5.

`NormConv1d` / `NormConv2d` are the discriminators' convolutions, with the
JAX package's own weight norm (an eps of 1e-12 inside the square root,
parameters `weight_g` [Cout] and `weight_v`) or spectral norm (`weight`, and
the power iteration's `spectral_u` / `spectral_v` as buffers that advance
only when a forward is asked to, as the flax 'spectral' collection does
only when it is mutable).  torch.nn.utils' weight_norm and spectral_norm
differ from both: no eps, and a power iteration on every training forward.

Every conv helper takes the compute dtype: weights, bias and input are cast
to it at the conv, as the flax layers cast to their `dtype`.

Initialisers take an explicit `torch.Generator` so a pipeline built from a
seed is reproducible on any device.

Dropout draws its masks from explicit generators too (`dropout`): a
training forward takes a host `torch.Generator` (`rng`), and each layer
draws one seed from it for a generator of its own on the activations'
device (`layer_generator`).  A layer recomputed under
`torch.utils.checkpoint` makes its generator again from the same seed, so
its masks, and its gradients, are those of the first pass.  No `rng`
means no dropout, as the flax modules' `deterministic=True`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

Conv1d = nn.Conv1d
ConvTranspose1d = nn.ConvTranspose1d
Linear = nn.Linear

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same' padding for odd kernels."""
    return (kernel_size * dilation - dilation) // 2


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, computed in float32."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )
        return y.to(x.dtype)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def torch_default_init_(m: nn.Module, gen: torch.Generator) -> None:
    """torch's default Linear/Conv init: U(+-1/sqrt(fan_in)) for weight and
    bias (kaiming_uniform with a=sqrt(5) reduces to exactly this bound).
    ConvTranspose1d's fan_in is Cout * K, as torch computes it from its
    [Cin, Cout, K] weight."""
    w = m.weight
    fan_in = w.shape[1] * (w[0][0].numel() if w.dim() > 2 else 1)
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    _uniform_(w, bound, gen)
    if m.bias is not None:
        _uniform_(m.bias, bound, gen)


def xavier_uniform_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_out, fan_in = w.shape[0], w.shape[1]
    _uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def init_defaults_(module: nn.Module, gen: torch.Generator) -> None:
    """Default families for every submodule: torch defaults for Linear and
    convolutions (normalised ones too, see `_NormConv.reset_parameters_`),
    N(0, 1) for embeddings, ones/zeros for LayerNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            torch_default_init_(m, gen)
        elif isinstance(m, _NormConv):
            m.reset_parameters_(gen)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


# ---- dropout from explicit generators -------------------------------------------


def layer_generator(rng: Optional[torch.Generator], device) -> Optional[torch.Generator]:
    """A generator on `device` seeded by one draw from the host generator
    `rng` (None without `rng`).  The draw is on the host: no device sync."""
    if rng is None:
        return None
    return generator_from_seed(draw_seed(rng), device)


def draw_seed(rng: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (), generator=rng))


def generator_from_seed(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax's Dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else 0; identity without a generator."""
    if gen is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def run_layer(layer: nn.Module, remat: bool, rng: Optional[torch.Generator], x: torch.Tensor,
              *args) -> torch.Tensor:
    """layer(x, *args, gen) with the layer's own dropout generator seeded
    from `rng`; under `remat` (and autograd) through torch.utils.checkpoint,
    which makes the generator again from the same seed when it recomputes."""
    seed = None if rng is None else draw_seed(rng)

    def fn(x, *args):
        gen = None if seed is None else generator_from_seed(seed, x.device)
        return layer(x, *args, gen)

    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(x, *args)


# ---- layers at a compute dtype ---------------------------------------------------


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """torch Linear module `m` applied in x's dtype (weights cast at use)."""
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def conv1d(m: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch Conv1d module `m` applied in `dtype`."""
    bias = None if m.bias is None else m.bias.to(dtype)
    return F.conv1d(x.to(dtype), m.weight.to(dtype), bias, m.stride, m.padding, m.dilation,
                    m.groups)


def conv_transpose1d(m: nn.ConvTranspose1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch ConvTranspose1d module `m` applied in `dtype`."""
    return F.conv_transpose1d(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype), m.stride,
                              m.padding, m.output_padding, m.groups, m.dilation)


# ---- weight norm and spectral norm ----------------------------------------------


def _norm_over_fan_in(w: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """sqrt(sum of squares + eps) over every axis but the first (Cout),
    keeping the dims."""
    return torch.sqrt(w.square().sum(dim=tuple(range(1, w.dim())), keepdim=True) + eps)


def weight_norm_weight(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g * v / sqrt(sum(v^2) + 1e-12), the sum over every axis but Cout."""
    return g.reshape(-1, *([1] * (v.dim() - 1))) * v / _norm_over_fan_in(v, 1e-12)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), as torch.nn.functional.normalize."""
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


NORMS = ("weight", "spectral")


class _NormConv(nn.Module):
    """A convolution with weight norm or spectral norm (`norm`).

    `forward(x, dtype, advance)`: the effective weight is computed in the
    masters' float32, then weight, bias and input are cast to `dtype`.
    With spectral norm and advance=True one power iteration runs first
    (without gradient) and u, v are stored; sigma = u^T W v differentiates
    through W only."""

    def __init__(self, weight_shape: Tuple[int, ...], norm: str):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
        self.norm = norm
        cout = weight_shape[0]
        if norm == "weight":
            self.weight_g = nn.Parameter(torch.empty(cout))
            self.weight_v = nn.Parameter(torch.empty(weight_shape))
        else:
            self.weight = nn.Parameter(torch.empty(weight_shape))
            self.register_buffer("spectral_u", torch.empty(cout))
            self.register_buffer("spectral_v", torch.empty(math.prod(weight_shape[1:])))
        self.bias = nn.Parameter(torch.empty(cout))

    @torch.no_grad()
    def reset_parameters_(self, gen: torch.Generator) -> None:
        """torch's default conv init U(+-1/sqrt(fan_in)) for the weight (for
        weight norm: v, with g = ||v|| so that the effective weight is the
        draw) and the bias; spectral u, v are N(0, 1) draws, normalised."""
        w = self.weight_v if self.norm == "weight" else self.weight
        bound = 1.0 / math.sqrt(w[0].numel())
        _uniform_(w, bound, gen)
        _uniform_(self.bias, bound, gen)
        if self.norm == "weight":
            self.weight_g.copy_(_norm_over_fan_in(w).flatten())
        else:
            for buf in (self.spectral_u, self.spectral_v):
                buf.copy_(_l2_normalize(torch.randn(buf.shape, generator=gen)))

    def effective_weight(self, advance: bool = False) -> torch.Tensor:
        if self.norm == "weight":
            return weight_norm_weight(self.weight_g, self.weight_v)
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        if advance:
            with torch.no_grad():
                v = _l2_normalize(w_mat.T @ self.spectral_u)
                u = _l2_normalize(w_mat @ v)
            # new tensors, not in-place writes: an earlier forward's graph
            # keeps the u, v it used
            self.spectral_u, self.spectral_v = u, v
        return self.weight / (self.spectral_u @ (w_mat @ self.spectral_v))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                advance: bool = False) -> torch.Tensor:
        w = self.effective_weight(advance)
        return self._conv(x.to(dtype), w.to(dtype), self.bias.to(dtype))


class NormConv1d(_NormConv):
    """Conv1d on [B, C, T] (torch layout, weight [Cout, Cin/groups, K])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, norm: str = "weight"):
        super().__init__((out_channels, in_channels // groups, kernel_size), norm)
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups

    def _conv(self, x, w, b):
        return F.conv1d(x, w, b, self.stride, self.padding, self.dilation, self.groups)


class NormConv2d(_NormConv):
    """Conv2d on [B, C, H, W] (weight [Cout, Cin, KH, KW])."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Sequence[int],
                 stride: Union[int, Sequence[int]] = 1, padding: Union[int, Sequence[int]] = 0,
                 norm: str = "weight"):
        super().__init__((out_channels, in_channels, *kernel_size), norm)
        self.stride, self.padding = stride, padding

    def _conv(self, x, w, b):
        return F.conv2d(x, w, b, self.stride, self.padding)


@torch.no_grad()
def remove_weight_norm(module: nn.Module) -> None:
    """Fold every weight-norm (g, v) pair into its effective weight, in place:
    v' = g v / ||v||, g' = ||v'||, so the effective weight is unchanged and
    v' is the plain conv weight (the JAX package's `remove_weight_norm`)."""
    for m in module.modules():
        if isinstance(m, _NormConv) and m.norm == "weight":
            w = weight_norm_weight(m.weight_g, m.weight_v)
            m.weight_v.copy_(w)
            m.weight_g.copy_(_norm_over_fan_in(w).flatten())


@torch.no_grad()
def apply_weight_norm(module: nn.Module) -> None:
    """Re-split every weight-norm pair from its v, in place: g = ||v|| (the
    JAX package's `apply_weight_norm`)."""
    for m in module.modules():
        if isinstance(m, _NormConv) and m.norm == "weight":
            m.weight_g.copy_(_norm_over_fan_in(m.weight_v).flatten())
