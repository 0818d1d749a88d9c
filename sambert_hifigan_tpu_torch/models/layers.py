"""Plain layers and the random-init families of the port.

The JAX package's `models/layers.py` re-implements torch's Conv1d,
ConvTranspose1d and Linear in flax, with TPU lane-filling rewrites
(`fold`, `chain`) and weight/spectral norm for the discriminators.  The
inference path needs only the plain forms, which PyTorch has natively, so
`Conv1d`, `ConvTranspose1d` and `Linear` are torch's own modules with torch's
weight layouts (Conv1d [Cout, Cin, K], ConvTranspose1d [Cin, Cout, K],
Linear [out, in]).  LayerNorm is computed in float32 with eps 1e-5.

Initialisers take an explicit `torch.Generator` so a pipeline built from a
seed is reproducible on any device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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
    convolutions, N(0, 1) for embeddings, ones/zeros for LayerNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            torch_default_init_(m, gen)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0, generator=gen)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
