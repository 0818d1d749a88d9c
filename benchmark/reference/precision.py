"""The precision a reference computation runs in.

`f32` is the plain reference: every product in IEEE float32 (TF32 off, see
`ieee_f32`).  `fp8` is the control: the same functions with both operands
of every matrix product and convolution rounded to float8 e4m3 with one
scale per tensor (its largest magnitude at e4m3's largest value, 448), the
step below the bf16 that the configurations state.  The rounding passes the
gradient straight through, so a training control is fp8 in its forwards.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x).detach() if x.requires_grad else y


PRECISIONS = {"f32": identity, "fp8": fp8}


def rounder(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    return PRECISIONS[precision]


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for matrix products and cuDNN convolutions, restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
