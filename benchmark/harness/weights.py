"""Weights made on the device from the seed, in the system's state_dict
layout: one uniform and one normal draw on a card generator for every
tensor together, then each tensor scaled to its family.

Families (those of torch's modules, as a trained model starts):
  embeddings                        N(0, 1)
  LayerNorm                         weight 1, bias 0
  attention projections (q, k, v; every decoder matrix)   xavier uniform,
                                    attention biases 0
  every other weight and bias       U(+-1 / sqrt(fan_in)); a transposed
                                    conv's fan_in is Cout * K
  weight-normed convs               v as above, g = ||v|| per output channel
The variance predictors' output layers are pinned (`pin_predictors`).
A model with tensors of other families passes `make` its own `family`,
which answers for those and hands every other name to `_family`.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]

_ATTN = re.compile(r"(self_attn|cross_attn)\.w[qkvo]\.(weight|bias)$")
_LN = re.compile(r"(norm\d?|norms\.\d+|final_norm)\.(weight|bias)$")


def _family(name: str, shape) -> Tuple[str, float]:
    """(kind, scale) of one tensor: kind is 'normal', 'uniform', 'one' or
    'zero'."""
    if name.endswith("emb.weight"):
        return "normal", 1.0
    if _LN.search(name):
        return ("one" if name.endswith("weight") else "zero"), 0.0
    decoder = name.startswith("ar_decoder.")
    m = _ATTN.search(name)
    if m and name.endswith("bias"):
        return "zero", 0.0
    if name.endswith(".weight") and len(shape) == 2 and (decoder or (m and not
                                                                      name.endswith("wo.weight"))):
        return "uniform", math.sqrt(6.0 / (shape[0] + shape[1]))
    return "uniform", None  # fan-in bound, worked out by `make`


def _fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    stem = name.rsplit(".", 1)[0]
    w = shapes.get(stem + ".weight", shapes.get(stem + ".weight_v"))
    if ".ups." in f".{stem}":
        return w[1] * w[2]  # ConvTranspose1d [Cin, Cout, K]
    return math.prod(w[1:])


def make(shapes: Shapes, seed: int, device,
         family: Callable[[str, Tuple[int, ...]], Tuple[str, float]] = _family
         ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for every (name, shape), from `seed`; each
    tensor's (kind, scale) from `family`, as `_family` gives them."""
    by_name = dict(shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    fams = {n: family(n, s) for n, s in shapes}
    n_uni = sum(math.prod(s) for n, s in shapes if fams[n][0] == "uniform")
    n_norm = sum(math.prod(s) for n, s in shapes if fams[n][0] == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2.0).sub_(1.0)
    nor = torch.randn(n_norm, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape in shapes:
        kind, scale = fams[name]
        size = math.prod(shape)
        if kind == "uniform":
            bound = scale if scale is not None else 1.0 / math.sqrt(_fan_in(name, by_name))
            out[name] = uni[iu:iu + size].view(shape).mul_(bound)
            iu += size
        elif kind == "normal":
            out[name] = nor[inn:inn + size].view(shape)
            inn += size
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    for name in [n for n in out if n.endswith(".weight_g")]:
        v = out[name[:-2] + "_v"]
        out[name] = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
    return out


def pin_predictors(sd: Dict[str, torch.Tensor], c: dict) -> None:
    """Pin each variance predictor's output: its bias to the configuration's
    value (log frames a phoneme for durations, Hz for pitch, the energy)
    and its kernel scaled by `predictor_kernel_scale`, so that phonemes last
    about as long as a trained voice's (random weights give about one frame
    each) and every duration, pitch bin and energy bin lies far from a
    rounding edge, where bf16 and the f32 reference would part."""
    va = "variance_adaptor."
    for name, value in (("duration", math.log(c["frames_per_phoneme"])),
                        ("pitch", c["pitch_hz"]), ("energy", c["energy"])):
        lin = f"{va}{name}_predictor.linear."
        sd[lin + "bias"].fill_(value)
        sd[lin + "weight"].mul_(c["predictor_kernel_scale"])
