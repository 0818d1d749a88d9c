"""VITS inference in plain PyTorch, f32: the reference of the `vits`
configurations (Kim, Kong and Son 2021, arXiv:2106.06103; jaywalnut310/vits
models.py `SynthesizerTrn.infer`, attentions.py, modules.py, transforms.py,
commons.py), written as those files compute it.

tokens (phoneme ids interspersed with blank 0) -> TextEncoder (embedding x
sqrt(hidden), post-norm layers of multi-head attention with windowed
relative keys and values, shared by the heads, and an FFN of two k-convs;
a 1x1 projection to m_p, logs_p) -> StochasticDurationPredictor in reverse
(Flip, then ConvFlow and Flip for all flows but the first, then the
ElementwiseAffine, on noise x noise_scale_w; each ConvFlow an inverse
rational-quadratic spline with linear tails) -> w_ceil = ceil(exp(logw) x
length_scale) -> generate_path -> z_p = m_p + eps x exp(logs_p) x
noise_scale -> ResidualCouplingBlock in reverse (mean-only couplings over a
WaveNet) -> the HiFi-GAN generator (LeakyReLU 0.1 inside, 0.01 before a
conv_post without bias) -> wav.  Weights are read by VITS's state_dict
names (`enc_p.`, `dp.`, `flow.`, `dec.`), weight norm folded.

Departures from jaywalnut310/vits, each the system's documented contract:
- the noise: each row draws its own from a generator seeded by
  `row_seed(noise seed, its valid tokens)`, z as [max tokens, 2] and then
  eps as [max frames, channels], N(0, 1), cut to the call's sizes (VITS
  draws both from the global generator, in the call's shape);
- the sizes: tokens are padded to 2 x the phoneme bucket + 1 and frames to
  a frame bucket (12 frames a front-end phoneme of the bucket, one re-run
  at the bucket that fits when a row needs more), where VITS pads to the
  batch's longest; the decoder's convolutions pad at the bucket's end;
- the precision: every matrix product's and convolution's operands pass
  through `q` (the identity for the f32 reference; TF32 is the caller's to
  turn off, as `synthesize_batch` does).

Imports nothing but torch, numpy and the standard library.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Round = Callable[[torch.Tensor], torch.Tensor]
LRELU_SLOPE = 0.1


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


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


def conv(P, name, x, q, **kw):
    return F.conv1d(q(x), q(P[name + ".weight"]), P.get(name + ".bias"), **kw)


def matmul(a, b, q):
    return torch.matmul(q(a), q(b))


def sequence_mask(length, max_length):
    x = torch.arange(max_length, dtype=length.dtype, device=length.device)
    return x.unsqueeze(0) < length.unsqueeze(1)


def layer_norm(P, name, x):
    x = x.transpose(1, -1)
    x = F.layer_norm(x, (x.shape[-1],), P[name + ".gamma"], P[name + ".beta"], 1e-5)
    return x.transpose(1, -1)


# ---- attentions.py ----------------------------------------------------------------


def relative_embeddings(emb, length, window):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    end = start + 2 * length - 1
    if pad > 0:
        emb = F.pad(emb, [0, 0, pad, pad, 0, 0])
    return emb[:, start:end]


def relative_to_absolute(x):
    """[b, h, l, 2l - 1] -> [b, h, l, l]"""
    batch, heads, length, _ = x.size()
    x = F.pad(x, [0, 1, 0, 0, 0, 0, 0, 0])
    x_flat = x.view([batch, heads, length * 2 * length])
    x_flat = F.pad(x_flat, [0, length - 1, 0, 0, 0, 0])
    return x_flat.view([batch, heads, length + 1, 2 * length - 1])[:, :, :length, length - 1:]


def absolute_to_relative(x):
    """[b, h, l, l] -> [b, h, l, 2l - 1]"""
    batch, heads, length, _ = x.size()
    x = F.pad(x, [0, length - 1, 0, 0, 0, 0, 0, 0])
    x_flat = x.view([batch, heads, length ** 2 + length * (length - 1)])
    x_flat = F.pad(x_flat, [length, 0, 0, 0, 0, 0])
    return x_flat.view([batch, heads, length, 2 * length])[:, :, :, 1:]


def attention(P, name, x, attn_mask, c, q):
    heads, window = c["n_heads"], c["window_size"]
    query, key, value = (conv(P, f"{name}.conv_{n}", x, q) for n in "qkv")
    b, d, t = key.size()
    kc = d // heads
    query = query.view(b, heads, kc, t).transpose(2, 3)
    key = key.view(b, heads, kc, t).transpose(2, 3)
    value = value.view(b, heads, kc, t).transpose(2, 3)
    scores = matmul(query / math.sqrt(kc), key.transpose(-2, -1), q)
    rel_k = relative_embeddings(P[name + ".emb_rel_k"], t, window)
    rel_logits = matmul(query / math.sqrt(kc), rel_k.unsqueeze(0).transpose(-2, -1), q)
    scores = scores + relative_to_absolute(rel_logits)
    scores = scores.masked_fill(attn_mask == 0, -1e4)
    p_attn = F.softmax(scores, dim=-1)
    output = matmul(p_attn, value, q)
    rel_v = relative_embeddings(P[name + ".emb_rel_v"], t, window)
    output = output + matmul(absolute_to_relative(p_attn), rel_v.unsqueeze(0), q)
    output = output.transpose(2, 3).contiguous().view(b, d, t)
    return conv(P, name + ".conv_o", output, q)


def ffn(P, name, x, x_mask, c, q):
    k = c["kernel_size"]
    pad = [(k - 1) // 2, k // 2]
    x = conv(P, name + ".conv_1", F.pad(x * x_mask, pad), q)
    x = torch.relu(x)
    x = conv(P, name + ".conv_2", F.pad(x * x_mask, pad), q)
    return x * x_mask


def text_encoder(P, c, tokens, x_mask, q):
    h = c["hidden_channels"]
    x = (P["enc_p.emb.weight"][tokens] * math.sqrt(h)).transpose(1, -1)
    attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    x = x * x_mask
    for i in range(c["n_layers"]):
        e = "enc_p.encoder"
        y = attention(P, f"{e}.attn_layers.{i}", x, attn_mask, c, q)
        x = layer_norm(P, f"{e}.norm_layers_1.{i}", x + y)
        y = ffn(P, f"{e}.ffn_layers.{i}", x, x_mask, c, q)
        x = layer_norm(P, f"{e}.norm_layers_2.{i}", x + y)
    x = x * x_mask
    stats = conv(P, "enc_p.proj", x, q) * x_mask
    m, logs = torch.split(stats, c["inter_channels"], dim=1)
    return x, m, logs


# ---- transforms.py ----------------------------------------------------------------

MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3


def searchsorted(bin_locations, inputs, eps=1e-6):
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def rational_quadratic_spline(inputs, uw, uh, ud, inverse, left, right, bottom, top):
    num_bins = uw.shape[-1]
    widths = F.softmax(uw, dim=-1)
    widths = MIN_BIN_WIDTH + (1 - MIN_BIN_WIDTH * num_bins) * widths
    cumwidths = torch.cumsum(widths, dim=-1)
    cumwidths = F.pad(cumwidths, pad=(1, 0), mode="constant", value=0.0)
    cumwidths = (right - left) * cumwidths + left
    cumwidths[..., 0] = left
    cumwidths[..., -1] = right
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    derivatives = MIN_DERIVATIVE + F.softplus(ud)
    heights = F.softmax(uh, dim=-1)
    heights = MIN_BIN_HEIGHT + (1 - MIN_BIN_HEIGHT * num_bins) * heights
    cumheights = torch.cumsum(heights, dim=-1)
    cumheights = F.pad(cumheights, pad=(1, 0), mode="constant", value=0.0)
    cumheights = (top - bottom) * cumheights + bottom
    cumheights[..., 0] = bottom
    cumheights[..., -1] = top
    heights = cumheights[..., 1:] - cumheights[..., :-1]
    bin_idx = searchsorted(cumheights if inverse else cumwidths, inputs)[..., None]
    input_cumwidths = cumwidths.gather(-1, bin_idx)[..., 0]
    input_bin_widths = widths.gather(-1, bin_idx)[..., 0]
    input_cumheights = cumheights.gather(-1, bin_idx)[..., 0]
    delta = heights / widths
    input_delta = delta.gather(-1, bin_idx)[..., 0]
    input_derivatives = derivatives.gather(-1, bin_idx)[..., 0]
    input_derivatives_plus_one = derivatives[..., 1:].gather(-1, bin_idx)[..., 0]
    input_heights = heights.gather(-1, bin_idx)[..., 0]
    slope = input_derivatives + input_derivatives_plus_one - 2 * input_delta
    if inverse:
        a = (inputs - input_cumheights) * slope + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - (inputs - input_cumheights) * slope
        c = -input_delta * (inputs - input_cumheights)
        discriminant = b.pow(2) - 4 * a * c
        assert (discriminant >= 0).all()
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denominator = input_delta + slope * theta_one_minus_theta
        derivative_numerator = input_delta.pow(2) * (
            input_derivatives_plus_one * root.pow(2) + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - root).pow(2))
        logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
        return outputs, -logabsdet
    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = input_heights * (input_delta * theta.pow(2)
                                 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + slope * theta_one_minus_theta
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta.pow(2) * (
        input_derivatives_plus_one * theta.pow(2) + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta).pow(2))
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def spline(inputs, uw, uh, ud, inverse, tail_bound):
    """unconstrained_rational_quadratic_spline with tails='linear'."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    outputs = torch.zeros_like(inputs)
    logabsdet = torch.zeros_like(inputs)
    ud = F.pad(ud, pad=(1, 1))
    constant = np.log(np.exp(1 - MIN_DERIVATIVE) - 1)
    ud[..., 0] = constant
    ud[..., -1] = constant
    outputs[~inside] = inputs[~inside]
    outputs[inside], logabsdet[inside] = rational_quadratic_spline(
        inputs[inside], uw[inside, :], uh[inside, :], ud[inside, :], inverse,
        -tail_bound, tail_bound, -tail_bound, tail_bound)
    return outputs, logabsdet


# ---- modules.py -------------------------------------------------------------------


def dds_conv(P, name, x, x_mask, c, q, g=None):
    k = c["dp_kernel_size"]
    if g is not None:
        x = x + g
    for i in range(3):
        d = k ** i
        y = conv(P, f"{name}.convs_sep.{i}", x * x_mask, q, groups=x.shape[1], dilation=d,
                 padding=(k * d - d) // 2)
        y = F.gelu(layer_norm(P, f"{name}.norms_1.{i}", y))
        y = conv(P, f"{name}.convs_1x1.{i}", y, q)
        y = F.gelu(layer_norm(P, f"{name}.norms_2.{i}", y))
        x = x + y
    return x * x_mask


def conv_flow_reverse(P, name, x, x_mask, g, c, q):
    bins, filters = c["spline_bins"], c["dp_filter_channels"]
    x0, x1 = torch.split(x, [1, 1], 1)
    h = conv(P, name + ".pre", x0, q)
    h = dds_conv(P, name + ".convs", h, x_mask, c, q, g=g)
    h = conv(P, name + ".proj", h, q) * x_mask
    b, ch, t = x0.shape
    h = h.reshape(b, ch, -1, t).permute(0, 1, 3, 2)
    uw = h[..., :bins] / math.sqrt(filters)
    uh = h[..., bins:2 * bins] / math.sqrt(filters)
    ud = h[..., 2 * bins:]
    x1, _ = spline(x1, uw, uh, ud, True, c["spline_tail_bound"])
    return torch.cat([x0, x1], 1) * x_mask


def duration_reverse(P, c, x, x_mask, z, q):
    """The predictor's reverse pass on noise `z` [B, 2, T] -> logw."""
    x = conv(P, "dp.pre", x, q)
    x = dds_conv(P, "dp.convs", x, x_mask, c, q)
    x = conv(P, "dp.proj", x, q) * x_mask
    z = z * c["noise_scale_w"]
    # self.flows = [ElementwiseAffine, (ConvFlow, Flip) x dp_flows]; reversed,
    # without the ConvFlow that comes last ("remove a useless vflow")
    flows = [("affine", 0)] + [f for i in range(c["dp_flows"])
                               for f in (("conv", 1 + 2 * i), ("flip", 2 + 2 * i))]
    flows = list(reversed(flows))
    flows = flows[:-2] + [flows[-1]]
    for kind, i in flows:
        if kind == "flip":
            z = torch.flip(z, [1])
        elif kind == "conv":
            z = conv_flow_reverse(P, f"dp.flows.{i}", z, x_mask, x, c, q)
        else:
            z = (z - P[f"dp.flows.{i}.m"]) * torch.exp(-P[f"dp.flows.{i}.logs"]) * x_mask
    return z[:, :1]


def wn(P, name, x, x_mask, c, q):
    hidden, n = c["hidden_channels"], c["flow_layers"]
    k, rate = c["flow_kernel_size"], c["flow_dilation_rate"]
    output = torch.zeros_like(x)
    for i in range(n):
        d = rate ** i
        x_in = conv(P, f"{name}.in_layers.{i}", x, q, dilation=d, padding=(k * d - d) // 2)
        acts = torch.tanh(x_in[:, :hidden]) * torch.sigmoid(x_in[:, hidden:])
        res_skip = conv(P, f"{name}.res_skip_layers.{i}", acts, q)
        if i < n - 1:
            x = (x + res_skip[:, :hidden]) * x_mask
            output = output + res_skip[:, hidden:]
        else:
            output = output + res_skip
    return output * x_mask


def flow_reverse(P, c, x, x_mask, q):
    half = c["inter_channels"] // 2
    for i in reversed(range(c["flow_couplings"])):
        x = torch.flip(x, [1])
        name = f"flow.flows.{2 * i}"
        x0, x1 = torch.split(x, [half, half], 1)
        h = conv(P, name + ".pre", x0, q) * x_mask
        h = wn(P, name + ".enc", h, x_mask, c, q)
        m = conv(P, name + ".post", h, q) * x_mask
        x = torch.cat([x0, (x1 - m) * x_mask], 1)
    return x


def generate_path(duration, mask):
    """duration [b, 1, t_x], mask [b, 1, t_y, t_x] -> path [b, 1, t_y, t_x]"""
    b, _, t_y, t_x = mask.shape
    cum_duration = torch.cumsum(duration, -1)
    path = sequence_mask(cum_duration.view(b * t_x), t_y).to(mask.dtype)
    path = path.view(b, t_x, t_y)
    path = path - F.pad(path, [0, 0, 1, 0, 0, 0])[:, :-1]
    return path.unsqueeze(1).transpose(2, 3) * mask


# ---- the generator ----------------------------------------------------------------


def generator(P, x, c, q):
    x = conv(P, "dec.conv_pre", x, q, padding=3)
    nk = len(c["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(q(x), q(P[f"dec.ups.{i}.weight"]), P[f"dec.ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        xs = None
        for j, (rk, dils) in enumerate(zip(c["resblock_kernel_sizes"],
                                           c["resblock_dilation_sizes"])):
            rb = f"dec.resblocks.{i * nk + j}"
            y = x
            for n, d in enumerate(dils):
                xt = F.leaky_relu(y, LRELU_SLOPE)
                xt = conv(P, f"{rb}.convs1.{n}", xt, q, dilation=d, padding=(rk * d - d) // 2)
                xt = F.leaky_relu(xt, LRELU_SLOPE)
                xt = conv(P, f"{rb}.convs2.{n}", xt, q, padding=(rk - 1) // 2)
                y = xt + y
            xs = y if xs is None else xs + y
        x = xs / nk
    x = F.leaky_relu(x)  # torch's default slope, 0.01
    x = conv(P, "dec.conv_post", x, q, padding=3)
    return torch.tanh(x)


# ---- the system's sizes and noise ---------------------------------------------------


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {max(buckets)}")


def row_seed(noise_seed: int, tokens: Sequence[int]) -> int:
    """sha256 of the noise seed (16 bytes, little-endian, signed) and the
    row's valid tokens (4 bytes each, little-endian); its first 8 bytes,
    little-endian, as a non-negative int64."""
    h = hashlib.sha256(int(noise_seed).to_bytes(16, "little", signed=True))
    h.update(b"".join(int(t).to_bytes(4, "little") for t in tokens))
    return int.from_bytes(h.digest()[:8], "little") & (2 ** 63 - 1)


def noise(seed: int, c, tokens: int, frames: int, device):
    """A row's (z [2, tokens], eps [inter_channels, frames])."""
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(2 * max(c["phoneme_buckets"]) + 1, 2, generator=g, device=device)
    eps = torch.randn(max(c["frame_buckets"]), c["inter_channels"], generator=g, device=device)
    return z[:tokens].T, eps[:frames].T


def infer(P, c, tokens, lengths, seeds, frames: int, q: Round = identity):
    """tokens [B, T] (interspersed, padded), lengths [B] -> (wav [B, 1,
    frames x hop], totals [B], logw [B, T]) over `frames` frames."""
    b, t = tokens.shape
    x_mask = sequence_mask(lengths, t).unsqueeze(1).float()
    x, m_p, logs_p = text_encoder(P, c, tokens, x_mask, q)
    z, eps = zip(*(noise(s, c, t, frames, tokens.device) for s in seeds))
    z, eps = torch.stack(z), torch.stack(eps)
    logw = duration_reverse(P, c, x, x_mask, z, q)
    w = torch.exp(logw) * x_mask * c["length_scale"]
    w_ceil = torch.ceil(w)
    y_lengths = torch.clamp_min(torch.sum(w_ceil, [1, 2]), 1).long()
    y_mask = sequence_mask(y_lengths, frames).unsqueeze(1).float()
    attn = generate_path(w_ceil, x_mask.unsqueeze(2) * y_mask.unsqueeze(-1))
    m_p = matmul(attn.squeeze(1), m_p.transpose(1, 2), q).transpose(1, 2)
    logs_p = matmul(attn.squeeze(1), logs_p.transpose(1, 2), q).transpose(1, 2)
    z_p = m_p + eps * torch.exp(logs_p) * c["noise_scale"]
    z = flow_reverse(P, c, z_p, y_mask, q)
    return generator(P, z * y_mask, c, q), y_lengths, logw[:, 0]


def initial_frames(tph: int, c) -> int:
    buckets = c["frame_buckets"]
    return pick_bucket(min(tph * 12, max(buckets)), buckets)


@torch.no_grad()
def synthesize_batch(P, c, rows: Sequence[Sequence[int]], q: Round, device,
                     noise_seed: int) -> List[np.ndarray]:
    """One call of the front end's phoneme id rows: each row's wav, trimmed
    to its frames.  The phoneme bucket fits the longest row; tokens are the
    rows interspersed with blank 0, padded to 2 x the bucket + 1; the frame
    bucket starts at 12 frames a phoneme of the bucket and is re-run once at
    the bucket that fits the longest row when that is larger."""
    tph = pick_bucket(max(len(r) for r in rows), c["phoneme_buckets"])
    tokens = torch.zeros(len(rows), 2 * tph + 1, dtype=torch.long)
    for i, r in enumerate(rows):
        tokens[i, 1:2 * len(r):2] = torch.tensor(r, dtype=torch.long)
    lengths = torch.tensor([2 * len(r) + 1 for r in rows])
    seeds = [row_seed(noise_seed, tokens[i, :lengths[i]].tolist()) for i in range(len(rows))]
    tokens, lengths = tokens.to(device), lengths.to(device)
    frames = initial_frames(tph, c)
    with ieee_f32():
        wav, totals, _ = infer(P, c, tokens, lengths, seeds, frames, q)
        need = int(totals.max())
        if need > frames and frames < max(c["frame_buckets"]):
            frames = pick_bucket(min(need, max(c["frame_buckets"])), c["frame_buckets"])
            wav, totals, _ = infer(P, c, tokens, lengths, seeds, frames, q)
    hop = c["hop_length"]
    return [wav[i, 0, :min(int(totals[i]), frames) * hop].cpu().numpy()
            for i in range(len(rows))]
