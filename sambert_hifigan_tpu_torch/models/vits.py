"""VITS inference (Kim, Kong and Son 2021, arXiv:2106.06103): the text
encoder, the stochastic duration predictor run in reverse and the coupling
flow run in reverse, as `SynthesizerTrn.infer` of jaywalnut310/vits
computes them; the decoder is the port's HiFi-GAN generator
(models/hifigan.py, its MRFs on K2), which the pipeline runs.

  tokens [B, T] (phoneme ids interspersed with blank 0) -> embedding x
  sqrt(hidden) -> n_layers post-norm layers [self-attention with windowed
  relative positions (keys and values, one table shared by the heads) ->
  LayerNorm; FFN of two k-convs with ReLU, masked -> LayerNorm] -> 1x1 proj
  -> the prior's m_p, logs_p
  duration: pre -> DDSConv -> proj of the encoding (g); noise z [B, 2, T] x
  noise_scale_w through Flip, (ConvFlow, Flip) x (dp_flows - 1) in reverse
  order (VITS drops the first ConvFlow in reverse), the ElementwiseAffine
  -> logw; w_ceil = ceil(exp(logw) x length_scale); each frame takes the
  token its cumulative durations put it in (VITS's `generate_path`)
  flow: z_p = m_p + eps x exp(logs_p) x noise_scale over the frames, then
  (Flip, coupling) x flow_couplings in reverse; a coupling (mean only)
  subtracts from one half the mean a WaveNet stack computes from the other

Parameter names are VITS's own under `enc_p.`, `dp.` and `flow.`
(`load_vits_state` splits a VITS state_dict, `dec.` included, into this
model's and the generator's, folding weight norm).

Precision: the text encoder and the flow's convolutions compute in the
pipeline's dtype (`VitsModel.cast_`: their convolutions, embeddings and
relative tables are held in it; LayerNorm and softmax in f32); the flow's
state and the WaveNet's residual stream stay f32 between them.  The
duration predictor, its spline, the durations and the path stay in f32: a
duration near a ceil edge would round apart in bf16.

Noise: each row draws its own from a generator seeded by `row_seed(noise
seed, the row's tokens)`, a fixed shape whatever the bucket (`draw_noise`),
so that a row's noise depends on neither its bucket nor its neighbours.

On the card the pass runs as CUDA graphs (`CapturedPass`, one per shape,
captured at its first call); elsewhere op by op (`vits_inference`).  Both
run the same three stages (`encode`, `durations`, `flow`).
Departures from jaywalnut310/vits: the per-row noise (VITS draws from the
global generator), the spline evaluated on every element and selected (no
boolean indexing, so no host sync; a negative discriminant from rounding
is clamped to 0 where VITS asserts), padded query rows attend the valid
keys (VITS fills their whole rows; neither reaches a valid position).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..config import GeneratorConfig, VitsModelConfig
from .acoustic_model import AcousticOutput

MASKED = -1e4  # VITS's fill for masked attention scores
MIN_BIN = 1e-3  # the spline's least bin width and height (transforms.py)
MIN_DERIVATIVE = 1e-3
TAIL_DERIVATIVE = math.log(math.exp(1 - MIN_DERIVATIVE) - 1)  # softplus^-1(1 - min)


class LayerNorm(nn.Module):
    """VITS's channels-first LayerNorm ([B, C, T], `gamma`, `beta`, eps
    1e-5), computed in f32, given back in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float().transpose(1, 2), self.gamma.shape, self.gamma, self.beta,
                         self.eps)
        return y.transpose(1, 2).to(x.dtype)


def _conv(m: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """`m` in its weights' dtype."""
    return m(x.to(m.weight.dtype))


def _skew(x: torch.Tensor, w: int) -> torch.Tensor:
    """[..., T, T + 2w] (contiguous) as [..., T, 2w + 1]: element (i, m) is
    column i + m of row i, a view."""
    *lead, t, n = x.shape
    size = (*lead, t, 2 * w + 1)
    stride = (*x.stride()[:-2], n + 1, 1)
    return x.as_strided(size, stride, x.storage_offset())


def relative_band(rel: torch.Tensor, w: int) -> torch.Tensor:
    """rel [..., T, 2w + 1] -> [..., T, T]: (i, j) is rel[i, j - i + w]
    where |j - i| <= w, else 0."""
    t = rel.shape[-2]
    z = rel.new_zeros(*rel.shape[:-1], t + 2 * w)
    _skew(z, w).copy_(rel)
    return z[..., w:w + t]


def relative_diagonals(p: torch.Tensor, w: int) -> torch.Tensor:
    """p [..., T, T] -> [..., T, 2w + 1]: (i, m) is p[i, i + m - w], 0 past
    the edges (the inverse of `relative_band` on the band)."""
    return _skew(F.pad(p, (w, w)), w)


class RelativeAttention(nn.Module):
    """attentions.MultiHeadAttention with `window_size` and heads sharing
    one table: scores q.k / sqrt(d) plus q.emb_rel_k[j - i + w] / sqrt(d) for
    |j - i| <= w; output p.v plus sum_j p[i, j] emb_rel_v[j - i + w]."""

    def __init__(self, channels: int, n_heads: int, window: int):
        super().__init__()
        self.n_heads, self.window = n_heads, window
        self.k_channels = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window + 1, self.k_channels))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window + 1, self.k_channels))

    def forward(self, x: torch.Tensor, key_pad: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]; key_pad [B, 1, 1, T] True where a key is padding."""
        b, c, t = x.shape

        def heads(y):
            return y.view(b, self.n_heads, self.k_channels, t).transpose(2, 3)

        q = heads(_conv(self.conv_q, x)) / math.sqrt(self.k_channels)
        k, v = heads(_conv(self.conv_k, x)), heads(_conv(self.conv_v, x))
        rel = torch.matmul(q, self.emb_rel_k.transpose(1, 2))  # [B, h, T, 2w + 1]
        scores = torch.matmul(q, k.transpose(2, 3)) + relative_band(rel, self.window)
        scores = scores.float().masked_fill(key_pad, MASKED)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(p, v) + torch.matmul(relative_diagonals(p, self.window),
                                                self.emb_rel_v)
        return _conv(self.conv_o, out.transpose(2, 3).reshape(b, c, t))


class FFN(nn.Module):
    """attentions.FFN: masked k-conv -> ReLU -> masked k-conv, masked."""

    def __init__(self, channels: int, filters: int, kernel_size: int):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv_1 = nn.Conv1d(channels, filters, kernel_size, padding=pad)
        self.conv_2 = nn.Conv1d(filters, channels, kernel_size, padding=pad)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = torch.relu(_conv(self.conv_1, x * mask))
        return _conv(self.conv_2, y * mask) * mask


class Encoder(nn.Module):
    """attentions.Encoder: post-norm layers of relative attention and FFN."""

    def __init__(self, m: VitsModelConfig):
        super().__init__()
        h = m.hidden_channels
        self.attn_layers = nn.ModuleList(RelativeAttention(h, m.n_heads, m.window_size)
                                         for _ in range(m.n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(h) for _ in range(m.n_layers))
        self.ffn_layers = nn.ModuleList(FFN(h, m.filter_channels, m.kernel_size)
                                        for _ in range(m.n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(h) for _ in range(m.n_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        key_pad = (mask == 0)[:, :, None, :]
        x = x * mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                     self.norm_layers_2):
            x = n1(x + attn(x, key_pad))
            x = n2(x + ffn(x, mask))
        return x * mask


class TextEncoder(nn.Module):
    """models.TextEncoder: tokens -> (hidden x, m_p, logs_p), [B, C, T]."""

    def __init__(self, m: VitsModelConfig):
        super().__init__()
        self.hidden, self.inter = m.hidden_channels, m.inter_channels
        self.emb = nn.Embedding(m.n_vocab, m.hidden_channels)
        self.encoder = Encoder(m)
        self.proj = nn.Conv1d(m.hidden_channels, 2 * m.inter_channels, 1)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor):
        x = (self.emb(tokens) * math.sqrt(self.hidden)).transpose(1, 2)
        x = self.encoder(x, mask.to(x.dtype))
        stats = _conv(self.proj, x) * mask
        return x, stats[:, :self.inter], stats[:, self.inter:]


class DDSConv(nn.Module):
    """modules.DDSConv: dilated depthwise-separable layers (dilation k^i),
    each sep conv -> LayerNorm -> GELU -> 1x1 -> LayerNorm -> GELU, added."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int = 3):
        super().__init__()
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        for i in range(n_layers):
            d = kernel_size ** i
            self.convs_sep.append(nn.Conv1d(channels, channels, kernel_size, groups=channels,
                                            dilation=d, padding=(kernel_size * d - d) // 2))
            self.convs_1x1.append(nn.Conv1d(channels, channels, 1))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, g=None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, n1, pw, n2 in zip(self.convs_sep, self.norms_1, self.convs_1x1, self.norms_2):
            y = F.gelu(n1(sep(x * mask)))
            x = x + F.gelu(n2(pw(y)))
        return x * mask


def rational_quadratic(x, uw, uh, ud, tail: float, inverse: bool):
    """transforms.unconstrained_rational_quadratic_spline with linear tails
    (Durkan et al. 2019): x [...]; uw, uh [..., K]; ud [..., K - 1] -> y,
    the identity outside [-tail, tail] (the log-determinant, which only
    training needs, is not formed).  Every element is evaluated (at x
    clamped into the interval) and the tails selected."""
    inside = (x >= -tail) & (x <= tail)
    xc = x.clamp(-tail, tail)
    k = uw.shape[-1]
    edge = torch.full_like(ud[..., :1], TAIL_DERIVATIVE)
    ud = torch.cat([edge, ud, edge], dim=-1)

    def knots(u):
        s = MIN_BIN + (1 - MIN_BIN * k) * torch.softmax(u, dim=-1)
        cum = F.pad(torch.cumsum(s, dim=-1), (1, 0))
        cum = 2 * tail * cum - tail
        cum = torch.cat([torch.full_like(cum[..., :1], -tail), cum[..., 1:-1],
                         torch.full_like(cum[..., :1], tail)], dim=-1)
        return cum, cum[..., 1:] - cum[..., :-1]

    cumw, widths = knots(uw)
    cumh, heights = knots(uh)
    deriv = MIN_DERIVATIVE + F.softplus(ud)
    locs = cumh if inverse else cumw
    locs = torch.cat([locs[..., :-1], locs[..., -1:] + 1e-6], dim=-1)
    idx = (xc[..., None] >= locs).sum(dim=-1, keepdim=True) - 1

    def at(t):
        return t.gather(-1, idx)[..., 0]

    x0, w0, y0, h0 = at(cumw), at(widths), at(cumh), at(heights)
    delta = at(heights / widths)
    d0, d1 = at(deriv), deriv[..., 1:].gather(-1, idx)[..., 0]
    if inverse:
        r = xc - y0
        a = r * (d0 + d1 - 2 * delta) + h0 * (delta - d0)
        b = h0 * d0 - r * (d0 + d1 - 2 * delta)
        c = -delta * r
        disc = (b.square() - 4 * a * c).clamp(min=0)
        y = (2 * c) / (-b - torch.sqrt(disc)) * w0 + x0
    else:
        theta = (xc - x0) / w0
        tt = theta * (1 - theta)
        denom = delta + (d0 + d1 - 2 * delta) * tt
        y = y0 + h0 * (delta * theta.square() + d0 * tt) / denom
    return torch.where(inside, y, x)


class ConvFlow(nn.Module):
    """modules.ConvFlow: a spline on the second channel whose bins a
    DDSConv of the first (conditioned on g) predicts."""

    def __init__(self, filters: int, kernel_size: int, bins: int, tail: float):
        super().__init__()
        self.filters, self.bins, self.tail = filters, bins, tail
        self.pre = nn.Conv1d(1, filters, 1)
        self.convs = DDSConv(filters, kernel_size, 3)
        self.proj = nn.Conv1d(filters, 3 * bins - 1, 1)

    def reverse(self, x, mask, g):
        x0, x1 = x[:, :1], x[:, 1:]
        h = _conv(self.proj, self.convs(_conv(self.pre, x0), mask, g)) * mask
        h = h[:, None].permute(0, 1, 3, 2)  # [B, 1, T, 3K - 1]
        scale = math.sqrt(self.filters)
        y1 = rational_quadratic(x1, h[..., :self.bins] / scale,
                                h[..., self.bins:2 * self.bins] / scale, h[..., 2 * self.bins:],
                                self.tail, inverse=True)
        return torch.cat([x0, y1], dim=1) * mask


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def reverse(self, x, mask, g=None):
        return (x - self.m) * torch.exp(-self.logs) * mask


class Flip(nn.Module):
    """The channels reversed; its own inverse."""

    def forward(self, x, *_):
        return torch.flip(x, [1])

    reverse = forward


class StochasticDurationPredictor(nn.Module):
    """models.StochasticDurationPredictor's reverse pass; the posterior
    flows (`post_*`) are training's alone and are not held."""

    def __init__(self, m: VitsModelConfig):
        super().__init__()
        f = m.dp_filter_channels
        self.pre = nn.Conv1d(m.hidden_channels, f, 1)
        self.convs = DDSConv(f, m.dp_kernel_size, 3)
        self.proj = nn.Conv1d(f, f, 1)
        self.flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(m.dp_flows):
            self.flows.append(ConvFlow(f, m.dp_kernel_size, m.spline_bins, m.spline_tail_bound))
            self.flows.append(Flip())

    def reverse(self, x, mask, z):
        """x [B, hidden, T] (f32), noise z [B, 2, T] already scaled -> logw
        [B, 1, T]."""
        g = _conv(self.proj, self.convs(_conv(self.pre, x), mask)) * mask
        flows = list(reversed(self.flows))
        for flow in flows[:-2] + [flows[-1]]:  # VITS drops the first ConvFlow
            z = flow.reverse(z, mask, g)
        return z[:, :1]


class WN(nn.Module):
    """modules.WN without conditioning: per layer a dilated k-conv to twice
    the channels, tanh x sigmoid, a 1x1 to residual and skip (the last
    layer's is all skip)."""

    def __init__(self, hidden: int, kernel_size: int, dilation_rate: int, n_layers: int):
        super().__init__()
        self.hidden = hidden
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(nn.Conv1d(hidden, 2 * hidden, kernel_size, dilation=d,
                                            padding=(kernel_size * d - d) // 2))
            out = 2 * hidden if i < n_layers - 1 else hidden
            self.res_skip_layers.append(nn.Conv1d(hidden, out, 1))

    def forward(self, x, mask):
        out = None
        n = len(self.in_layers)
        for i, (cin, rs) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            a = _conv(cin, x)
            acts = torch.tanh(a[:, :self.hidden]) * torch.sigmoid(a[:, self.hidden:])
            y = _conv(rs, acts)
            skip = y if i == n - 1 else y[:, self.hidden:]
            if i < n - 1:
                x = (x + y[:, :self.hidden]) * mask
            out = skip if out is None else out + skip
        return out * mask


class ResidualCouplingLayer(nn.Module):
    """modules.ResidualCouplingLayer with mean_only: x1 -= m(x0)."""

    def __init__(self, m: VitsModelConfig):
        super().__init__()
        self.half = m.inter_channels // 2
        self.pre = nn.Conv1d(self.half, m.hidden_channels, 1)
        self.enc = WN(m.hidden_channels, m.flow_kernel_size, m.flow_dilation_rate, m.flow_layers)
        self.post = nn.Conv1d(m.hidden_channels, self.half, 1)

    def mean(self, x0, mask):
        return _conv(self.post, self.enc(_conv(self.pre, x0) * mask, mask)) * mask

    def reverse(self, x, mask):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        return torch.cat([x0, (x1 - self.mean(x0, mask)) * mask], dim=1)

    def forward(self, x, mask):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        return torch.cat([x0, self.mean(x0, mask) + x1 * mask], dim=1)


class ResidualCouplingBlock(nn.Module):
    def __init__(self, m: VitsModelConfig):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(m.flow_couplings):
            self.flows.append(ResidualCouplingLayer(m))
            self.flows.append(Flip())

    def reverse(self, x, mask):
        for flow in reversed(self.flows):
            x = flow.reverse(x, mask)
        return x

    def forward(self, x, mask):
        for flow in self.flows:
            x = flow(x, mask)
        return x


class VitsModel(nn.Module):
    """SynthesizerTrn's inference path up to the decoder, under VITS's
    names: `enc_p`, `dp`, `flow`."""

    def __init__(self, config: VitsModelConfig = VitsModelConfig()):
        super().__init__()
        self.config = config
        self.enc_p = TextEncoder(config)
        self.dp = StochasticDurationPredictor(config)
        self.flow = ResidualCouplingBlock(config)

    @torch.no_grad()
    def cast_(self, dtype: torch.dtype) -> "VitsModel":
        """Hold the text encoder's and the flow's convolutions, embeddings and
        relative tables in `dtype` (LayerNorm and the duration predictor stay
        f32)."""
        for part in (self.enc_p, self.flow):
            for mod in part.modules():
                if isinstance(mod, (nn.Conv1d, nn.Embedding, RelativeAttention)):
                    for p in mod.parameters(recurse=False):
                        p.data = p.data.to(dtype)
        return self

    @torch.no_grad()
    def init_weights_(self, gen: torch.Generator) -> None:
        """VITS's initial families (torch's for the convs, N(0, hidden^-1/2)
        for the embedding, N(0, k_channels^-1/2) for the relative tables);
        the zero-initialised last convs of the flows and the affine get
        draws as well, so that a test exercises them."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv1d):
                fan_in = mod.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=gen)
                mod.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(mod, RelativeAttention):
                for t in (mod.emb_rel_k, mod.emb_rel_v):
                    t.normal_(0.0, mod.k_channels ** -0.5, generator=gen)
            elif isinstance(mod, ElementwiseAffine):
                mod.m.normal_(0.0, 0.1, generator=gen)
                mod.logs.normal_(0.0, 0.1, generator=gen)
        self.enc_p.emb.weight.normal_(0.0, self.config.hidden_channels ** -0.5, generator=gen)


# ---- the pass ---------------------------------------------------------------


def intersperse(ids: np.ndarray) -> np.ndarray:
    """[B, N] -> [B, 2N + 1]: blank 0 before, between and after the ids (a
    row padded with 0 stays blank past its end)."""
    out = np.zeros((ids.shape[0], 2 * ids.shape[1] + 1), ids.dtype)
    out[:, 1::2] = ids
    return out


def row_seed(noise_seed: int, tokens: Sequence[int]) -> int:
    """The seed of one row's noise: the first 8 bytes of the sha256 of the
    pipeline's noise seed (16 bytes, little-endian, signed) and the row's
    valid tokens (4 bytes each), as a non-negative int64."""
    h = hashlib.sha256(int(noise_seed).to_bytes(16, "little", signed=True))
    h.update(np.asarray(tokens, "<u4").tobytes())
    return int.from_bytes(h.digest()[:8], "little") & (2 ** 63 - 1)


def draw_noise(seeds: Sequence[int], z: torch.Tensor, eps: torch.Tensor) -> None:
    """Each row's noise into z [B, max_tokens, 2] and eps [B, max_frames,
    channels]: from a generator seeded by the row's seed, z[row] and then
    eps[row], N(0, 1).  The draw's shape is fixed, so a row's values do not
    depend on its bucket, which takes the first tokens and frames."""
    for i, s in enumerate(seeds):
        g = torch.Generator(device=z.device).manual_seed(int(s))
        torch.randn(z.shape[1:], generator=g, out=z[i])
        torch.randn(eps.shape[1:], generator=g, out=eps[i])


def expand_to_frames(w_ceil: torch.Tensor, frames: int):
    """w_ceil [B, T] (f32 whole numbers) -> (token of each frame [B, frames],
    frame mask [B, frames] bool, totals [B] int64): frame f belongs to the
    token whose cumulative span holds it (VITS's `generate_path`); totals
    are clamped to at least 1, as VITS's y_lengths are."""
    cum = torch.cumsum(w_ceil, dim=1)
    pos = torch.arange(frames, device=w_ceil.device, dtype=cum.dtype)
    idx = torch.searchsorted(cum, pos.expand(cum.shape[0], frames).contiguous(), right=True)
    totals = cum[:, -1].clamp(min=1).long()
    fmask = torch.arange(frames, device=w_ceil.device)[None, :] < totals[:, None]
    return idx.clamp(max=w_ceil.shape[1] - 1), fmask, totals


class VitsArgs(NamedTuple):
    tokens: torch.Tensor  # [B, T] int64, on the device
    lengths: torch.Tensor  # [B] int64 valid tokens, on the device
    seeds: List[int]  # each row's noise seed, on the host
    n_tokens: int  # valid tokens of the rows, on the host


# The pass in three stages, each a span (and on the card a CUDA graph): no
# stage reads anything back to the host.

def encode(model: VitsModel, tokens, lengths):
    """-> (token mask [B, 1, T] f32, hidden x, m_p, logs_p [B, C, T])."""
    t = tokens.shape[1]
    mask = (torch.arange(t, device=tokens.device)[None, :] < lengths[:, None])[:, None].float()
    return (mask, *model.enc_p(tokens, mask))


def durations(model: VitsModel, x, mask, z, frames: int, length_scale):
    """z [B, max_tokens, 2], length_scale a number or a 0-dim tensor ->
    (logw [B, T], each frame's token, frame mask, totals)."""
    z = z[:, :x.shape[2]].transpose(1, 2) * model.config.noise_scale_w
    logw = model.dp.reverse(x.float(), mask, z)
    w_ceil = torch.ceil(torch.exp(logw) * mask * length_scale)[:, 0]
    return (logw[:, 0], *expand_to_frames(w_ceil, frames))


def flow(model: VitsModel, m_p, logs_p, idx, fmask, eps):
    """eps [B, max_frames, C] -> the flow's output [B, frames, C] f32, zero
    past each total."""
    b, c = m_p.shape[:2]
    frames = idx.shape[1]
    gather = idx[:, None].expand(b, c, frames)
    ymask = fmask[:, None].float()
    mean = m_p.float().gather(2, gather) * ymask
    logs = logs_p.float().gather(2, gather) * ymask
    z_p = mean + eps[:, :frames].transpose(1, 2) * torch.exp(logs) * model.config.noise_scale
    return (model.flow.reverse(z_p, ymask) * ymask).transpose(1, 2)


def noise_buffers(rows: int, max_tokens: int, max_frames: int, channels: int, device):
    return (torch.zeros(rows, max_tokens, 2, device=device),
            torch.zeros(rows, max_frames, channels, device=device))


def vits_inference(model: VitsModel, args: VitsArgs, max_frames: int, max_tokens: int,
                   max_noise_frames: int, length_scale: float) -> AcousticOutput:
    """One pass, op by op: tokens -> the flow's output over `max_frames`
    frames as `mel_pred` [B, max_frames, inter_channels] f32 (zero past each
    row's total), the frame mask, each row's total frames (not clamped to
    the bucket) and `log_duration` [B, T]."""
    dev = args.tokens.device
    z, eps = noise_buffers(len(args.seeds), max_tokens, max_noise_frames,
                           model.config.inter_channels, dev)
    draw_noise(args.seeds, z, eps)
    with tracing.device_span("vits.encode", dev):
        mask, x, m_p, logs_p = encode(model, args.tokens, args.lengths)
    with tracing.device_span("vits.duration", dev):
        logw, idx, fmask, totals = durations(model, x, mask, z, max_frames, length_scale)
    with tracing.device_span("vits.flow", dev):
        mel = flow(model, m_p, logs_p, idx, fmask, eps)
    return AcousticOutput(mel, fmask, totals, {"log_duration": logw})


class CapturedPass:
    """`vits_inference` at one shape (rows, tokens, frames) on the card as
    three CUDA graphs, one a stage, sharing one memory pool: the pass is
    ~1,200 small kernels, which the host otherwise enqueues one by one while
    the card waits.  A call copies the tokens, lengths and length scale into
    the graphs' inputs, replays the three under their spans, drawing the
    noise into theirs after the first, and returns copies of the outputs
    (the next replay overwrites them).  Capture warms up on a side stream first, as
    torch.cuda.graphs asks."""

    def __init__(self, model: VitsModel, rows: int, tokens: int, frames: int,
                 max_tokens: int, max_noise_frames: int, device):
        self.tokens = torch.zeros(rows, tokens, dtype=torch.long, device=device)
        self.lengths = torch.ones(rows, dtype=torch.long, device=device)
        self.scale = torch.ones((), device=device)
        self.z, self.eps = noise_buffers(rows, max_tokens, max_noise_frames,
                                         model.config.inter_channels, device)
        scale = self.scale

        def stages():
            enc = encode(model, self.tokens, self.lengths)
            dur = durations(model, enc[1], enc[0], self.z, frames, scale)
            return enc, dur, flow(model, enc[2], enc[3], dur[1], dur[2], self.eps)

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            stages()
        torch.cuda.current_stream(device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        with torch.cuda.graph(self.graphs[0], pool=pool):
            self.enc = encode(model, self.tokens, self.lengths)
        with torch.cuda.graph(self.graphs[1], pool=pool):
            self.dur = durations(model, self.enc[1], self.enc[0], self.z, frames, scale)
        with torch.cuda.graph(self.graphs[2], pool=pool):
            self.mel = flow(model, self.enc[2], self.enc[3], self.dur[1], self.dur[2], self.eps)

    def __call__(self, args: VitsArgs, length_scale: float) -> AcousticOutput:
        dev = self.tokens.device
        self.tokens.copy_(args.tokens)
        self.lengths.copy_(args.lengths)
        self.scale.fill_(length_scale)
        encode_graph, duration_graph, flow_graph = self.graphs
        with tracing.device_span("vits.encode", dev):
            encode_graph.replay()
        draw_noise(args.seeds, self.z, self.eps)  # on the host while the card encodes
        with tracing.device_span("vits.duration", dev):
            duration_graph.replay()
        with tracing.device_span("vits.flow", dev):
            flow_graph.replay()
        logw, _, fmask, totals = self.dur
        return AcousticOutput(self.mel.clone(), fmask.clone(), totals.clone(),
                              {"log_duration": logw.clone()})


# ---- VITS's state_dict ----------------------------------------------------------

TRAINING_ONLY = ("enc_q.", "dp.post_")  # the posterior encoder and flows


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torch.nn.utils.weight_norm's (weight_g, weight_v) pairs (dim 0) as
    plain weights: g v / ||v||, the norm over every axis but the first."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            g = sd[k[:-2] + "_g"]
            norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[k[:-2]] = g.reshape(norm.shape) * v / norm
        else:
            out[k] = v
    return out


def _resblocks(cfg: GeneratorConfig) -> int:
    return len(cfg.resblock_kernel_sizes)


def generator_state_from_vits(sd, cfg: GeneratorConfig) -> Dict[str, torch.Tensor]:
    """`dec.*` of a VITS state_dict under the port's generator's names:
    dec.resblocks.{i * n + r} -> mrfs.{i}.resblocks.{r}."""
    n = _resblocks(cfg)
    out = {}
    for k, v in sd.items():
        if not k.startswith("dec."):
            continue
        k = k[4:]
        if k.startswith("resblocks."):
            j, rest = k[len("resblocks."):].split(".", 1)
            k = f"mrfs.{int(j) // n}.resblocks.{int(j) % n}.{rest}"
        out[k] = v
    return out


def vits_state_from_generator(gsd, cfg: GeneratorConfig) -> Dict[str, torch.Tensor]:
    """The inverse of `generator_state_from_vits`, under `dec.`."""
    n = _resblocks(cfg)
    out = {}
    for k, v in gsd.items():
        if k.startswith("mrfs."):
            i, _, r, rest = k[len("mrfs."):].split(".", 3)
            k = f"resblocks.{int(i) * n + int(r)}.{rest}"
        out["dec." + k] = v
    return out


def load_vits_state(sd, cfg: GeneratorConfig):
    """A VITS state_dict (VITS's names, weight norm folded or not; the
    training-only posterior parts dropped) -> (VitsModel's state_dict, the
    generator's)."""
    sd = fold_weight_norm({k: v for k, v in sd.items() if not k.startswith(TRAINING_ONLY)})
    acoustic = {k: v for k, v in sd.items() if not k.startswith("dec.")}
    return acoustic, generator_state_from_vits(sd, cfg)
