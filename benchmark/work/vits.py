"""The analytic FLOPs of VITS inference over the valid work of one text
(`mfu.vits`): the text encoder and the stochastic duration predictor over
its tokens (the front end's phonemes interspersed with blanks, 2n + 1),
the coupling flow and the generator (from the flow's channels) over its
frames.  FLOPs are 2 x multiply-adds of the matrix products and
convolutions; the splines, norms and activations are not counted."""

from __future__ import annotations

from .flops import generator_flops


def encoder_macs(c: dict, tokens: int) -> int:
    """Per token of a text of `tokens` tokens: each layer's q, k, v, o, the
    FFN's two k-convs, attention over the text's tokens and the 2w + 1
    relative offsets (keys and values), then the projection to m_p, logs_p."""
    h, f, k = c["hidden_channels"], c["filter_channels"], c["kernel_size"]
    rel = 2 * c["window_size"] + 1
    layer = 4 * h * h + 2 * k * h * f + 2 * tokens * h + 2 * rel * h
    return c["n_layers"] * layer + h * 2 * c["inter_channels"]


def dds_macs(channels: int, kernel: int) -> int:
    """A DDSConv of three layers: a depthwise k-conv and a 1x1 each."""
    return 3 * (channels * kernel + channels * channels)


def duration_macs(c: dict) -> int:
    """Per token: pre, DDSConv and proj of the encoding, then the ConvFlows
    the reverse pass runs (all but the first), each pre, DDSConv and the
    projection to the spline's 3 x bins - 1 parameters."""
    f, k = c["dp_filter_channels"], c["dp_kernel_size"]
    cond = c["hidden_channels"] * f + dds_macs(f, k) + f * f
    flow = f + dds_macs(f, k) + f * (3 * c["spline_bins"] - 1)
    return cond + (c["dp_flows"] - 1) * flow


def flow_macs(c: dict) -> int:
    """Per frame: each coupling's pre (half -> hidden), its WaveNet (a
    k-conv to twice the channels and a 1x1 to residual and skip per layer,
    the last to skip alone) and post (hidden -> half)."""
    h, half, n = c["hidden_channels"], c["inter_channels"] // 2, c["flow_layers"]
    wn = n * h * 2 * h * c["flow_kernel_size"] + (n - 1) * h * 2 * h + h * h
    return c["flow_couplings"] * (half * h + wn + h * half)


def vits_flops(c: dict, phonemes: int, frames: int) -> int:
    """Forward FLOPs of one text of `phonemes` front-end phonemes decoded to
    `frames` frames."""
    tokens = 2 * phonemes + 1
    gen = generator_flops(dict(c, n_mels=c["inter_channels"]), 1, frames)[0]
    return 2 * (tokens * (encoder_macs(c, tokens) + duration_macs(c))
                + frames * flow_macs(c)) + gen
