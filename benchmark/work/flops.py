"""Peaks of the card and the analytic operation and byte counts that the
benchmark's roofline and utilisation metrics divide by.

A frozen copy of the system's count of a vocoder train step, kept here so
that a change to the program cannot change the yardstick, with the counts
of inference over the valid work: the phonemes and frames a request needs,
never the padding of its buckets.  FLOPs are 2 x multiply-adds of the
matrix products and convolutions.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# MSD ladder (cin, cout, kernel, stride, groups, pad), conv_post last
MSD_SPECS = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
             (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20),
             (1024, 1024, 41, 1, 16, 20), (1024, 1024, 5, 1, 1, 2), (1024, 1, 3, 1, 1, 1))
MPD_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024))


def conv_out(t: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (t + 2 * p - d * (k - 1) - 1) // s + 1


def generator_flops(c: dict, b: int, frames: int) -> Tuple[int, int]:
    """Forward FLOPs of the generator over b x `frames` mel frames, and of
    its first conv alone."""
    ch = c["upsample_initial_channel"]
    t = frames
    first = 2 * b * t * c["n_mels"] * ch * 7
    total = first
    for u, k in zip(c["upsample_rates"], c["upsample_kernel_sizes"]):
        total += 2 * b * t * ch * (ch // 2) * k
        ch, t = ch // 2, t * u
        for rk, dils in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
            total += 2 * len(dils) * 2 * b * t * ch * ch * rk
    return total + 2 * b * t * ch * 7, first


def discriminator_flops(c: dict, b: int, t: int) -> Tuple[int, int]:
    """Forward FLOPs of MSD + MPD on [b, 1, t], and of each critic's first
    conv."""
    total = first = 0
    n = t
    for i in range(c["msd_scales"]):
        if i:
            n = conv_out(n, 4, 2, 2)  # AvgPool1d(4, 2, 2)
        x = n
        for j, (cin, cout, k, s, g, p) in enumerate(MSD_SPECS):
            x = conv_out(x, k, s, p)
            f = 2 * b * x * cout * (cin // g) * k
            total += f
            first += f if j == 0 else 0
    for period in c["mpd_periods"]:
        h = -(-t // period)
        convs = [(ci, co, 5, 3, 2) for ci, co in MPD_CHANNELS] + [(1024, 1024, 5, 1, 2),
                                                                  (1024, 1, 3, 1, 1)]
        for j, (cin, cout, k, s, p) in enumerate(convs):
            h = conv_out(h, k, s, p)
            f = 2 * b * h * period * cout * cin * k
            total += f
            first += f if j == 0 else 0
    return total, first


def vocoder_step_flops(c: dict, b: int, seg: int) -> float:
    """FLOPs of one adv_mel_fm step at B = b over `seg`-frame segments:
    G forward; D on real and fake and its backward to D's weights; D on
    fake and real again for the G pass and its backward to the waveform;
    G's backward; the log-mel filterbank products (the STFTs' FFTs are not
    counted)."""
    t = seg * c["hop_length"]
    g, g_first = generator_flops(c, b, seg)
    d, d_first = discriminator_flops(c, b, t)
    frames = t // c["hop_length"] + 1
    mel = 2 * b * (c["n_fft"] // 2 + 1) * frames * c["n_mels"]
    return g + 2 * d + 2 * (2 * d - d_first) + 2 * d + d + 2 * g - g_first + 3 * mel


def acoustic_inference_flops(c: dict, phonemes: int, frames: int) -> int:
    """Forward FLOPs of one text of `phonemes` phonemes decoded to `frames`
    frames: the encoder (attention over its phonemes), the three
    predictors, the decoder's memory K/V, and per frame t the dense
    products, self-attention over t + 1 frames and cross-attention over the
    `frames` frames of the memory."""
    d, L, ff = c["d_model"], c["decoder_layers"], c["decoder_ffn"]
    n_mels = c["n_mels"]
    per_ph = c["encoder_layers"] * (4 * d * d + 2 * d * c["encoder_ffn"] + 2 * phonemes * d)
    per_ph += 3 * (c["predictor_layers"] * c["predictor_kernel_size"] * d * d + d)
    dense = L * (4 * d * d + 2 * d * d + 2 * d * ff) + n_mels * d + d * d + d * n_mels
    attn = L * 2 * d * (frames * (frames + 1) // 2 + frames * frames)
    memory = L * 2 * d * d * frames
    return 2 * (phonemes * per_ph + frames * dense + attn + memory)


def decode_matrix_params(c: dict) -> int:
    d, L, ff, n_mels = c["d_model"], c["decoder_layers"], c["decoder_ffn"], c["n_mels"]
    return n_mels * d + d * d + L * (6 * d * d + 2 * d * ff) + d * n_mels


def decode_vector_floats(c: dict) -> int:
    """Biases and LayerNorm of the packed decode (f32), positions aside."""
    d, L, ff, n_mels = c["d_model"], c["decoder_layers"], c["decoder_ffn"], c["n_mels"]
    return 2 * d + L * (6 * d + ff + d) + L * 6 * d + n_mels


def k1_work(c: dict, frames: Sequence[int], matrix_bytes: int = 2) -> Tuple[int, int]:
    """(bytes, FLOPs) one decode needs for rows of `frames` valid frames
    each: its weights (bf16 matrices, f32 vectors) and the positions of
    its longest row read once, each row's memory K/V (bf16) and mask bias
    of its own frames, its mel written (f32); per row and frame the dense
    products, self-attention over the frames so far and cross-attention
    over the row's memory."""
    d, L, n_mels = c["d_model"], c["decoder_layers"], c["n_mels"]
    params = decode_matrix_params(c)
    n = sum(frames)
    moved = (params * matrix_bytes + 4 * decode_vector_floats(c) + max(frames) * d * 4
             + 2 * L * n * d * 2 + n * 4 + n * n_mels * 4)
    flops = sum(2 * params * f + L * 4 * d * (f * (f + 1) // 2 + f * f) for f in frames)
    return moved, flops


def k2_work(c: dict, frames: Sequence[int]) -> List[Tuple[int, int]]:
    """[(bytes, FLOPs)] of each MRF stage of the generator over the valid
    samples of rows of `frames` frames: its input read and output written
    in f32, its packed bf16 weights and f32 biases read once."""
    stages = []
    ch, hop = c["upsample_initial_channel"], 1
    n = sum(frames)
    for u in c["upsample_rates"]:
        ch, hop = ch // 2, hop * u
        taps = sum(2 * len(dils) * k for k, dils in zip(c["resblock_kernel_sizes"],
                                                      c["resblock_dilation_sizes"]))
        convs = sum(2 * len(dils) for dils in c["resblock_dilation_sizes"])
        samples = n * hop
        stages.append((2 * 4 * ch * samples + 2 * taps * ch * ch + 4 * convs * ch,
                       2 * taps * ch * ch * samples))
    return stages


def least_seconds(moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
