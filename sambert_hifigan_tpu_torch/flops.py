"""The card's peak rates and the acoustic train step's FLOP count, shared by
`bench_scaling` and `chip_smoke.py`.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 3.35 TB/s of HBM and 989 TFLOP/s in bf16 on the tensor
cores.  A card set below 700 W (`nvidia-smi --query-gpu=power.limit`) runs
slower under load; shares of these peaks are stated beside its limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def acoustic_step_flops(cfg, b: int, tph: int, t: int) -> float:
    """Matrix-product FLOPs of one acoustic train step (forward, and backward
    at twice the forward), from the shapes: the encoder over b x tph
    phonemes, the three predictors' convolutions, the decoder over b x t
    frames (dense causal and cross attention over all t frames, as
    computed).  One teacher-forced pass, no remat: a step with scheduled
    sampling or remat computes more."""
    am = cfg.acoustic_model
    d, enc, dec, va = am.d_model, am.encoder, am.decoder, am.variance_adaptor
    per_token = enc.n_layers * (4 * d * d + 2 * d * enc.d_ff + 2 * tph * d)
    per_token += 3 * va.predictor_layers * va.predictor_kernel_size * d * d + 3 * d
    per_frame = dec.n_layers * (4 * d * d + 4 * d * d + 2 * d * dec.d_ff + 4 * t * d)
    per_frame += am.n_mels * d + d * d + d * am.n_mels
    return 3 * 2 * (b * tph * per_token + b * t * per_frame)
