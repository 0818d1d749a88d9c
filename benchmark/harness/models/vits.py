"""VITS (ljs_base) with the HiFi-GAN V1 generator: the model of a
configuration that says `"model": "vits"`.  One-shot calls only: it has no
stream (`reference_stream` raises).

The bundle is (VITS state_dict under VITS's names, the noise seed).  The
weights are drawn by `weights.make` with VITS's own families for its
embedding, relative tables, LayerNorms and affine; the duration
predictor's last affine is pinned (the configuration's
`frames_per_token` and `duration_pin_scale`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from reference import frontend
from reference import vits as ref

from ..weights import make, _family

TINY = dict(inter_channels=8, hidden_channels=16, filter_channels=32, n_layers=1,
            dp_filter_channels=16, flow_couplings=2, flow_layers=2,
            upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=16,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], hop_length=4,
            dtype="float32", frames_per_token=2.5, phoneme_buckets=[8, 16, 32],
            frame_buckets=[32, 64, 128, 256])

NOISE_SEED_OFFSET = 2  # the noise seed is the run's seed + 2 (weights take the seed)


def config(c: dict):
    """The program's VitsConfig for a configuration file's sizes."""
    from sambert_hifigan_tpu_torch import config as pc

    if not c["add_blank"]:
        raise ValueError("the port's VITS intersperses blanks: add_blank must be true")
    fields = [f.name for f in dataclasses.fields(pc.VitsModelConfig)]
    model = pc.VitsModelConfig(**{k: c[k] for k in fields if k in c})
    generator = pc.GeneratorConfig(
        n_mels=c["inter_channels"], upsample_rates=tuple(c["upsample_rates"]),
        upsample_kernel_sizes=tuple(c["upsample_kernel_sizes"]),
        upsample_initial_channel=c["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(c["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in c["resblock_dilation_sizes"]),
        post_lrelu_slope=c["post_lrelu_slope"], post_bias=c["post_bias"])
    audio = dataclasses.replace(pc.AudioConfig(), sample_rate=c["sample_rate"],
                                hop_length=c["hop_length"])
    runtime = dataclasses.replace(pc.RuntimeConfig(), **{k: tuple(c[k]) for k in (
        "phoneme_buckets", "frame_buckets", "batch_buckets") if k in c})
    return pc.VitsConfig(audio=audio, model=model, generator=generator, runtime=runtime)


def shapes(cfg):
    """The VITS state_dict's layout (the generator's under `dec.`) as
    [(name, shape)]."""
    from sambert_hifigan_tpu_torch.models.hifigan import HiFiGANGenerator
    from sambert_hifigan_tpu_torch.models.vits import VitsModel, vits_state_from_generator

    with torch.device("meta"):
        sd = VitsModel(cfg.model).state_dict()
        sd.update(vits_state_from_generator(HiFiGANGenerator(cfg.generator).state_dict(),
                                            cfg.generator))
    return [(k, tuple(v.shape)) for k, v in sd.items()]


def family(name: str, shape):
    """VITS's initial families where they are its own: the embedding N(0,
    hidden^-1/2) and the relative tables N(0, k_channels^-1/2) (both drawn
    N(0, 1) here and scaled by `weights`), LayerNorm gamma 1 and beta 0,
    the affine 0 (then pinned); the rest as weights._family gives it."""
    if name.endswith(("emb_rel_k", "emb_rel_v")):
        return "normal", 1.0
    if name.endswith(".gamma"):
        return "one", 0.0
    if name.endswith((".beta", ".m", ".logs")):
        return "zero", 0.0
    return _family(name, shape)


def pin_duration(sd, c: dict) -> None:
    """The duration predictor's last affine (`dp.flows.0`, applied last in
    reverse): logw = log(frames_per_token) + duration_pin_scale x z0."""
    s = c["duration_pin_scale"]
    sd["dp.flows.0.logs"].fill_(-math.log(s))
    sd["dp.flows.0.m"].fill_(-math.log(c["frames_per_token"]) / s)


def weights(c: dict, cfg, seed: int, device):
    sd = make(shapes(cfg), seed, device, family)
    sd["enc_p.emb.weight"].mul_(c["hidden_channels"] ** -0.5)
    kc = c["hidden_channels"] // c["n_heads"]
    for k in sd:
        if k.endswith(("emb_rel_k", "emb_rel_v")):
            sd[k].mul_(kc ** -0.5)
    pin_duration(sd, c)
    return sd, seed + NOISE_SEED_OFFSET


def pipeline(cfg, W, devices, dtype):
    from sambert_hifigan_tpu_torch.pipeline import VitsPipeline

    state, noise_seed = W
    return VitsPipeline(cfg, state, device=devices[0],
                        devices=devices if len(devices) > 1 else None, dtype=dtype,
                        noise_seed=noise_seed)


def reference_batch(W, c: dict, texts, q, device):
    rows = [frontend.text_ids(t, c["n_vocab"], 2)[0] for t in texts]
    return ref.synthesize_batch(W[0], c, rows, q, device, W[1])


def reference_stream(W, c: dict, texts, chunk: int, context: int, q, device):
    raise NotImplementedError("VITS has no stream in the program, so no live cell")
