"""The system under test, `sambert_hifigan_tpu_torch`, where it is not one
model's: its config tree, the kernels' build, the batcher, the launch
counters and the vocoder trainer.  A model's own glue (its weights'
layouts, its pipeline) is in `harness/models/<model>.py`; only this module
and those import the program."""

from __future__ import annotations

import dataclasses

import torch


def tts_config(c: dict):
    """The program's TTSConfig for a configuration file's sizes."""
    from sambert_hifigan_tpu_torch import config as pc

    d = pc.TTSConfig()
    audio = dataclasses.replace(
        d.audio, sample_rate=c["sample_rate"], hop_length=c["hop_length"], n_mels=c["n_mels"],
        **{k: c[k] for k in ("n_fft", "win_length", "fmin", "fmax") if k in c})
    am = d.acoustic_model
    am = dataclasses.replace(
        am, d_model=c.get("d_model", am.d_model), n_mels=c["n_mels"],
        frontend=dataclasses.replace(am.frontend, **{k: c[k] for k in (
            "vocab_size", "tone_size", "boundary_size") if k in c}),
        encoder=dataclasses.replace(am.encoder, n_layers=c.get("encoder_layers", am.encoder.n_layers),
                                    n_heads=c.get("encoder_heads", am.encoder.n_heads),
                                    d_ff=c.get("encoder_ffn", am.encoder.d_ff)),
        variance_adaptor=dataclasses.replace(am.variance_adaptor, **{k: c[k] for k in (
            "predictor_layers", "predictor_kernel_size", "pitch_bins", "pitch_min", "pitch_max",
            "energy_bins", "energy_min", "energy_max") if k in c}),
        decoder=dataclasses.replace(am.decoder, n_layers=c.get("decoder_layers", am.decoder.n_layers),
                                    n_heads=c.get("decoder_heads", am.decoder.n_heads),
                                    d_ff=c.get("decoder_ffn", am.decoder.d_ff)))
    gen = dataclasses.replace(d.vocoder.generator, n_mels=c["n_mels"], **{
        k: (tuple(tuple(x) for x in c[k]) if k == "resblock_dilation_sizes" else tuple(c[k])
            if isinstance(c[k], list) else c[k])
        for k in ("upsample_rates", "upsample_kernel_sizes", "upsample_initial_channel",
                  "resblock_kernel_sizes", "resblock_dilation_sizes") if k in c})
    disc = dataclasses.replace(d.vocoder.discriminator, **{
        k: (tuple(c[k]) if isinstance(c[k], list) else c[k])
        for k in ("mpd_periods", "msd_scales", "channel_div") if k in c})
    vocoder = dataclasses.replace(d.vocoder, generator=gen, discriminator=disc,
                                  loss_mode=c.get("loss_mode", d.vocoder.loss_mode))
    runtime = dataclasses.replace(d.runtime, **{k: tuple(c[k]) for k in (
        "phoneme_buckets", "frame_buckets", "batch_buckets") if k in c})
    training = d.training
    if "learning_rate" in c:
        voc = dataclasses.replace(
            training.vocoder, batch_size=c["batch_size"], learning_rate=c["learning_rate"],
            learning_rate_discriminator=c["learning_rate"], beta1=c["betas"][0],
            beta2=c["betas"][1], weight_decay=c["weight_decay"],
            mixed_precision=c["dtype"] == "bfloat16", gradient_clip=None)
        training = dataclasses.replace(training, vocoder=voc)
    lw = c.get("loss_weights", {})
    weights = dataclasses.replace(d.loss_weights, **{
        k2: lw[k1] for k1, k2 in (("feature_matching", "feature_matching"),
                                  ("mel", "vocoder_mel"), ("stft", "stft")) if k1 in lw})
    return dataclasses.replace(d, audio=audio, acoustic_model=am, vocoder=vocoder,
                               runtime=runtime, training=training, loss_weights=weights)


def state_shapes(module):
    """A module's state_dict layout as [(name, shape)]."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def gan_shapes(cfg):
    from sambert_hifigan_tpu_torch.models.hifigan import HiFiGAN

    with torch.device("meta"):
        return state_shapes(HiFiGAN(cfg.vocoder))


def build_kernels() -> None:
    from sambert_hifigan_tpu_torch import kernels

    kernels.build_all()


def batcher(pipe, max_batch: int, max_wait_ms: float):
    from sambert_hifigan_tpu_torch.serving import DynamicBatcher

    return DynamicBatcher(pipe, max_batch=max_batch, max_wait_ms=max_wait_ms)


def vocoder_trainer(cfg, sd, device):
    """(train state over a model holding `sd`, the adv_mel_fm step,
    {id(parameter): name})."""
    from sambert_hifigan_tpu_torch.models.hifigan import HiFiGAN
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (
        make_vocoder_step, vocoder_state_from_model)

    with torch.device("meta"):
        model = HiFiGAN(cfg.vocoder)
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    state = vocoder_state_from_model(model, cfg)
    names = {id(p): n for n, p in model.named_parameters()}
    return state, make_vocoder_step(cfg, loss_mode=cfg.vocoder.loss_mode), names


def launches():
    """The kernel wrappers' launch counters (K1, K2)."""
    from sambert_hifigan_tpu_torch.ops import ar_decode, mrf

    return {"k1": ar_decode.launches, "k2": mrf.launches}
