"""Reference-checkpoint interop: load PyTorch state dicts in the naming of
the reference (terrense/TTS-sambert_hifiGAN) into the port's models.

The port's own copy of the JAX package's `interop.py` (numpy only, copied,
not imported): its converters map every tensor of a reference-format
`state_dict()` into the flax parameter tree of the JAX package's models,
with the exact layout transforms

  Conv1d          torch [C_out, C_in/g, K]     -> kernel [K, C_in/g, C_out]
  ConvTranspose1d torch [C_in, C_out, K]       -> kernel [K, C_in, C_out], tap-flipped
  Conv2d          torch [C_out, C_in, KH, KW]  -> kernel [KH, KW, C_in, C_out]
  Linear          torch [out, in]              -> kernel [in, out]
  weight_norm     torch weight_g [out,1,...] / weight_v -> {"g": [out], "v": conv layout}
  spectral_norm   weight_orig / weight_u / weight_v -> kernel + 'spectral' {u, v}
  MultiheadAttention packed in_proj (3d, d)    -> wq/wk/wv [d, d] + bq/bk/bv

and the port reads those trees with the converters it already has
(`weights.acoustic_state_dict_from_flax`, `vocoder_state_dicts_from_flax`,
`generator_state_dict_from_flax`), so no second name map exists: the
`*_state_dict_from_torch` functions at the end compose the two.
Conversion is exact (transposes, reshapes and tap flips).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np


Array = np.ndarray
StateDict = Mapping[str, Array]


def state_dict_to_numpy(state_dict) -> Dict[str, Array]:
    """Convert a torch state_dict (or any mapping of tensors) to numpy."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# primitive layout transforms
# ---------------------------------------------------------------------------


def _conv1d(sd: StateDict, name: str) -> Dict[str, Array]:
    return {
        "kernel": np.ascontiguousarray(sd[f"{name}.weight"].transpose(2, 1, 0)),
        "bias": sd[f"{name}.bias"],
    }


def _conv_transpose1d(sd: StateDict, name: str) -> Dict[str, Array]:
    # torch [C_in, C_out, K] -> effective-conv [K, C_in, C_out] with taps
    # flipped (ops/conv.py:16-18: w[t, i, o] = W[i, o, K-1-t]).
    w = sd[f"{name}.weight"].transpose(2, 0, 1)[::-1]
    return {"kernel": np.ascontiguousarray(w), "bias": sd[f"{name}.bias"]}


def _conv1d_wn(sd: StateDict, name: str) -> Dict[str, Array]:
    v = np.ascontiguousarray(sd[f"{name}.weight_v"].transpose(2, 1, 0))
    g = sd[f"{name}.weight_g"].reshape(-1)
    return {"kernel_wn": {"v": v, "g": g}, "bias": sd[f"{name}.bias"]}


def _conv2d_wn(sd: StateDict, name: str) -> Dict[str, Array]:
    v = np.ascontiguousarray(sd[f"{name}.weight_v"].transpose(2, 3, 1, 0))
    g = sd[f"{name}.weight_g"].reshape(-1)
    return {"kernel_wn": {"v": v, "g": g}, "bias": sd[f"{name}.bias"]}


def _conv1d_sn(sd: StateDict, name: str) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    """torch.nn.utils.spectral_norm conv -> (params, spectral-state) leaves:
    weight_orig becomes the raw kernel; the persistent power-iteration
    vectors weight_u/weight_v transplant into the 'spectral' collection
    (models/layers.py:SpectralNorm)."""
    w = np.ascontiguousarray(sd[f"{name}.weight_orig"].transpose(2, 1, 0))
    return (
        {"kernel": w, "bias": sd[f"{name}.bias"]},
        {"u": sd[f"{name}.weight_u"], "v": sd[f"{name}.weight_v"]},
    )


def _conv2d_sn(sd: StateDict, name: str) -> Tuple[Dict[str, Array], Dict[str, Array]]:
    w = np.ascontiguousarray(sd[f"{name}.weight_orig"].transpose(2, 3, 1, 0))
    return (
        {"kernel": w, "bias": sd[f"{name}.bias"]},
        {"u": sd[f"{name}.weight_u"], "v": sd[f"{name}.weight_v"]},
    )


def msd_spectral_params_from_torch(
    sd: StateDict, prefix: str = "", n_discs: int = 3
) -> Tuple[Dict, Dict]:
    """Reference MultiScaleDiscriminator(use_spectral_norm=True)
    (models/hifigan.py:307-321) -> (flax params, 'spectral' collection)."""
    params: Dict = {}
    spectral: Dict = {}
    for i in range(n_discs):
        dp: Dict = {}
        ds: Dict = {}
        for j in range(7):
            dp[f"conv_{j}"], ds[f"conv_{j}"] = _conv1d_sn(
                sd, f"{prefix}discriminators.{i}.convs.{j}"
            )
        dp["conv_post"], ds["conv_post"] = _conv1d_sn(
            sd, f"{prefix}discriminators.{i}.conv_post"
        )
        params[f"disc_{i}"] = dp
        spectral[f"disc_{i}"] = ds
    return params, spectral


def mpd_spectral_params_from_torch(
    sd: StateDict, prefix: str = "", periods: Sequence[int] = (2, 3, 5, 7, 11)
) -> Tuple[Dict, Dict]:
    """Reference MultiPeriodDiscriminator(use_spectral_norm=True)
    (models/hifigan.py:481-493) -> (flax params, 'spectral' collection)."""
    params: Dict = {}
    spectral: Dict = {}
    for i, period in enumerate(periods):
        dp: Dict = {}
        ds: Dict = {}
        for j in range(5):
            dp[f"conv_{j}"], ds[f"conv_{j}"] = _conv2d_sn(
                sd, f"{prefix}discriminators.{i}.convs.{j}"
            )
        dp["conv_post"], ds["conv_post"] = _conv2d_sn(
            sd, f"{prefix}discriminators.{i}.conv_post"
        )
        params[f"disc_p{period}"] = dp
        spectral[f"disc_p{period}"] = ds
    return params, spectral


def _linear(sd: StateDict, name: str) -> Dict[str, Array]:
    return {
        "kernel": np.ascontiguousarray(sd[f"{name}.weight"].T),
        "bias": sd[f"{name}.bias"],
    }


def _layer_norm(sd: StateDict, name: str) -> Dict[str, Array]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _mha(sd: StateDict, name: str) -> Dict[str, Array]:
    """Packed-QKV torch MultiheadAttention -> split wq/wk/wv
    (same mapping the transformer parity tests pin,
    tests/test_transformer.py:33-48)."""
    ipw = sd[f"{name}.in_proj_weight"]  # [3d, d]
    ipb = sd[f"{name}.in_proj_bias"]
    d = ipw.shape[1]
    return {
        "wq": np.ascontiguousarray(ipw[:d].T),
        "wk": np.ascontiguousarray(ipw[d : 2 * d].T),
        "wv": np.ascontiguousarray(ipw[2 * d :].T),
        "bq": ipb[:d],
        "bk": ipb[d : 2 * d],
        "bv": ipb[2 * d :],
        "wo": np.ascontiguousarray(sd[f"{name}.out_proj.weight"].T),
        "bo": sd[f"{name}.out_proj.bias"],
    }


def _encoder_layer(sd: StateDict, name: str) -> Dict[str, Array]:
    return {
        "self_attn": _mha(sd, f"{name}.self_attn"),
        "norm1": _layer_norm(sd, f"{name}.norm1"),
        "norm2": _layer_norm(sd, f"{name}.norm2"),
        "ffn": {
            "linear1": _linear(sd, f"{name}.linear1"),
            "linear2": _linear(sd, f"{name}.linear2"),
        },
    }


def _decoder_layer(sd: StateDict, name: str) -> Dict[str, Array]:
    return {
        "self_attn": _mha(sd, f"{name}.self_attn"),
        "cross_attn": _mha(sd, f"{name}.multihead_attn"),
        "norm1": _layer_norm(sd, f"{name}.norm1"),
        "norm2": _layer_norm(sd, f"{name}.norm2"),
        "norm3": _layer_norm(sd, f"{name}.norm3"),
        "ffn": {
            "linear1": _linear(sd, f"{name}.linear1"),
            "linear2": _linear(sd, f"{name}.linear2"),
        },
    }


def _variance_predictor(sd: StateDict, name: str, n_layers: int) -> Dict:
    out: Dict = {}
    for i in range(n_layers):
        out[f"conv_{i}"] = _conv1d(sd, f"{name}.conv_layers.{i}")
        out[f"norm_{i}"] = _layer_norm(sd, f"{name}.layer_norms.{i}")
    out["linear"] = _linear(sd, f"{name}.linear")
    return out


# ---------------------------------------------------------------------------
# model-level converters (reference state_dict naming)
# ---------------------------------------------------------------------------


def generator_params_from_torch(
    sd: StateDict,
    prefix: str = "",
    n_stages: int = 4,
    n_resblocks: int = 3,
    n_dilations: int = 3,
) -> Dict:
    """Reference HiFiGANGenerator (models/hifigan.py:134-283: conv_pre,
    ups.{i}, mrfs.{i}.resblocks.{j}.convs1/.convs2.{k}, conv_post) ->
    flax params for sambert_hifigan_tpu.models.hifigan.HiFiGANGenerator."""
    p = prefix
    out: Dict = {"conv_pre": _conv1d(sd, f"{p}conv_pre")}
    for i in range(n_stages):
        out[f"up_{i}"] = _conv_transpose1d(sd, f"{p}ups.{i}")
        mrf: Dict = {}
        for j in range(n_resblocks):
            rb: Dict = {}
            for k in range(n_dilations):
                rb[f"conv1_{k}"] = _conv1d(
                    sd, f"{p}mrfs.{i}.resblocks.{j}.convs1.{k}"
                )
                rb[f"conv2_{k}"] = _conv1d(
                    sd, f"{p}mrfs.{i}.resblocks.{j}.convs2.{k}"
                )
            mrf[f"resblock_{j}"] = rb
        out[f"mrf_{i}"] = mrf
    out["conv_post"] = _conv1d(sd, f"{p}conv_post")
    return out


def msd_params_from_torch(sd: StateDict, prefix: str = "", n_discs: int = 3) -> Dict:
    """Reference MultiScaleDiscriminator (models/hifigan.py:356-447) ->
    flax params (disc_{i}/conv_{j} + conv_post, all weight-normed)."""
    out: Dict = {}
    for i in range(n_discs):
        d: Dict = {}
        for j in range(7):
            d[f"conv_{j}"] = _conv1d_wn(sd, f"{prefix}discriminators.{i}.convs.{j}")
        d["conv_post"] = _conv1d_wn(sd, f"{prefix}discriminators.{i}.conv_post")
        out[f"disc_{i}"] = d
    return out


def mpd_params_from_torch(
    sd: StateDict, prefix: str = "", periods: Sequence[int] = (2, 3, 5, 7, 11)
) -> Dict:
    """Reference MultiPeriodDiscriminator (models/hifigan.py:545-615) ->
    flax params (disc_p{period}/conv_{j} + conv_post, Conv2d weight norm)."""
    out: Dict = {}
    for i, period in enumerate(periods):
        d: Dict = {}
        for j in range(5):
            d[f"conv_{j}"] = _conv2d_wn(sd, f"{prefix}discriminators.{i}.convs.{j}")
        d["conv_post"] = _conv2d_wn(sd, f"{prefix}discriminators.{i}.conv_post")
        out[f"disc_p{period}"] = d
    return out


def hifigan_params_from_torch(sd: StateDict) -> Dict:
    """Reference HiFiGAN facade (models/hifigan.py:618-800: generator.*,
    msd.*, mpd.*) -> flax params for the HiFiGAN facade module."""
    return {
        "generator": generator_params_from_torch(sd, "generator."),
        "msd": msd_params_from_torch(sd, "msd."),
        "mpd": mpd_params_from_torch(sd, "mpd."),
    }


def bert_encoder_params_from_torch(
    sd: StateDict, prefix: str = "", n_layers: int = 6
) -> Dict:
    """Reference BERTEncoder (models/bert_encoder.py:13-119:
    encoder.layers.{i}.* + encoder.norm) -> flax params."""
    out: Dict = {}
    for i in range(n_layers):
        out[f"layer_{i}"] = _encoder_layer(sd, f"{prefix}encoder.layers.{i}")
    out["final_norm"] = _layer_norm(sd, f"{prefix}encoder.norm")
    return out


def variance_adaptor_params_from_torch(
    sd: StateDict, prefix: str = "", n_layers: int = 2
) -> Dict:
    """Reference VarianceAdaptor (models/variance_adaptor.py:585-791) ->
    flax params.  Note: the reference nests the pitch/energy predictor convs
    one level deeper (pitch_predictor.predictor.*) than the duration
    predictor (duration_predictor.*)."""
    return {
        "duration_predictor": _variance_predictor(
            sd, f"{prefix}duration_predictor", n_layers
        ),
        "pitch_predictor": _variance_predictor(
            sd, f"{prefix}pitch_predictor.predictor", n_layers
        ),
        "energy_predictor": _variance_predictor(
            sd, f"{prefix}energy_predictor.predictor", n_layers
        ),
        "pitch_emb": sd[f"{prefix}pitch_predictor.pitch_emb.weight"],
        "energy_emb": sd[f"{prefix}energy_predictor.energy_emb.weight"],
    }


def ar_decoder_params_from_torch(
    sd: StateDict, prefix: str = "", n_layers: int = 6
) -> Dict:
    """Reference PNCAARDecoder (models/ar_decoder.py:14-277: prenet.0/.3,
    decoder.layers.{i}.*, mel_proj) -> flax params."""
    out: Dict = {
        "prenet1": _linear(sd, f"{prefix}prenet.0"),
        "prenet2": _linear(sd, f"{prefix}prenet.3"),
        "mel_proj": _linear(sd, f"{prefix}mel_proj"),
    }
    for i in range(n_layers):
        out[f"layer_{i}"] = _decoder_layer(sd, f"{prefix}decoder.layers.{i}")
    return out


def acoustic_params_from_torch(
    sd: StateDict, n_encoder_layers: int = 6, n_decoder_layers: int = 6
) -> Dict:
    """Reference SAMBERTAcousticModel (models/acoustic_model.py:24-313) ->
    flax params for sambert_hifigan_tpu SAMBERTAcousticModel."""
    return {
        "phoneme_embedding": {
            "ph_emb": sd["phoneme_embedding.ph_emb.weight"],
            "tone_emb": sd["phoneme_embedding.tone_emb.weight"],
            "boundary_emb": sd["phoneme_embedding.boundary_emb.weight"],
        },
        "bert_encoder": bert_encoder_params_from_torch(
            sd, "bert_encoder.", n_encoder_layers
        ),
        "variance_adaptor": variance_adaptor_params_from_torch(
            sd, "variance_adaptor."
        ),
        "ar_decoder": ar_decoder_params_from_torch(
            sd, "ar_decoder.", n_decoder_layers
        ),
    }


# ---------------------------------------------------------------------------
# reference state_dict -> the port's state_dicts (through the flax trees)
# ---------------------------------------------------------------------------


def acoustic_state_dict_from_torch(sd: StateDict, cfg) -> Dict:
    """Reference SAMBERTAcousticModel -> the port's SAMBERTAcousticModel
    state_dict (`cfg`: the port's TTSConfig, for the layer counts)."""
    from .weights import acoustic_state_dict_from_flax

    am = cfg.acoustic_model
    return acoustic_state_dict_from_flax(acoustic_params_from_torch(
        sd, n_encoder_layers=am.encoder.n_layers, n_decoder_layers=am.decoder.n_layers))


def _generator_sizes(gc) -> Dict[str, int]:
    """generator_params_from_torch's counts from a GeneratorConfig."""
    return dict(n_stages=len(gc.upsample_rates), n_resblocks=len(gc.resblock_kernel_sizes),
                n_dilations=len(gc.resblock_dilation_sizes[0]))


def generator_state_dict_from_torch(sd: StateDict, cfg, prefix: str = "") -> Dict:
    """Reference HiFiGANGenerator -> the port's HiFiGANGenerator state_dict."""
    from .weights import generator_state_dict_from_flax

    return generator_state_dict_from_flax(generator_params_from_torch(
        sd, prefix, **_generator_sizes(cfg.vocoder.generator)))


def hifigan_state_dict_from_torch(sd: StateDict, cfg) -> Dict:
    """Reference HiFiGAN facade (generator.*, msd.*, mpd.*) -> the port's
    HiFiGAN state_dict; weight- or spectral-normed critics as `cfg` says."""
    from .weights import vocoder_state_dicts_from_flax

    dc = cfg.vocoder.discriminator
    spectral: Dict = {}
    if dc.msd_use_spectral_norm:
        msd, spectral["msd"] = msd_spectral_params_from_torch(sd, "msd.", dc.msd_scales)
    else:
        msd = msd_params_from_torch(sd, "msd.", dc.msd_scales)
    if dc.mpd_use_spectral_norm:
        mpd, spectral["mpd"] = mpd_spectral_params_from_torch(sd, "mpd.", dc.mpd_periods)
    else:
        mpd = mpd_params_from_torch(sd, "mpd.", dc.mpd_periods)
    params = {"generator": generator_params_from_torch(
        sd, "generator.", **_generator_sizes(cfg.vocoder.generator)), "msd": msd, "mpd": mpd}
    return vocoder_state_dicts_from_flax(params, spectral or None)
