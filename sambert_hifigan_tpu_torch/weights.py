"""Weights carried from the JAX package's flax param trees into the port, and
the port's own seeded random init.

The converters take nested dicts of numpy arrays (`jax.device_get(params)`,
either the `{"params": ...}` wrapper or its content) and need no JAX:

  Linear          kernel [in, out]          -> weight [out, in]
  Conv1d          kernel [K, Cin, Cout]     -> weight [Cout, Cin, K]
  ConvTranspose1d effective-conv [K, Cin, Cout] -> weight [Cin, Cout, K],
                  taps flipped: W[i, o, s] = w[K-1-s, i, o]
  LayerNorm       scale, bias               -> weight, bias
  MHA             wq/wk/wv/wo [d, d] + bq/bk/bv/bo -> wq/wk/wv/wo Linear
  weight-normed   kernel_wn {g [Cout], v}   -> weight_g, weight_v (v reordered
  Conv1d/Conv2d                                as the plain kernel)
  Conv2d          kernel [KH, KW, Cin, Cout] -> weight [Cout, Cin, KH, KW]
  spectral norm   'spectral' u, v           -> buffers spectral_u, spectral_v
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import TTSConfig, VitsConfig
from .models.acoustic_model import SAMBERTAcousticModel
from .models.hifigan import HiFiGANGenerator
from .models.layers import init_defaults_
from .models.vits import VitsModel, vits_state_from_generator

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _unwrap(params):
    return params["params"] if "params" in params else params


def _linear(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv_transpose(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"])[::-1].transpose(1, 2, 0))
    sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _mha(sd: StateDict, name: str, p) -> None:
    for n in "qkvo":
        sd[f"{name}.w{n}.weight"] = _t(np.asarray(p[f"w{n}"]).T)
        sd[f"{name}.w{n}.bias"] = _t(p[f"b{n}"])


def _ffn(sd: StateDict, name: str, p) -> None:
    _linear(sd, f"{name}.linear1", p["linear1"])
    _linear(sd, f"{name}.linear2", p["linear2"])


def _layers(tree, prefix: str = "layer_"):
    n = 0
    while f"{prefix}{n}" in tree:
        yield n, tree[f"{prefix}{n}"]
        n += 1


def acoustic_state_dict_from_flax(params) -> StateDict:
    """SAMBERTAcousticModel flax params -> the port's state_dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    pe = p["phoneme_embedding"]
    for n in ("ph_emb", "tone_emb", "boundary_emb"):
        sd[f"phoneme_embedding.{n}.weight"] = _t(pe[n])
    enc = p["bert_encoder"]
    for i, lp in _layers(enc):
        pre = f"bert_encoder.layers.{i}"
        _mha(sd, f"{pre}.self_attn", lp["self_attn"])
        _norm(sd, f"{pre}.norm1", lp["norm1"])
        _ffn(sd, f"{pre}.ffn", lp["ffn"])
        _norm(sd, f"{pre}.norm2", lp["norm2"])
    _norm(sd, "bert_encoder.final_norm", enc["final_norm"])
    va = p["variance_adaptor"]
    for pred in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        pp = va[pred]
        for i, cp in _layers(pp, "conv_"):
            _conv(sd, f"variance_adaptor.{pred}.convs.{i}", cp)
            _norm(sd, f"variance_adaptor.{pred}.norms.{i}", pp[f"norm_{i}"])
        _linear(sd, f"variance_adaptor.{pred}.linear", pp["linear"])
    sd["variance_adaptor.pitch_emb.weight"] = _t(va["pitch_emb"])
    sd["variance_adaptor.energy_emb.weight"] = _t(va["energy_emb"])
    sd.update(decoder_state_dict_from_flax(p["ar_decoder"], "ar_decoder."))
    return sd


def decoder_state_dict_from_flax(params, prefix: str = "") -> StateDict:
    """PNCAARDecoder flax params -> state_dict of the port's PNCAARDecoder
    (keys under `prefix`)."""
    dec = _unwrap(params)
    sd: StateDict = {}
    for n in ("prenet1", "prenet2", "mel_proj"):
        _linear(sd, f"{prefix}{n}", dec[n])
    for i, lp in _layers(dec):
        pre = f"{prefix}layers.{i}"
        _mha(sd, f"{pre}.self_attn", lp["self_attn"])
        _mha(sd, f"{pre}.cross_attn", lp["cross_attn"])
        _ffn(sd, f"{pre}.ffn", lp["ffn"])
        for j in (1, 2, 3):
            _norm(sd, f"{pre}.norm{j}", lp[f"norm{j}"])
    return sd


def mrf_state_dict_from_flax(params, prefix: str = "") -> StateDict:
    """flax MRF params ({'resblock_i': {'conv{1,2}_j': ...}}) -> state_dict of
    models.hifigan.MRF (keys under `prefix`)."""
    p = _unwrap(params)
    sd: StateDict = {}
    for r, rp in _layers(p, "resblock_"):
        for j, _ in _layers(rp, "conv1_"):
            _conv(sd, f"{prefix}resblocks.{r}.convs1.{j}", rp[f"conv1_{j}"])
            _conv(sd, f"{prefix}resblocks.{r}.convs2.{j}", rp[f"conv2_{j}"])
    return sd


def conv_state_dict_from_flax(p, spectral=None) -> StateDict:
    """A discriminator conv (1-D or 2-D; weight norm, or spectral norm with
    its 'spectral' u, v) -> the state_dict of a NormConv1d / NormConv2d."""
    sd: StateDict = {}
    if "kernel_wn" in p:
        sd["weight_g"] = _t(p["kernel_wn"]["g"])
        sd["weight_v"] = _t(_conv_layout(np.asarray(p["kernel_wn"]["v"])))
    else:
        sd["weight"] = _t(_conv_layout(np.asarray(p["kernel"])))
        if spectral is not None:
            sd["spectral_u"] = _t(spectral["u"])
            sd["spectral_v"] = _t(spectral["v"])
    sd["bias"] = _t(p["bias"])
    return sd


def _conv_layout(k: np.ndarray) -> np.ndarray:
    """Channel-last kernel ([K, Cin, Cout] or [KH, KW, Cin, Cout]) -> torch's."""
    return k.transpose(2, 1, 0) if k.ndim == 3 else k.transpose(3, 2, 0, 1)


def _critic(sd: StateDict, name: str, p, spectral=None) -> None:
    convs = [(f"convs.{i}", f"conv_{i}") for i, _ in _layers(p, "conv_")]
    for ours, theirs in convs + [("conv_post", "conv_post")]:
        conv = conv_state_dict_from_flax(p[theirs], None if spectral is None else spectral[theirs])
        sd.update({f"{name}.{ours}.{k}": v for k, v in conv.items()})


def vocoder_state_dicts_from_flax(params, spectral=None) -> StateDict:
    """flax HiFiGAN params ({'generator', 'msd', 'mpd'}, with or without the
    'params' wrapper) and, for spectral-norm discriminators, the 'spectral'
    collection -> state_dict of the port's HiFiGAN (keys under generator.,
    msd., mpd.)."""
    p = _unwrap(params)
    spectral = {} if spectral is None else spectral.get("spectral", spectral)
    sd: StateDict = {f"generator.{k}": v
                     for k, v in generator_state_dict_from_flax(p["generator"]).items()}
    msd_s, mpd_s = spectral.get("msd"), spectral.get("mpd")
    for i, dp in _layers(p["msd"], "disc_"):
        _critic(sd, f"msd.discs.{i}", dp, None if msd_s is None else msd_s[f"disc_{i}"])
    # critics in ascending period, as the configs list them
    for i, period in enumerate(sorted(int(k[len("disc_p"):]) for k in p["mpd"])):
        name = f"disc_p{period}"
        _critic(sd, f"mpd.discs.{i}", p["mpd"][name], None if mpd_s is None else mpd_s[name])
    return sd


def aligner_state_dict_from_flax(params) -> StateDict:
    """CTCAlignerNet flax params -> the port's state_dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    for i, cp in _layers(p, "conv_"):
        _conv(sd, f"convs.{i}", cp)
        _norm(sd, f"norms.{i}", p[f"norm_{i}"])
    _linear(sd, "proj", p["proj"])
    return sd


def generator_state_dict_from_flax(params) -> StateDict:
    """HiFiGANGenerator flax params -> the port's state_dict."""
    p = _unwrap(params)
    sd: StateDict = {}
    _conv(sd, "conv_pre", p["conv_pre"])
    _conv(sd, "conv_post", p["conv_post"])
    for i, up in _layers(p, "up_"):
        _conv_transpose(sd, f"ups.{i}", up)
        sd.update(mrf_state_dict_from_flax(p[f"mrf_{i}"], f"mrfs.{i}."))
    return sd


@torch.no_grad()
def random_acoustic_model(cfg: TTSConfig, gen: torch.Generator) -> SAMBERTAcousticModel:
    """Acoustic model with seeded random weights: torch defaults, N(0, 1)
    embeddings, xavier for the decoder and the attention projections."""
    model = SAMBERTAcousticModel(cfg.acoustic_model)
    init_defaults_(model, gen)
    for layer in model.bert_encoder.layers:
        layer.self_attn.init_weights_(gen)
    model.ar_decoder.init_weights_(gen)
    return model


@torch.no_grad()
def random_generator(cfg: TTSConfig, gen: torch.Generator) -> HiFiGANGenerator:
    model = HiFiGANGenerator(cfg.vocoder.generator)
    init_defaults_(model, gen)
    return model


@torch.no_grad()
def random_vits_state(cfg: VitsConfig, gen: torch.Generator) -> StateDict:
    """A VITS state_dict under VITS's names (weight norm folded) with seeded
    random weights: VitsModel.init_weights_ and the generator's torch
    defaults."""
    model = VitsModel(cfg.model)
    model.init_weights_(gen)
    dec = HiFiGANGenerator(cfg.generator)
    init_defaults_(dec, gen)
    return {**model.state_dict(), **vits_state_from_generator(dec.state_dict(), cfg.generator)}
