"""Typed configuration for the PyTorch/CUDA SAM-BERT + HiFi-GAN port.

A copy of the JAX package's config tree (same fields, same defaults, same
validation) so that the port never imports the JAX package.  `yaml` is
imported only inside `load_config`.

The reference loads two untyped YAML files ad-hoc at every use site
(reference: data/audio_processing.py:16-28, models/losses.py:404-409).  Here the
whole system is driven by one frozen dataclass tree, loaded once and passed
down.  Field names and defaults mirror the reference's configs
(reference: configs/config.yaml, configs/model_config.yaml) so that behavior
is identical out of the box.

The single most important invariant (reference: README.md:175-190): the mel
extraction configuration must be *identical* across dataset preprocessing, the
vocoder's mel-reconstruction loss, and inference.  `validate_mel_consistency`
enforces this at startup (the reference specs this as task 26 but never
implemented it).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Mel-spectrogram extraction parameters (reference: configs/config.yaml:3-14)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_scale: str = "slaney"  # or "htk"
    norm: Optional[str] = "slaney"  # or None
    log_base: Any = 10.0  # 10.0 | "e" | float custom base


@dataclass(frozen=True)
class FrontendConfig:
    """Pseudo-G2P vocabulary sizes (reference: configs/model_config.yaml:4-7)."""

    vocab_size: int = 300
    tone_size: int = 10
    boundary_size: int = 5


@dataclass(frozen=True)
class EncoderConfig:
    """BERT encoder (reference: configs/model_config.yaml:15-19)."""

    n_layers: int = 6
    n_heads: int = 4
    d_ff: int = 1024
    dropout: float = 0.1
    # rematerialize each layer on the backward pass (jax.checkpoint): trades
    # recompute FLOPs for activation memory when training long frame buckets
    remat: bool = False


@dataclass(frozen=True)
class VarianceAdaptorConfig:
    """Duration/pitch/energy predictors (reference: configs/model_config.yaml:22-37)."""

    predictor_layers: int = 2
    predictor_kernel_size: int = 3
    predictor_dropout: float = 0.1
    pitch_bins: int = 256
    pitch_min: float = 80.0
    pitch_max: float = 600.0
    energy_bins: int = 256
    energy_min: float = 0.0
    energy_max: float = 1.0


@dataclass(frozen=True)
class DecoderConfig:
    """PNCA AR decoder (reference: configs/model_config.yaml:40-45)."""

    n_layers: int = 6
    n_heads: int = 8
    d_ff: int = 2048
    dropout: float = 0.1
    chunk_size: int = 1  # scan unroll factor for streaming inference
    max_len: int = 5000  # positional-encoding capacity (reference: models/ar_decoder.py:69)
    remat: bool = False  # rematerialize decoder layers on backward


@dataclass(frozen=True)
class AcousticModelConfig:
    d_model: int = 256
    n_mels: int = 80
    dropout: float = 0.1
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    variance_adaptor: VarianceAdaptorConfig = field(default_factory=VarianceAdaptorConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass(frozen=True)
class GeneratorConfig:
    """HiFi-GAN generator (reference: configs/model_config.yaml:49-57)."""

    n_mels: int = 80
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    # the LeakyReLU before conv_post, and whether conv_post has a bias: VITS's
    # generator uses torch's default slope 0.01 there and no bias
    post_lrelu_slope: float = 0.1
    post_bias: bool = True


@dataclass(frozen=True)
class DiscriminatorConfig:
    """MSD/MPD (reference: configs/model_config.yaml:59-64)."""

    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    # True replaces weight norm with power-iteration spectral norm
    # (models/layers.py:SpectralNorm, parity-tested vs
    # torch.nn.utils.spectral_norm; reference: models/hifigan.py:307, 481).
    # The u/v iteration state rides in the train state's d_params["spectral"].
    msd_use_spectral_norm: bool = False
    mpd_use_spectral_norm: bool = False
    # Divide every internal channel width by this factor (1 = exact reference
    # sizes).  Tests use a large divisor so GAN train-step graphs compile in
    # seconds instead of minutes on CPU; group counts shrink with the channels.
    channel_div: int = 1
    # Channel-fold cap for the MSD's k=41 grouped convs (element-exact MXU
    # lane-filling transform, ops/conv.py:folded_conv1d; profiled: these convs
    # dominate the GAN train step).  0/1 disables.
    msd_fold_max: int = 8


@dataclass(frozen=True)
class VocoderConfig:
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    # "mel_only" | "adv_mel" | "adv_mel_fm" (reference: configs/model_config.yaml:66-71)
    loss_mode: str = "adv_mel_fm"


@dataclass(frozen=True)
class LossWeights:
    """Acoustic loss weights (reference: configs/config.yaml:36-40) and vocoder loss
    weights (reference: models/losses.py:369-376)."""

    mel: float = 1.0
    dur: float = 1.0
    pitch: float = 1.0
    energy: float = 1.0
    # vocoder
    feature_matching: float = 2.0
    vocoder_mel: float = 45.0
    stft: float = 1.0


@dataclass(frozen=True)
class TrainStageConfig:
    batch_size: int = 16
    learning_rate: float = 1e-4
    learning_rate_discriminator: Optional[float] = None
    max_epochs: int = 1000
    gradient_clip: Optional[float] = 1.0
    save_interval: int = 5000
    log_interval: int = 100
    # AdamW betas (reference: demo_ablation_modes.py:71-78 uses (0.8, 0.99) for GAN)
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.01
    # Learning-rate schedule (training/optim.py).  The reference's demos use
    # constant rates (demo_ablation_modes.py:71-78) — that stays the default;
    # "exponential" is the official HiFi-GAN recipe (lr *= gamma every
    # lr_decay_steps), "warmup_cosine" ramps over warmup_steps then decays to
    # lr * lr_end_ratio at lr_total_steps.
    lr_schedule: str = "constant"  # constant | exponential | warmup_cosine
    lr_decay_gamma: float = 0.999
    lr_decay_steps: int = 1000
    warmup_steps: int = 0
    lr_total_steps: int = 200_000
    lr_end_ratio: float = 0.05
    # Exponential moving average of the trained parameters (generator /
    # acoustic model), updated inside the jitted step and carried in the
    # train state; inference and eval prefer the EMA copy when present.
    # 0 = off (the reference has no parameter averaging).
    ema_decay: float = 0.0
    # Gradient accumulation: average k micro-batch gradients into ONE
    # optimizer update (optax.MultiSteps) — effective batch k x batch_size
    # at constant HBM.  1 = off.
    accumulate_steps: int = 1
    # Scheduled sampling ratio for the AR decoder (acoustic stage only; the
    # reference trains pure teacher forcing - its unimplemented trainer has no
    # such knob).  p > 0 mixes the model's OWN pass-1 predictions into the
    # decoder input with per-frame probability p (two-pass parallel scheduled
    # sampling), reducing exposure bias in free-running inference.  0 = off.
    scheduled_sampling: float = 0.0
    # GAN hygiene (vocoder stage only): update the discriminators every k-th
    # step (1 = every step, the reference demo's recipe).  On small corpora
    # the 70M-param MSD+MPD stack overpowers the generator (disc loss -> 0,
    # gradients vanish); k=2..4 keeps D informative.  D gradients are still
    # computed every step (one jitted program); only the update is gated.
    d_update_every: int = 1
    # bf16 mixed-precision training (the reference's own unchecked AMP task,
    # reference: .kiro/specs/tts-sam-bert-hifigan/tasks.md:426-429): model
    # compute (matmuls/convs/activations) in bfloat16 on the MXU, while
    # master parameters, gradients, optimizer state, and all loss reductions
    # stay float32.  bf16's f32-range exponent needs no loss scaling.
    mixed_precision: bool = True


@dataclass(frozen=True)
class TrainingConfig:
    acoustic: TrainStageConfig = field(
        default_factory=lambda: TrainStageConfig(
            batch_size=16, learning_rate=1e-4, max_epochs=1000, gradient_clip=1.0
        )
    )
    vocoder: TrainStageConfig = field(
        default_factory=lambda: TrainStageConfig(
            batch_size=16,
            learning_rate=2e-4,
            learning_rate_discriminator=2e-4,
            max_epochs=500,
            gradient_clip=None,
            beta1=0.8,
            beta2=0.99,
        )
    )


@dataclass(frozen=True)
class PathsConfig:
    data_dir: str = "data/train"
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    output_dir: str = "outputs"


@dataclass(frozen=True)
class RuntimeConfig:
    """TPU-specific runtime knobs (no reference equivalent; the reference is
    single-process eager PyTorch)."""

    # Static-shape buckets: phoneme-axis and frame-axis padded lengths used
    # under jit.  Dynamic Tfrm (reference: models/variance_adaptor.py:223-264)
    # becomes "pad to bucket + mask".
    phoneme_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    frame_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    # Batch-axis buckets for synthesize_batch: fused serving batches are
    # padded up to the next bucket so XLA compiles ONE program per bucket
    # instead of one per distinct batch size the micro-batcher happens to
    # fuse (B is a static shape under jit, like every other axis here).
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    # bf16 compute for matmuls/convs (reference has no AMP; tasks.md:426-429).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Device-mesh axis sizes; data-parallel by default.
    mesh_data: int = -1  # -1 = all devices
    mesh_model: int = 1
    debug_shapes: bool = False


@dataclass(frozen=True)
class TTSConfig:
    """Root config object."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    acoustic_model: AcousticModelConfig = field(default_factory=AcousticModelConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    loss_weights: LossWeights = field(default_factory=LossWeights)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


@dataclass(frozen=True)
class VitsModelConfig:
    """VITS's inference path (Kim, Kong and Son 2021; jaywalnut310/vits
    configs/ljs_base.json and models.py): the text encoder, the stochastic
    duration predictor, the coupling flow.  `n_vocab` defaults to the front
    end's vocabulary (its symbols stand in for ljs_base's 178)."""

    n_vocab: int = 300
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    window_size: int = 4
    dp_filter_channels: int = 192
    dp_kernel_size: int = 3
    dp_flows: int = 4
    spline_bins: int = 10
    spline_tail_bound: float = 5.0
    flow_couplings: int = 4
    flow_layers: int = 4
    flow_kernel_size: int = 5
    flow_dilation_rate: int = 1
    noise_scale: float = 0.667
    noise_scale_w: float = 0.8
    length_scale: float = 1.0


@dataclass(frozen=True)
class VitsConfig:
    """Root config of a VITS voice: its model, the HiFi-GAN V1 generator it
    decodes with (from the flow's channels, LeakyReLU 0.01 and no bias before
    the last conv), the audio rate and the pipeline's buckets."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    model: VitsModelConfig = field(default_factory=VitsModelConfig)
    generator: GeneratorConfig = field(default_factory=lambda: GeneratorConfig(
        n_mels=192, post_lrelu_slope=0.01, post_bias=False))
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


# ---------------------------------------------------------------------------
# YAML loading
# ---------------------------------------------------------------------------


def _build(dc_type, data: Dict[str, Any]):
    """Build a dataclass from a dict, recursing into nested dataclass fields and
    ignoring unknown keys (so reference-format YAML loads unchanged)."""
    if data is None:
        return dc_type()
    kwargs = {}
    for f in dataclasses.fields(dc_type):
        if f.name not in data:
            continue
        val = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _build(f.type, val)
        elif isinstance(val, list):
            kwargs[f.name] = tuple(tuple(v) if isinstance(v, list) else v for v in val)
        else:
            kwargs[f.name] = val
    return dc_type(**kwargs)


def load_config(
    config_path: Optional[str] = None, model_config_path: Optional[str] = None
) -> TTSConfig:
    """Load the root config.

    Accepts the reference's two-file YAML layout (configs/config.yaml +
    configs/model_config.yaml; reference: data/audio_processing.py:16-28) and
    maps it onto the typed tree.  With no arguments, returns defaults that are
    value-identical to the reference's YAML.
    """
    import yaml

    audio = AudioConfig()
    training = TrainingConfig()
    paths = PathsConfig()
    loss_w: Dict[str, Any] = {}

    if config_path is not None:
        with open(config_path, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}
        audio = _build(AudioConfig, raw.get("audio"))
        tr = raw.get("training") or {}
        training = TrainingConfig(
            acoustic=_build(TrainStageConfig, tr.get("acoustic")),
            vocoder=_build(TrainStageConfig, tr.get("vocoder")),
        )
        paths = _build(PathsConfig, raw.get("paths"))
        loss_w = raw.get("loss_weights") or {}
        # reference debug flag (configs/config.yaml:50-51) -> DEBUG_SHAPES
        if (raw.get("debug") or {}).get("print_shapes"):
            import os

            os.environ.setdefault("DEBUG_SHAPES", "1")

    acoustic = AcousticModelConfig()
    vocoder = VocoderConfig()
    if model_config_path is not None:
        with open(model_config_path, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}
        fe = _build(FrontendConfig, raw.get("frontend"))
        am = raw.get("acoustic_model") or {}
        va = am.get("variance_adaptor") or {}
        dp = va.get("duration_predictor") or {}
        pp = va.get("pitch_predictor") or {}
        ep = va.get("energy_predictor") or {}
        acoustic = AcousticModelConfig(
            d_model=am.get("d_model", 256),
            n_mels=audio.n_mels,
            dropout=(am.get("encoder") or {}).get("dropout", 0.1),
            frontend=fe,
            encoder=_build(EncoderConfig, am.get("encoder")),
            variance_adaptor=VarianceAdaptorConfig(
                predictor_layers=dp.get("n_layers", 2),
                predictor_kernel_size=dp.get("kernel_size", 3),
                predictor_dropout=dp.get("dropout", 0.1),
                pitch_bins=pp.get("n_bins", 256),
                pitch_min=pp.get("pitch_min", 80.0),
                pitch_max=pp.get("pitch_max", 600.0),
                energy_bins=ep.get("n_bins", 256),
            ),
            decoder=_build(DecoderConfig, am.get("decoder")),
        )
        voc = raw.get("vocoder") or {}
        gen = _build(GeneratorConfig, voc.get("generator"))
        gen = dataclasses.replace(gen, n_mels=audio.n_mels)
        disc = _build(DiscriminatorConfig, voc.get("discriminator"))
        vocoder = VocoderConfig(
            generator=gen,
            discriminator=disc,
            loss_mode=voc.get("loss_mode", "adv_mel_fm"),
        )

    weights = LossWeights(
        mel=loss_w.get("mel", 1.0),
        dur=loss_w.get("dur", 1.0),
        pitch=loss_w.get("pitch", 1.0),
        energy=loss_w.get("energy", 1.0),
    )

    cfg = TTSConfig(
        audio=audio,
        acoustic_model=acoustic,
        vocoder=vocoder,
        loss_weights=weights,
        training=training,
        paths=paths,
    )
    validate_config(cfg)
    return cfg


def default_config() -> TTSConfig:
    cfg = TTSConfig()
    validate_config(cfg)
    return cfg


# ---------------------------------------------------------------------------
# Validation (reference spec task 26: mel-config consistency validator,
# .kiro/specs/tts-sam-bert-hifigan/tasks.md:333-340 — never implemented there)
# ---------------------------------------------------------------------------


class ConfigError(ValueError):
    pass


def validate_config(cfg: TTSConfig) -> None:
    a = cfg.audio
    if a.n_fft < a.win_length:
        raise ConfigError(f"n_fft ({a.n_fft}) must be >= win_length ({a.win_length})")
    if a.hop_length <= 0:
        raise ConfigError("hop_length must be positive")
    if a.fmax > a.sample_rate / 2:
        raise ConfigError(
            f"fmax ({a.fmax}) exceeds Nyquist ({a.sample_rate / 2})"
        )
    g = cfg.vocoder.generator
    upsample_product = math.prod(g.upsample_rates)
    # T_wav = Tfrm * hop_length requires prod(upsample_rates) == hop_length
    # (asserted by reference tests/test_hifigan_generator.py:129-143).
    if upsample_product != a.hop_length:
        raise ConfigError(
            f"Product of upsample_rates {g.upsample_rates} = {upsample_product} "
            f"must equal hop_length {a.hop_length}"
        )
    if len(g.upsample_rates) != len(g.upsample_kernel_sizes):
        raise ConfigError("upsample_rates and upsample_kernel_sizes length mismatch")
    if len(g.resblock_kernel_sizes) != len(g.resblock_dilation_sizes):
        raise ConfigError("resblock kernel/dilation config length mismatch")
    if g.n_mels != a.n_mels:
        raise ConfigError(
            f"generator n_mels ({g.n_mels}) != audio n_mels ({a.n_mels}); "
            "mel config must be consistent across preprocessing, loss, and vocoder"
        )
    if cfg.acoustic_model.n_mels != a.n_mels:
        raise ConfigError("acoustic model n_mels inconsistent with audio config")
    if cfg.vocoder.loss_mode not in ("mel_only", "adv_mel", "adv_mel_fm"):
        raise ConfigError(f"Invalid loss_mode '{cfg.vocoder.loss_mode}'")
    if cfg.acoustic_model.d_model % cfg.acoustic_model.encoder.n_heads != 0:
        raise ConfigError("d_model must be divisible by encoder n_heads")
    if cfg.acoustic_model.d_model % cfg.acoustic_model.decoder.n_heads != 0:
        raise ConfigError("d_model must be divisible by decoder n_heads")
    for name, tr in (("acoustic", cfg.training.acoustic), ("vocoder", cfg.training.vocoder)):
        if tr.lr_schedule not in ("constant", "exponential", "warmup_cosine"):
            raise ConfigError(
                f"training.{name}.lr_schedule '{tr.lr_schedule}' invalid; "
                "expected constant | exponential | warmup_cosine"
            )
        if not 0.0 <= tr.ema_decay < 1.0:
            raise ConfigError(f"training.{name}.ema_decay must be in [0, 1)")
        if tr.accumulate_steps < 1:
            raise ConfigError(f"training.{name}.accumulate_steps must be >= 1")


def validate_vits_config(cfg: VitsConfig) -> None:
    m, g = cfg.model, cfg.generator
    if math.prod(g.upsample_rates) != cfg.audio.hop_length:
        raise ConfigError(f"Product of upsample_rates {g.upsample_rates} must equal hop_length "
                          f"{cfg.audio.hop_length}")
    if g.n_mels != m.inter_channels:
        raise ConfigError(f"the generator reads the flow's {m.inter_channels} channels, "
                          f"not {g.n_mels}")
    if m.hidden_channels % m.n_heads:
        raise ConfigError("hidden_channels must be divisible by n_heads")
    if m.kernel_size % 2 == 0 or m.flow_kernel_size % 2 == 0 or m.dp_kernel_size % 2 == 0:
        raise ConfigError("VITS's convolutions pad evenly: odd kernel sizes only")
    if m.inter_channels % 2:
        raise ConfigError("the coupling flow splits inter_channels in halves")


def mel_config_fingerprint(a: AudioConfig) -> Tuple:
    """A hashable fingerprint of every parameter that affects mel extraction.

    Checkpoints store this; resume/inference verifies it matches the live
    config, enforcing the reference's consistency invariant
    (reference: README.md:175-190, models/losses.py:725-730).
    """
    return (
        a.sample_rate,
        a.n_fft,
        a.hop_length,
        a.win_length,
        a.n_mels,
        float(a.fmin),
        float(a.fmax),
        a.mel_scale,
        a.norm,
        str(a.log_base),
    )


def validate_mel_consistency(*configs: AudioConfig) -> None:
    """Raise unless every AudioConfig has an identical mel fingerprint."""
    if not configs:
        return
    first = mel_config_fingerprint(configs[0])
    for other in configs[1:]:
        fp = mel_config_fingerprint(other)
        if fp != first:
            mismatched = [
                name
                for name, x, y in zip(
                    [
                        "sample_rate", "n_fft", "hop_length", "win_length", "n_mels",
                        "fmin", "fmax", "mel_scale", "norm", "log_base",
                    ],
                    first,
                    fp,
                )
                if x != y
            ]
            raise ConfigError(
                f"Mel configuration mismatch on fields {mismatched}: {first} vs {fp}. "
                "Dataset preprocessing, vocoder loss, and inference must share one "
                "mel configuration."
            )
