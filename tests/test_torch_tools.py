"""The port's tooling against the JAX package's, float32 on the CPU, at small
sizes: shape debugging, the width-scaling config and the FLOP counts, the demo
corpus (byte for byte), the plot panels, the two demos, the encode split,
the decode modes, the profiler's five surfaces and the demo evaluation.

Bounds are stated per test: the DSP's are those of tests/test_torch_dsp.py
and tests/test_torch_features.py, the losses' those of
tests/test_torch_vocoder_losses.py, the evaluation's those of
tests/test_torch_eval_tools.py (whose corpus and checkpoints are reused).
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import dataclasses
import gzip
import importlib
import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.config import AudioConfig as JAudio
from sambert_hifigan_tpu.data import features as j_feat
from sambert_hifigan_tpu.losses.vocoder import vocoder_generator_loss as j_gen_loss
from sambert_hifigan_tpu.models import hifigan as j_hg
from sambert_hifigan_tpu.ops import mel as j_mel
from sambert_hifigan_tpu.ops import stft as j_stft
from sambert_hifigan_tpu.utils import debug as j_debug
from sambert_hifigan_tpu.utils import eval_metrics as je

from sambert_hifigan_tpu_torch import (bench_decode_modes, bench_encode_split, bench_scaling,
                                       demo_ablation_modes, demo_feature_matching_loss,
                                       eval_demo_run, make_demo_dataset, plot_audio, profiling)
from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch.config import AudioConfig
from sambert_hifigan_tpu_torch.data.audio import load_wav, save_wav
from sambert_hifigan_tpu_torch.data.dataset import batch_to_device, synthetic_batch
from sambert_hifigan_tpu_torch.flops import acoustic_step_flops
from sambert_hifigan_tpu_torch.training.acoustic_trainer import (init_acoustic_state,
                                                                 make_acoustic_step)
from sambert_hifigan_tpu_torch.utils import debug as p_debug
from sambert_hifigan_tpu_torch.weights import random_acoustic_model
from tests.test_torch_discriminators import (  # noqa: F401 (a fixture)
    jax_vocoder,
    one_torch_thread,
    port_vocoder,
    tiny_voc,
)
from tests.test_torch_eval_tools import (  # noqa: F401 (fixtures)
    _cfg,
    acoustic_ckpt,
    corpus,
    vocoder_ckpt,
)
from tests.test_torch_vocoder_train import Pair

REPO = Path(__file__).resolve().parent.parent
TOOLS = ["profiling", "utils.debug", "bench_decode_modes", "bench_encode_split",
         "bench_scaling", "plot_audio", "make_demo_dataset", "demo_ablation_modes",
         "demo_feature_matching_loss", "eval_demo_run", "dryrun"]


# ---- entry points -----------------------------------------------------------------


@pytest.mark.filterwarnings("ignore:.*found in sys.modules after import")
@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_with_help(name, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"sambert_hifigan_tpu_torch.{name}", run_name="__main__")
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_tools_import_nothing_of_jax():
    """Every tool module imported in a fresh process: no jax, flax or JAX
    package module comes with them, and none is named `profile`."""
    code = ("import sys\n"
            + "".join(f"import sambert_hifigan_tpu_torch.{n}\n" for n in TOOLS)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'flax', 'optax', 'sambert_hifigan_tpu')]\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not list((REPO / "sambert_hifigan_tpu_torch").rglob("profile.py"))


# ---- utils/debug ------------------------------------------------------------------

SHAPE_CASES = [
    ((2, 3), (2, 3)), ((2, 3), (None, 3)), ((2, 3), (2, None)), ((2, 3), (3, 3)),
    ((2, 3), (2, 4)), ((2, 3), (2, 3, 1)), ((4,), (None,)), ((1, 128, 256), (None, 128, 256)),
]


def _outcome(fn, *args):
    try:
        fn(*args)
        return None
    except AssertionError as e:
        return str(e)


@pytest.mark.parametrize("shape,expected", SHAPE_CASES)
def test_assert_shape_matches_jax(shape, expected):
    ours = _outcome(p_debug.assert_shape, torch.zeros(shape), expected, "h")
    theirs = _outcome(j_debug.assert_shape, jnp.zeros(shape), expected, "h")
    assert ours == theirs


@pytest.mark.parametrize("shape,rank", [((2, 3), 2), ((2, 3), 3), ((5,), 1), ((1, 2, 3), 2)])
def test_assert_rank_matches_jax(shape, rank):
    assert (_outcome(p_debug.assert_rank, torch.zeros(shape), rank, "x")
            == _outcome(j_debug.assert_rank, jnp.zeros(shape), rank, "x"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
def test_trace_shape_prints_the_jax_line_once_per_signature(dtype, monkeypatch, capsys):
    monkeypatch.setenv("DEBUG_SHAPES", "1")
    name = f"test_trace_{dtype}"
    a_p, b_p = torch.zeros((2, 3), dtype=getattr(torch, dtype)), torch.zeros(4)
    j_debug.trace_shape(name, jnp.zeros((2, 3), dtype=dtype), jnp.zeros(4))
    theirs = capsys.readouterr().out
    p_debug.trace_shape(name, a_p, b_p)
    p_debug.trace_shape(name, a_p, b_p)  # the same signature: no second line
    ours = capsys.readouterr().out
    assert ours == theirs == f"[trace-shape] {name}: (2, 3):{dtype}, (4,):float32\n"
    p_debug.trace_shape(name, torch.zeros((5, 3), dtype=getattr(torch, dtype)), b_p)
    assert capsys.readouterr().out.startswith(f"[trace-shape] {name}: (5, 3)")


def test_debug_levels(monkeypatch, capsys):
    monkeypatch.delenv("DEBUG_SHAPES", raising=False)
    p_debug.trace_shape("test_off", torch.zeros(1))
    p_debug.debug_value("v={}", torch.tensor(1.5))
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("DEBUG_SHAPES", "2")
    p_debug.debug_value("v={}", torch.tensor(1.5))
    j_debug.debug_value("v={}", jnp.asarray(1.5))
    jax.effects_barrier()
    assert capsys.readouterr().out == "v=1.5\nv=1.5\n"


# ---- bench_scaling and the FLOP count ---------------------------------------------


@pytest.mark.parametrize("d", [256, 512, 1024])
def test_scaled_cfg_matches_jax(d):
    """Every field the JAX config has is equal; the port's generator has two
    more (VITS's last LeakyReLU and conv_post bias), which must hold the
    JAX generator's fixed 0.1 and bias."""
    jax_script = importlib.import_module("scripts.bench_scaling")
    port = dataclasses.asdict(bench_scaling.scaled_cfg(d))
    gen = port["vocoder"]["generator"]
    assert (gen.pop("post_lrelu_slope"), gen.pop("post_bias")) == (0.1, True)
    assert port == dataclasses.asdict(jax_script.scaled_cfg(d))


def _small_acoustic_cfg(d=32):
    cfg = pcfg.TTSConfig()
    am = dataclasses.replace(cfg.acoustic_model, d_model=d,
                             encoder=pcfg.EncoderConfig(n_layers=2, n_heads=2, d_ff=2 * d),
                             decoder=pcfg.DecoderConfig(n_layers=2, n_heads=2, d_ff=4 * d))
    tr = dataclasses.replace(cfg.training.acoustic, mixed_precision=False)
    return dataclasses.replace(cfg, acoustic_model=am,
                               training=dataclasses.replace(cfg.training, acoustic=tr))


def test_acoustic_step_flops_against_flop_counter():
    """The analytic count against FlopCounterMode on one f32 train step (d
    32, 2 + 2 layers, B = 2, 16 phonemes, 64 frames): within 2% (the count
    adds the predictors' d -> 1 projections and bias-free terms the
    counter's matmul shapes fold differently; measured 1.3%)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _small_acoustic_cfg()
    state = init_acoustic_state(random_acoustic_model(cfg, torch.Generator().manual_seed(0)), cfg)
    batch = batch_to_device(synthetic_batch(cfg, 2, tph=16, tfrm=64), "cpu")
    with FlopCounterMode(display=False) as counter:
        make_acoustic_step(cfg)(state, batch, torch.Generator().manual_seed(1))
    counted = counter.get_total_flops()
    assert abs(acoustic_step_flops(cfg, 2, 16, 64) / counted - 1) <= 0.02


def _conv_backward_by_groups(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                             dilation, transposed, output_padding, groups, output_mask,
                             out_shape=None, **kwargs):
    """torch's convolution_backward count, except the weight gradient of a
    grouped conv: torch's formula leaves the groups out there and counts it
    `groups` times; a weight gradient costs its forward's FLOPs."""
    from torch.utils.flop_counter import conv_backward_flop, conv_flop_count

    flops = conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                               dilation, transposed, output_padding, groups,
                               [output_mask[0], False, False], out_val=out_shape)
    if output_mask[1]:
        flops += conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return flops


def test_vocoder_step_flops_against_flop_counter():
    """The analytic count against FlopCounterMode on one f32 adv_mel_fm
    step (generator 32 channels with one ResBlock of dilations (1, 3),
    discriminators at 1/16 width, B = 2, 8-frame segments): within 2%.
    The counter takes torch's formulas but for grouped weight gradients
    (the MSD's convs), which torch's formula counts `groups` times
    (measured: equal, here and at the default config at B = 1)."""
    from torch.utils.flop_counter import FlopCounterMode

    from sambert_hifigan_tpu_torch.flops import vocoder_step_flops
    from sambert_hifigan_tpu_torch.training.vocoder_trainer import (init_vocoder_state,
                                                                    make_vocoder_step)

    cfg = dataclasses.replace(pcfg.default_config(), vocoder=pcfg.VocoderConfig(
        generator=pcfg.GeneratorConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                       resblock_dilation_sizes=((1, 3),)),
        discriminator=pcfg.DiscriminatorConfig(channel_div=16)))
    b, seg = 2, 8
    state = init_vocoder_state(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    mel = torch.tensor(rng.standard_normal((b, 80, seg)), dtype=torch.float32)
    wav = torch.tensor(rng.standard_normal((b, 1, seg * 256)) * 0.1, dtype=torch.float32)
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_by_groups}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        make_vocoder_step(cfg, loss_mode="adv_mel_fm")(state, mel, wav)
    counted = counter.get_total_flops()
    assert abs(vocoder_step_flops(cfg, b, seg) / counted - 1) <= 0.02, counted


def test_bench_scaling_rows_on_the_cpu():
    rows = bench_scaling.run([32], [2], tph=8, tfrm=32, device="cpu", reps=1, k=1,
                             cfg_of=_small_acoustic_cfg)
    assert len(rows) == 1 and rows[0]["d_model"] == 32 and rows[0]["batch"] == 2
    assert rows[0]["ms_per_step"] > 0 and "mfu" not in rows[0]  # no device rate on the CPU


# ---- make_demo_dataset ------------------------------------------------------------


@pytest.mark.parametrize("speaker_var", [0.0, 1.0])
def test_make_demo_dataset_is_byte_identical_to_the_script(speaker_var, tmp_path, monkeypatch):
    jax_script = importlib.import_module("scripts.make_demo_dataset")
    monkeypatch.setattr(sys, "argv", ["make_demo_dataset", "--output", str(tmp_path / "j"),
                                      "--n", "4", "--speaker-var", str(speaker_var)])
    jax_script.main()
    make_demo_dataset.main(["--output", str(tmp_path / "p"), "--n", "4", "--speaker-var",
                            str(speaker_var)])
    theirs = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                    if p.is_file())
    ours = sorted(p.relative_to(tmp_path / "p") for p in (tmp_path / "p").rglob("*")
                  if p.is_file())
    assert ours == theirs and len(ours) == 5
    for rel in ours:
        assert (tmp_path / "p" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel


# ---- plot_audio -------------------------------------------------------------------


@pytest.fixture(scope="module")
def stereo16k(tmp_path_factory):
    """A 16 kHz stereo PCM16 file: a 220 Hz tone with noise, and 330 Hz."""
    rng = np.random.default_rng(3)
    t = np.arange(12000) / 16000
    x = np.stack([0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size),
                  0.3 * np.sin(2 * np.pi * 330 * t)]).astype(np.float32)
    path = tmp_path_factory.mktemp("plot") / "stereo16k.wav"
    save_wav(path, x, 16000)
    return path


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_plot_panels_match_the_jax_ops(stereo16k):
    """Every panel's array against the JAX ops: the resampled mono within
    1e-5 (test_torch_dsp's resample bound); then, on the port's mono, the
    complex STFT within 1e-5 of its max magnitude, the log-mel within 1e-5,
    the mel power within 1e-4 of its max, the dB panels within 0.01 dB
    above -40 dB, the phase within 1e-3 rad where the magnitude is above
    1% of its max, F0 within 1e-3 (relative) where both are voiced with at
    most 1% of the voiced flags differing, energy within 1e-6."""
    audio = AudioConfig()
    ja = JAudio()
    panels = plot_audio.parse_panels("all")
    wav, sr = load_wav(stereo16k)
    ours = plot_audio.panel_arrays(wav, sr, panels, audio, "cpu")
    assert set(panels) <= set(ours) and ours["sr"] == 22050 and ours["sr0"] == 16000
    np.testing.assert_array_equal(ours["channels"], wav)
    mono_j = np.asarray(j_mel.resample(jnp.asarray(wav), sr, 22050)).mean(axis=0)
    assert ours["mono"].shape == mono_j.shape
    assert np.abs(ours["mono"] - mono_j).max() <= 1e-5
    x = jnp.asarray(ours["mono"])
    spec = np.asarray(j_stft.stft_complex(x, ja.n_fft, ja.hop_length, ja.win_length))
    mag = np.abs(spec)
    assert _rel(ours["spec_mag"], mag) <= 1e-5
    big = mag > 1e-2 * mag.max()
    dphase = np.angle(np.exp(1j * (ours["phase"] - np.angle(spec))))
    assert np.abs(dphase[big]).max() <= 1e-3
    db = 20 * np.log10(mag / (mag.max() + 1e-10) + 1e-10)
    assert np.abs(ours["spec_db"] - db)[db > -40].max() <= 1e-2
    mp = np.asarray(j_mel.mel_filterbank(ja)).T @ mag ** 2
    assert _rel(ours["mel_power"], mp) <= 1e-4
    mdb = 10 * np.log10(mp / (mp.max() + 1e-12) + 1e-12)
    assert np.abs(ours["mel_db"] - mdb)[mdb > -40].max() <= 1e-2
    assert np.abs(ours["mel"] - np.asarray(j_mel.log_mel_spectrogram(x, ja))).max() <= 1e-5
    f0_j, v_j = (np.asarray(a) for a in j_feat.extract_f0(x, ja))
    f0_p, v_p = ours["f0"]
    both = v_j & v_p
    assert both.sum() > 10 and (v_j != v_p).mean() <= 0.01
    assert (np.abs(f0_p - f0_j)[both] / f0_j[both]).max() <= 1e-3
    np.testing.assert_allclose(ours["energy"], np.asarray(j_feat.extract_energy(x, ja)),
                               atol=1e-6, rtol=0)


def test_plot_audio_renders_every_panel(stereo16k, tmp_path):
    out = plot_audio.main([str(stereo16k), "--panels", "all", "--seconds", "0.5",
                           "--output", str(tmp_path / "all.png"), "--device", "cpu"])
    assert Path(out).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit, match="unknown panel"):
        plot_audio.parse_panels("waveform,nope")


# ---- the demos --------------------------------------------------------------------


def test_feature_matching_demo_matches_jax():
    """The eight per-critic FM terms, their mean and the total generator
    loss against the JAX vocoder_generator_loss on the flax HiFi-GAN with
    the same weights (tiny vocoder): within 1e-5 (relative) as
    test_torch_vocoder_losses, on generator outputs that agree to f32
    noise."""
    cfg_p = dataclasses.replace(pcfg.TTSConfig(), vocoder=tiny_voc(pcfg))
    cfg_j = dataclasses.replace(jcfg.TTSConfig(), vocoder=tiny_voc(jcfg))
    model_j, variables = jax_vocoder(cfg_j.vocoder, seed=4)
    loss, ours = demo_feature_matching_loss.fm_losses(
        cfg_p, model=port_vocoder(cfg_p.vocoder, variables), device="cpu")
    rng = np.random.default_rng(0)
    mel = jnp.asarray(rng.standard_normal((2, 80, 8)), jnp.float32)
    real = jnp.asarray(rng.standard_normal((2, 1, 8 * 256)) * 0.1, jnp.float32)

    @jax.jit  # one compile: eager flax dispatch of the 8 critics is ~8x slower here
    def jax_losses(variables, mel, real):
        fake = model_j.apply(variables, mel)
        _, msd_rf, msd_fo, msd_ff, _, mpd_rf, mpd_fo, mpd_ff = model_j.apply(
            variables, real, fake, method=j_hg.HiFiGAN.discriminate)
        return j_gen_loss(real, fake, cfg_j.audio, loss_mode="adv_mel_fm",
                          disc_fake_outputs=list(msd_fo) + list(mpd_fo),
                          real_feature_maps=list(msd_rf) + list(mpd_rf),
                          fake_feature_maps=list(msd_ff) + list(mpd_ff))

    want_loss, theirs = jax_losses(variables, mel, real)
    keys = ["gen_fm_loss"] + [f"gen_fm_loss_disc_{i}" for i in range(8)]
    np.testing.assert_allclose([ours[k] for k in keys],
                               [float(theirs[k]) for k in keys], rtol=1e-5, atol=0)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)


@pytest.fixture(scope="module")
def ablation():
    """{mode: (the port's demo row, the JAX step's metric keys)}; the JAX
    schema from jax.eval_shape of its jitted step (traced, not compiled)."""
    out = {}
    for mode in demo_ablation_modes.MODES:
        pair = Pair(loss_mode=mode)
        mel, wav = (np.zeros(s, np.float32) for s in ((2, 80, 8), (2, 1, 8 * 256)))
        schema = jax.eval_shape(pair.step_j, pair.state_j, mel, wav)[1]
        row = demo_ablation_modes.run_mode(mode, 2, 8, cfg=pair.cfg_p, device="cpu",
                                           verbose=False)
        out[mode] = (row, set(schema))
    return out


@pytest.mark.parametrize("mode", demo_ablation_modes.MODES)
def test_ablation_demo_bookkeeping(ablation, mode):
    row, jax_keys = ablation[mode]
    assert set(row) - {"discriminators_trained"} == jax_keys
    assert all(np.isfinite(v) for v in row.values())
    inactive = {"mel_only": ("disc_loss", "d_grad_norm", "gen_adv_loss", "gen_fm_loss",
                             "gen_sc_loss", "gen_mag_loss", "gen_stft_loss"),
                "adv_mel": ("gen_fm_loss",), "adv_mel_fm": ()}[mode]
    assert all(row[k] == 0.0 for k in inactive)
    assert all(row[k] != 0.0 for k in ("gen_mel_loss", "gen_loss", "g_grad_norm"))
    assert row["discriminators_trained"] == (mode != "mel_only")


# ---- the benchmarks ---------------------------------------------------------------


def test_encode_split_decode_of_encode_is_full():
    cfg = profiling.tiny_config(pcfg.default_config())
    fns = bench_encode_split.build(tph=32, tfrm=128, device="cpu", cfg=cfg)
    full = fns["full"]()
    assert full.shape == (1, 128, 80) and full.abs().sum() > 0
    assert torch.equal(fns["decode"](fns["enc"]()), full)
    assert torch.equal(fns["dec"](), full)
    assert bench_encode_split.wall(fns["enc"], "cpu", reps=1, inner=1) > 0
    with pytest.raises(SystemExit, match="device time"):
        bench_encode_split.main(["--trace", "enc", "--device", "cpu"])


def test_decode_modes_plain_on_the_cpu_and_no_kernel_there(capsys):
    from sambert_hifigan_tpu_torch.ops import ar_decode as k1

    w, memory = bench_decode_modes.build("cpu", t=8)
    row, mel = bench_decode_modes.run_mode("plain", w, memory, t=8, reps=1, inner=1)
    want = k1.ar_decode(w, *memory, 8)
    assert mel.shape == (1, 8, 80) and torch.equal(mel, want)
    assert row["checksum"] == pytest.approx(float(want.sum()), rel=1e-6) and row["ms"] > 0
    assert "mode=plain: " in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CPU form"):
        bench_decode_modes.run_mode("kernel", w, memory, t=8)


def test_busy_ms_is_the_union_of_intervals():
    class Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

    class Event:
        def __init__(self, start, end):
            self.time_range = Range(start, end)

    events = [Event(0, 1000), Event(500, 1500), Event(3000, 3500), Event(3100, 3200)]
    assert profiling.busy_ms(events) == pytest.approx(2.0)
    assert profiling.busy_ms([]) == 0.0


@pytest.mark.parametrize("surface", profiling.SURFACES)
def test_profiling_surface_writes_a_trace(surface, tmp_path, capsys):
    res = profiling.main(["--surface", surface, "--tiny", "--device", "cpu", "--reps", "1",
                          "--top-ops", "3", "--batch", "2", "--max-frames", "16",
                          "--output", str(tmp_path)])
    with gzip.open(res["trace"], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert Path(res["trace"]).parent == tmp_path and events
    assert len(res["top_ops"]) == 3 and all(ms >= 0 for _, ms, _ in res["top_ops"])
    assert "busy_ms" not in res  # no device time on the CPU
    assert "CPU operators by self time" in capsys.readouterr().out


# ---- eval_demo_run ----------------------------------------------------------------


def test_eval_demo_run_copy_synthesis_matches_the_flax_generator(
        corpus, acoustic_ckpt, vocoder_ckpt, tmp_path, capsys):
    """Copy-synthesis mel-MAE and MCD of each utterance against the flax
    generator fed the same (EMA) weights, through the JAX eval_metrics:
    within 1e-4 (relative; 16-bit files and f32 noise, as
    test_torch_eval_tools); full-TTS metrics finite, both wavs written."""
    meta, ds = corpus
    _, jgen, _, ema = vocoder_ckpt
    res = eval_demo_run.main(["--metadata", str(meta), "--acoustic-checkpoint",
                              acoustic_ckpt[0], "--vocoder-checkpoint", vocoder_ckpt[0],
                              "--n", "3", "--output-dir", str(tmp_path), "--device", "cpu"],
                             cfg=_cfg(pcfg))
    assert res["steps"] == (7, 5) and len(res["rows"]) == 3
    audio = JAudio()
    for utt, row in zip(ds.utterances, res["rows"]):
        gt = load_wav(Path(meta).parent / utt.wav_path)[0][0]
        mel = ds.load_features(utt)["mel"]
        copy = np.asarray(jax.jit(jgen.apply)(ema, mel.T[None]))[0, 0]
        n = min(len(gt), len(copy))
        np.testing.assert_allclose([row["copy_mel_mae"], row["copy_mcd"]],
                                   [je.mel_mae(gt[:n], copy[:n], audio),
                                    je.mcd(gt[:n], copy[:n], audio)], rtol=1e-4)
        assert all(np.isfinite(row[k]) for k in ("tts_mel_mae_dtw", "tts_mcd"))
        stem = Path(utt.wav_path).stem
        assert (tmp_path / f"{stem}_copy.wav").exists() and (tmp_path / f"{stem}_tts.wav").exists()
    assert "AVG over 3: copy mel-MAE" in capsys.readouterr().out
