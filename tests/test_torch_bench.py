"""The port's benchmark, `python -m sambert_hifigan_tpu_torch.bench`, on the
CPU at the tiny config, and the vocoder train step's FLOP count.

Nothing here compares against JAX: the root `bench.py` needs a TPU and
its numbers are not the card's.  Its JSON keys (bench.py, the final print)
are the contract the port's line keeps.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch imports cProfile lazily
import cProfile  # noqa: F401
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop, conv_flop_count

from sambert_hifigan_tpu_torch import bench
from sambert_hifigan_tpu_torch.config import (DiscriminatorConfig, GeneratorConfig,
                                              VocoderConfig, default_config)
from sambert_hifigan_tpu_torch.flops import vocoder_step_flops
from sambert_hifigan_tpu_torch.profiling import tiny_config
from sambert_hifigan_tpu_torch.training.vocoder_trainer import (init_vocoder_state,
                                                                make_vocoder_step)

from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

# the keys of the root bench.py's JSON line
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "vs_repo_target",
            "decode_b16_frames_per_s", "decode_b16_vs_2x_b8", "stream_ttfb_ms",
            "train_acoustic_steps_per_s", "train_acoustic_mfu", "train_vocoder_steps_per_s",
            "train_vocoder_mfu")
ROWS = ("e2e", "vocoder", "text_to_mel", "text_to_mel_b4", "decode_b16", "decode_b8",
        "stream", "pinned_e2e", "pinned_text_to_mel")


@pytest.fixture(scope="module")
def line():
    """The last stdout line of one CPU run at the tiny config."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = bench.main(["--device", "cpu", "--tiny", "--reps", "2"])
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last == json.loads(json.dumps(ret))
    return last


def test_bench_line_has_the_jax_keys_and_more(line):
    for key in JAX_KEYS + ("spread", "valid_frames", "fill", "rtf_returned", "card", "ms"):
        assert key in line, key
    assert line["metric"] == "e2e_text_to_wav_rtf" and line["unit"] == "rtf"
    assert line["dtype"] == "bfloat16" and line["device"] == "cpu" and line["card"] is None
    for key in JAX_KEYS[1:]:
        if key in ("metric", "unit"):
            continue
        assert key in line["spread"], key
        if key.endswith(("_per_s", "_mfu")):  # no device rates on the CPU
            assert line[key] is None and line["spread"][key] is None, key
        else:
            lo, hi = line["spread"][key]
            assert math.isfinite(line[key]) and lo <= line[key] <= hi, key
    assert line["vs_baseline"] == pytest.approx(0.1 / line["value"])
    assert line["vs_repo_target"] == pytest.approx(0.05 / line["value"])


def test_bench_audio_bookkeeping(line):
    """The JAX script counts the whole 512-frame bucket as audio (5.94 s);
    the returned audio is the text's valid frames, and each row's fill is
    its valid frames over its bucket."""
    assert round(line["audio_s"], 2) == 5.94 and line["audio_s"] == 512 * 256 / 22050
    assert set(line["valid_frames"]) == set(line["fill"]) == set(ROWS)
    n = line["valid_frames"]["e2e"]
    assert line["returned_audio_s"] == n * 256 / 22050
    assert line["rtf_returned"] == pytest.approx(line["value"] * 512 / n)
    assert line["valid_frames"]["text_to_mel_b4"] == 4 * n
    assert line["fill"]["e2e"] == n / 512 and line["fill"]["text_to_mel_b4"] == n / 512
    assert line["fill"]["decode_b16"] == line["valid_frames"]["decode_b16"] / (16 * 256)
    assert all(0 < f <= 1 for f in line["fill"].values())
    # the pinned rows: ~12 frames a phoneme, several times the random fill
    assert 10 <= line["pinned_frames_per_phoneme"] <= 14
    assert line["fill"]["pinned_e2e"] > 3 * line["fill"]["e2e"]
    assert set(line["ms"]) == set(ROWS) | {"train_acoustic", "train_vocoder"}


def test_bench_spread_arithmetic():
    t = bench.Stat(2.0, 1.0, 4.0)
    assert bench.per_s(8, t) == (4.0, 2.0, 8.0)
    assert bench.ratio(t, bench.Stat(1.0, 0.5, 2.0), 2.0) == (4.0, 1.0, 16.0)
    assert bench.inverse(bench.scaled(t, 0.5), 1.0) == (1.0, 0.5, 2.0)


def test_pinned_fill_pipeline_durations():
    cfg = tiny_config(default_config())
    pipe = bench.pinned_fill_pipeline(cfg, "cpu", torch.bfloat16)
    out = pipe.text_to_mel([bench.TEXT], max_frames=bench.MAX_FRAMES)
    dur = out.predictions["dur"][0]
    dur = dur[dur > 0].float()
    assert pipe.dtype == torch.bfloat16 and 10 <= float(dur.mean()) <= 14


def _conv_backward_by_groups(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                             dilation, transposed, output_padding, groups, output_mask,
                             out_shape=None, **kwargs):
    """torch's convolution_backward count, except the weight gradient of a
    grouped conv: torch's formula leaves the groups out there and counts it
    `groups` times; a weight gradient costs its forward's FLOPs."""
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
    cfg = dataclasses.replace(default_config(), vocoder=VocoderConfig(
        generator=GeneratorConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                  resblock_dilation_sizes=((1, 3),)),
        discriminator=DiscriminatorConfig(channel_div=16)))
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
