"""The VITS cell (`tts-batch-vits`, model `vits`) on the CPU at its model's
TINY size: the batch driver runs it correct, an altered answer and the
fp8 control are caught, its two metric readers read what they should and
nothing elsewhere, and the FLOP count has the shares the configuration's
design rests on."""

from __future__ import annotations

import pytest

import bm_tiny
from harness.core import run_cell
from harness.record import Context, Run
from harness.spec import load_cell, reader
from harness.trace import Trace
from work.flops import generator_flops
from work.vits import duration_macs, encoder_macs, flow_macs, vits_flops

SEED = 2 ** 31 + 4321
CELL = "tts-batch-vits"


def _tiny():
    return bm_tiny.tiny(load_cell(CELL))


def test_vits_cell_runs_correct_through_the_batch_driver():
    line, run = run_cell(_tiny(), SEED, 0.2, False, Context(device="cpu"))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert line["checks"]["length_mismatch"]["value"] == 0.0
    # 3 frames a token (ceil 2.5), 2n + 1 tokens a text of n front-end phonemes
    assert all(f == 3 * (2 * ph + 1) for call in run.calls for ph, f in call)


def test_vits_cell_catches_an_altered_answer():
    line, _ = run_cell(_tiny(), SEED, 0.2, False, Context(device="cpu", fault="answer_altered"))
    assert line["correct"] is False and line["checks"]["wav_max_abs_err"]["value"] >= 0.009


def test_vits_fp8_control_is_not_correct():
    import calibrate

    cell = _tiny()
    checks = calibrate.readings(cell, "control", SEED, 0.3, device="cpu")["checks"]
    assert any(v > cell.limits[k] for k, v in checks.items()), checks


def _run(config, calls, trace=None, window_s=2.0):
    run = Run(config, {}, 1)
    run.calls, run.traced_calls, run.window_s, run.trace = calls, calls[:2], window_s, trace
    return run


def test_readers_read_the_vits_cell_and_nothing_else():
    c = load_cell(CELL).config
    calls = [[(24, 294), (10, 126)], [(40, 486)]]
    trace = Trace(1.0, 0.9, {}, launches=1300)
    run = _run(c, calls, trace)
    want = sum(vits_flops(c, ph, f) for call in calls for ph, f in call) / 2.0 / 989e12 * 100
    assert reader("mfu.vits")(run) == pytest.approx(want)
    assert reader("launches.vits")(run) == 650.0
    sambert = load_cell("tts-batch").config
    assert reader("mfu.vits")(_run(sambert, calls, trace)) is None
    assert reader("launches.vits")(_run(c, calls)) is None  # an untraced run
    assert reader("mfu.vits")(_run(c, [])) is None


def test_flop_count_puts_the_generator_first():
    """At ljs_base's widths the generator is ~600 MFLOP a frame, the flow
    ~14, the encoder and duration predictor ~14 a token; a text of 22
    characters (24 phonemes, 49 tokens, 294 frames) spends over 95% of its
    FLOPs in the generator."""
    c = load_cell(CELL).config
    gen = generator_flops(dict(c, n_mels=c["inter_channels"]), 1, 1)[0]
    assert 590e6 < gen < 630e6
    assert 13e6 < 2 * flow_macs(c) < 15e6
    assert 12e6 < 2 * (encoder_macs(c, 49) + duration_macs(c)) < 16e6
    total = vits_flops(c, 24, 294)
    assert generator_flops(dict(c, n_mels=192), 1, 294)[0] / total > 0.95
