"""The vocoder train step's share of the card's bf16 peak: the analytic
FLOPs of the adv_mel_fm step (work/flops.vocoder_step_flops) times the
window's steps, over the window's wall time and 989 TFLOP/s."""

from work.flops import BF16_FLOP_PER_S, vocoder_step_flops


def read(run):
    if run.steps <= 0 or run.window_s <= 0:
        return None
    tr = run.traffic
    flops = vocoder_step_flops(run.config, tr["batch"], tr["segment_frames"]) * run.steps
    return 100.0 * flops / run.window_s / BF16_FLOP_PER_S
