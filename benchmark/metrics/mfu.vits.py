"""The VITS one-shot calls' share of the cards' bf16 peak: the analytic
FLOPs of the window's valid work (work/vits.vits_flops: each row's text
encoder and duration predictor over its tokens, its flow and generator
over its frames) over the window's wall time and 989 TFLOP/s per card.
Nothing for a configuration that is not VITS's."""

from work.flops import BF16_FLOP_PER_S
from work.vits import vits_flops


def read(run):
    if not run.calls or run.window_s <= 0 or "inter_channels" not in run.config:
        return None
    flops = sum(vits_flops(run.config, ph, f) for call in run.calls for ph, f in call)
    return 100.0 * flops / run.window_s / (BF16_FLOP_PER_S * run.chips)
