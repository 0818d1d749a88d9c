"""The one-shot calls' share of the cards' bf16 peak: the analytic FLOPs of
the window's valid work (each row's acoustic model over its phonemes and
frames, and the generator over its frames) over the window's wall time and
989 TFLOP/s per card."""

from work.flops import BF16_FLOP_PER_S, acoustic_inference_flops, generator_flops


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    flops = sum(acoustic_inference_flops(run.config, ph, f)
                + generator_flops(run.config, 1, f)[0]
                for call in run.calls for ph, f in call)
    return 100.0 * flops / run.window_s / (BF16_FLOP_PER_S * run.chips)
