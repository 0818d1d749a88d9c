"""K2's share of its roofline in the traced one-shot calls: the least time
of each MRF stage over the valid samples (work/flops.k2_work), summed, over
the device time of `chain_kernel`, `conv_kernel` and `operand_kernel`."""

from work.flops import k2_work, least_seconds
from work.rows import per_card

KERNELS = ("chain_kernel", "conv_kernel", "operand_kernel")


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    device_s = run.trace.seconds_of(*KERNELS)
    if device_s <= 0:
        return None
    least = sum(least_seconds(*stage) for call in run.traced_calls
                for rows in per_card(call, run.chips)
                for stage in k2_work(run.config, [f for _, f in rows]))
    return 100.0 * least / device_s
