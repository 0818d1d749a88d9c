"""K1's share of its roofline in the traced one-shot calls: the least time
the card could take for the decode's work over each row's valid frames
(work/flops.k1_work, per card's rows), over the device time of
`ar_decode_kernel`."""

from work.flops import k1_work, least_seconds
from work.rows import per_card


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    device_s = run.trace.seconds_of("ar_decode_kernel")
    if device_s <= 0:
        return None
    least = sum(least_seconds(*k1_work(run.config, [f for _, f in rows]))
                for call in run.traced_calls for rows in per_card(call, run.chips))
    return 100.0 * least / device_s
