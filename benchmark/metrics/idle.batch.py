"""The cards' idle share over the one-shot calls: 1 - busy / wall, busy the
union of kernel intervals of one traced cycle (the mean over the cards),
wall that cycle's time without the profiler."""


def read(run):
    if run.trace is None or run.traced_wall_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced_wall_s)
