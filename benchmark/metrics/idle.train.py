"""The card's idle share in training: 1 - busy / wall per step, busy the
union of kernel intervals of the traced steps, wall the window's mean step
without the profiler."""


def read(run):
    if run.trace is None or run.traced_steps <= 0 or run.steps <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - (run.trace.busy_s / run.traced_steps) / (run.window_s / run.steps))
