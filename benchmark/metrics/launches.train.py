"""Kernels launched per vocoder train step in the traced steps (copies and
memsets aside): the step is bound by its launches."""


def read(run):
    if run.trace is None or run.traced_steps <= 0 or run.trace.launches <= 0:
        return None
    return run.trace.launches / run.traced_steps
