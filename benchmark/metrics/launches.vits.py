"""Kernels launched per one-shot call in the traced calls (copies and
memsets aside): VITS's acoustic pass is a few hundred small launches
beside the generator's."""


def read(run):
    if run.trace is None or not run.traced_calls or run.trace.launches <= 0:
        return None
    return run.trace.launches / len(run.traced_calls)
