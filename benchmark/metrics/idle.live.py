"""The card's idle share under live streams: 1 - busy / wall over a traced
stretch of the open loop (its first arrivals), busy the union of kernel
intervals, wall the stretch from its first arrival to its last stream's
end.  The arrivals are fixed, so the profiler does not change the wall."""


def read(run):
    if run.trace is None or run.traced_wall_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced_wall_s)
