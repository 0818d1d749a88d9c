"""The batcher's live streams as each arrival finds them: the mean of
`DynamicBatcher.stats()["active_streams"]` sampled at every arrival of the
window.  Each round advances every live stream by one chunk before a new
stream is admitted, so fewer live streams admit a new one sooner."""


def read(run):
    samples = run.samples.get("active_streams")
    if not samples:
        return None
    return sum(samples) / len(samples)
