"""A live stream's wait in the batcher's queue: the mean of the program's
`batcher.queue_wait` span (a request's put to the worker's pop) over the
traced stretch's streams, as `DynamicBatcher.stats()["trace"]` gives it.
The program records its spans while the profiler runs, so they cover the
stretch `idle.live` covers; a program without them gives nothing."""


def read(run):
    trace = (run.notes.get("stats") or {}).get("trace") or {}
    row = trace.get("spans", {}).get("batcher.queue_wait")
    return row["mean_ms"] if row and row["n"] else None
