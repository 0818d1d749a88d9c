"""The device's time in a live stream's encode: the mean of the program's
`stream.encode` device span (CUDA events before and after the work it
enqueues, read after the path's own sync) over the traced stretch, from
`DynamicBatcher.stats()["trace"]`; nothing where the program records no
spans."""


def read(run):
    trace = (run.notes.get("stats") or {}).get("trace") or {}
    row = trace.get("device", {}).get("stream.encode")
    return row["mean_ms"] if row and row["n"] else None
