"""A live stream's first chunk inside the worker: the mean of the
program's `stream.first_chunk` span (the worker's pop to the first chunk
in the client's queue: the round's earlier chunks, the front end, the
encode, the first decode chunks, the first window and its copy) over the
traced stretch, from `DynamicBatcher.stats()["trace"]`; nothing where the
program records no spans."""


def read(run):
    trace = (run.notes.get("stats") or {}).get("trace") or {}
    row = trace.get("spans", {}).get("stream.first_chunk")
    return row["mean_ms"] if row and row["n"] else None
