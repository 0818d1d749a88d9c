"""The batcher's worker's busy share of the traced stretch: the summed
duration of the program's `batcher.round` spans (passes of the worker's
loop that had work) over the stretch's wall time (its first arrival to
its last stream's end, as `idle.live` takes it).
`worker_busy.live - (100 - idle.live)` is the share of the stretch in
which the worker had work and the card was idle.  Nothing where the
program records no spans."""


def read(run):
    trace = (run.notes.get("stats") or {}).get("trace") or {}
    row = trace.get("spans", {}).get("batcher.round")
    if not row or not row["n"] or run.traced_wall_s <= 0:
        return None
    return 100.0 * row["total_ms"] / 1e3 / run.traced_wall_s
