"""The host's time in a live stream's encode (encoder, variance adaptor and
memory K/V at B = 1): the mean host duration of the program's
`stream.encode` span over the traced stretch, from
`DynamicBatcher.stats()["trace"]`.  Against `encode_device.live`: near
it, the device waits on the launches; well under it, the device is behind
the host.  Nothing where the program records no spans."""


def read(run):
    trace = (run.notes.get("stats") or {}).get("trace") or {}
    row = trace.get("spans", {}).get("stream.encode")
    return row["mean_ms"] if row and row["n"] else None
