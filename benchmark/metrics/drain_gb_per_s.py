"""``drain_gb_per_s``: the drain's host copy rate, the bytes it copies
into the run's host rows (``production._HostRows.put``) over the seconds
it takes (the span ``stream.drain.rows``), from the program's
``RunMetrics`` counters ``stream_rows_bytes`` / ``stream_rows_s`` summed
over the window's cycles.  Moves ``point_steps_per_s``.  Nothing to read
where the program does not count the bytes."""


def read(r):
    t = r.counters.get("stream_rows_s", 0)
    if not t or "stream_rows_bytes" not in r.counters:
        return None
    return r.counters["stream_rows_bytes"] / t / 1e9
