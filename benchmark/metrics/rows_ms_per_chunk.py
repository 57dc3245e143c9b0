"""``rows_ms_per_chunk``: host milliseconds the drain spends copying a
chunk's output rows into step order (``production._Blocks._drain``,
``_HostRows``), from the program's ``RunMetrics`` counters
``stream_rows_s`` / ``stream_chunks`` summed over the window's cycles.
Moves ``point_steps_per_s``."""


def read(r):
    n = r.counters.get("stream_chunks", 0)
    return 1e3 * r.counters["stream_rows_s"] / n if n else None
