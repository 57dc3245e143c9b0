"""``drain_wait_ms_per_chunk``: host milliseconds the drain waits on the
card for a chunk's rows (``production._Blocks._drain``, the span
``stream.drain.wait``), from the program's ``RunMetrics`` counters
``stream_wait_s`` / ``stream_chunks`` summed over the window's cycles.
Near zero where the host sets the stream's pace.  Moves
``point_steps_per_s``."""


def read(r):
    n = r.counters.get("stream_chunks", 0)
    if not n or "stream_wait_s" not in r.counters:
        return None
    return 1e3 * r.counters["stream_wait_s"] / n
