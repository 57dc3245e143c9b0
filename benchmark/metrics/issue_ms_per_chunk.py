"""``issue_ms_per_chunk``: host milliseconds the engine spends issuing a
chunk (its forcing, the sharded launch and the rows' copy queued,
``production._Blocks._issue``), from the program's ``RunMetrics``
counters ``stream_issue_s`` / ``stream_chunks`` summed over the window's
cycles.  Moves ``point_steps_per_s``."""


def read(r):
    n = r.counters.get("stream_chunks", 0)
    return 1e3 * r.counters["stream_issue_s"] / n if n else None
