"""``device_idle_pct``: the share of the traced window in which nothing
ran on the card: 100 minus the union of every device activity (kernels,
copies, memsets) over the window, from the profiler.  Moves
``point_steps_per_s``."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
