"""``window_lane_pct``: the share of the coupling window kernel's (K5's)
lane-steps that advance a point: every point's window steps over 32 times
the steps of the slowest point of each warp of 32 consecutive points,
from the program's ``RunMetrics`` counters
``coupling_window_point_steps`` / ``coupling_window_lane_steps`` summed
over the window's cycles.  Below 100 where lanes idle behind a warp's
slowest point (its rewinds, its window).  Moves ``point_steps_per_s``.
Nothing to read where no window ran or the program does not count it."""


def read(r):
    lanes = r.counters.get("coupling_window_lane_steps", 0)
    if not lanes:
        return None
    return 100.0 * r.counters["coupling_window_point_steps"] / lanes
