"""``cycle_host_ms``: host milliseconds a cycle spends outside the
program's ``stream`` and ``output`` phases (``RunMetrics``): the engine
entry's per-cycle set-up (``production._Blocks`` and ``_Engine``
construction, ``sky_route``, the placement of parameters, anchors and
the warm state, the station sort) and the harness's warm-start draw, the
cycle's wall time (host clock) less those phases, averaged over the
traced window's cycles.  Moves ``point_steps_per_s``."""


def read(r):
    if not r.cycle_s or "stream" not in r.phases:
        return None
    other = (sum(r.cycle_s) - r.phases["stream"]
             - r.phases.get("output", 0.0))
    return 1e3 * other / len(r.cycle_s)
