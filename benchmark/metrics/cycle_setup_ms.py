"""``cycle_setup_ms``: host milliseconds a cycle spends in the engine
entry before its first chunk is issued (the ``sky_route`` scan, each
block's expander block and station sort, the engine's placement of
parameters, anchors and the warm state, the kernels' library, the
window's plan, the host rows), from the program's ``RunMetrics`` span
``cycle_setup`` summed over the window's cycles.  Moves
``point_steps_per_s``.  Nothing to read where the program has no such
span."""


def read(r):
    if not r.cycles or "cycle_setup" not in r.phases:
        return None
    return 1e3 * r.phases["cycle_setup"] / r.cycles
