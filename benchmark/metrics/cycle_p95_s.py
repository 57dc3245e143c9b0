"""``cycle_p95_s``: the 95th percentile (numpy, linear) of the traced
window's cycle wall times, host clock: the deadline a forecast service
feels.  A per-layer reading: over a window's 25-50 cycles it is the
second-longest cycle, and it swings with the host's load far past the
0.25 that an end-to-end bound may have.  Moves ``point_steps_per_s``."""


def read(r):
    if not r.cycle_s:
        return None
    import numpy as np
    return float(np.percentile(np.asarray(r.cycle_s), 95))
