"""``k2_roofline``: K2's share of its roofline bound, the
whole-scan kernel on the slim station forcing (``scan_kernel<LM, DEPTH,
SLIM=true, FUSED=false, CS>``): the bound of the window's K2 work
(``roofline.k2_seconds``, the benchmark's own count from the cell's
shapes) over K2's device time from the profiler.  Moves
``point_steps_per_s``.  Nothing to read where no K2 launch ran."""

#: K2's name as the profiler reports it (the template's SLIM and FUSED)
PATTERN = r"scan_kernel<\d+, (?:true|false), true, false,"


def read(r):
    if r.trace is None:
        return None
    from benchmark import roofline
    t, n = r.trace.seconds(PATTERN)
    if not n:
        return None
    work = roofline.work_of(r.shapes)
    return 100.0 * r.cycles * roofline.k2_seconds(work) / t
