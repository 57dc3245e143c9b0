"""``k3_fused_roofline``: K3 fused's share of its roofline bound, the
whole-scan kernel preparing the grid's forcing in the kernel
(``scan_kernel<LM, DEPTH, SLIM, FUSED=true, CS>``): the bound of the
window's K3 fused work (``roofline.k3_fused_seconds``) over its device
time from the profiler.  Moves ``point_steps_per_s``.  Nothing to read
where no K3 fused launch ran."""

#: K3 fused's name as the profiler reports it (the template's FUSED)
PATTERN = r"scan_kernel<\d+, (?:true|false), (?:true|false), true,"


def read(r):
    if r.trace is None:
        return None
    from benchmark import roofline
    t, n = r.trace.seconds(PATTERN)
    if not n:
        return None
    work = roofline.work_of(r.shapes)
    return 100.0 * r.cycles * roofline.k3_fused_seconds(work) / t
