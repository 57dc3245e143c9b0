"""``window_ms``: device milliseconds a cycle of the coupling window's
kernel (K5, ``window_kernel`` in ``csrc/scan_kernel.cu``; K5 fused is
the same template), from the profiler's kernels by name.  Moves
``point_steps_per_s``.  Nothing to read where no such kernel ran."""

#: the kernel's name as the profiler reports it
PATTERN = r"window_kernel<"


def read(r):
    if r.trace is None:
        return None
    t, n = r.trace.seconds(PATTERN)
    return 1e3 * t / r.cycles if n else None
