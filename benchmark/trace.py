"""The device's side of a traced window, from ``torch.profiler``.

The traced run (``--trace 1``) records the card's activity (kernels,
copies, memsets) over its whole window with the profiler's CUDA activity
alone.  This module turns the events into what the per-layer readers and
the result line need: the union of all device activity (busy seconds),
each name's summed seconds, and the longest idle gaps.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Tuple


class DeviceTrace(NamedTuple):
    """Device intervals [(name, start_us, end_us)] of a traced window."""
    events: List[Tuple[str, float, float]]
    window_s: float

    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device."""
        busy, end = 0.0, None
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-6

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """{name: (seconds, count)}."""
        out = {}
        for name, s, e in self.events:
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + (e - s) * 1e-6, n + 1)
        return out

    def seconds(self, pattern: str) -> Tuple[float, int]:
        """Summed seconds and count of the operations whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        t = n = 0
        for name, (s, c) in self.by_name().items():
            if rx.search(name):
                t += s
                n += c
        return t, n

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the ``n`` operations that took most time."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])
        return [[name, t] for name, (t, _) in ops[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what came before, seconds]] of the ``n`` longest stretches with
        nothing on the device, each named by the operation that ended
        before it (the host was then preparing what came next)."""
        gaps, end, last = [], None, None
        for name, s, e in sorted(self.events, key=lambda x: x[1]):
            if end is not None and s > end:
                gaps.append([f"after {_short(last)}", (s - end) * 1e-6])
            if end is None or e > end:
                end, last = e, name
        gaps.sort(key=lambda g: -g[1])
        return gaps[:n]


def _short(name: str, n: int = 80) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def profiler():
    """A profiler of the card's activity alone (no host operators)."""
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def read(prof, window_s: float) -> DeviceTrace:
    """The device events of a finished profiler."""
    import torch
    events = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start = float(ev.time_range.start)
        events.append((ev.name, start, start + float(ev.time_range.elapsed_us())))
    return DeviceTrace(events, window_s)
