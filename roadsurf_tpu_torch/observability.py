"""Observability: spans, counters, progress reporting and profiler traces.

The counterpart of ``roadsurf_tpu/observability.py`` (``RunMetrics``,
``Progress``, ``failure_summary``, ``detect_nan_points`` and
``profile_trace``).  The reference's observability is stdout progress
prints every 1000 points (examples/example1/src/roadrunner.cpp:396-397).
Here: nested spans and counters at the layer boundaries of the data plane,
the init and the engine entry (``RunMetrics``), each span also a profiler
range ``roadsurf::<name>`` while a torch profiler records, a progress
callback for chunked runs, a ``torch.profiler`` trace of a run (the JAX
package's ``jax.profiler`` capture) and the device's idle time put down to
the spans open through it (``idle_by_span``).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

#: the prefix of the profiler ranges the spans open
RANGE_PREFIX = "roadsurf::"
#: where ``idle_by_span`` puts idle time no span covers
OUTSIDE = "(outside)"


@dataclass
class RunMetrics:
    """Spans and counters of one run, or of the cycles it is handed to.

    A span (``phase``) books its host-clock seconds under its name in
    ``phases``, its calls in ``calls`` and its self time (its seconds less
    those of the spans opened inside it) in ``self_s``, all summed over
    its calls.  While a torch profiler records (``torch.profiler``,
    ``emit_nvtx``), a span is also the range ``roadsurf::<name>``, with its
    ids (the cycle's index, counted up by ``cycle``, and the chunk's index
    within the cycle) as the range's keyword inputs, which a trace with
    ``record_shapes`` shows; without one it costs two clock reads and a
    flag read.

    ``announce=True`` prints (flushed) phase start/end lines to stderr so
    long device-bound phases (first device op waiting on a free chip, large
    host->device transfers, kernel builds) are visible while in flight --
    piped/verbose runs would otherwise sit silent for minutes."""
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    announce: bool = False
    calls: Dict[str, int] = field(default_factory=dict)
    self_s: Dict[str, float] = field(default_factory=dict)
    #: engine-entry calls begun (``cycle``); the current one's index is
    #: ``cycles - 1``
    cycles: int = 0
    #: the seconds of the spans closed inside each open span, innermost last
    _inner: List[float] = field(default_factory=list, init=False,
                                repr=False, compare=False)

    @contextlib.contextmanager
    def phase(self, name: str, counter: Optional[str] = None, **ids):
        """The span ``name``; ``counter`` (optional) also adds its seconds
        to that counter; ``ids`` are the profiler range's keyword inputs."""
        rng = None
        if _autograd_profiler._is_profiler_enabled:
            rng = torch._C._profiler._RecordFunctionFast(
                RANGE_PREFIX + name, (), ids)
            rng.__enter__()
        if self.announce:
            print(f"[phase] {name} ...", file=sys.stderr, flush=True)
        self._inner.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            inner = self._inner.pop()
            if self._inner:
                self._inner[-1] += dt
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1
            self.self_s[name] = self.self_s.get(name, 0.0) + dt - inner
            if counter is not None:
                self.add(counter, dt)
            if rng is not None:
                rng.__exit__(None, None, None)
            if self.announce:
                print(f"[phase] {name} done in {dt:.1f}s", file=sys.stderr,
                      flush=True)

    def cycle(self):
        """The span ``cycle`` of one engine-entry call, its index the
        engine-entry calls begun before it."""
        self.cycles += 1
        return self.phase("cycle", cycle=self.cycles - 1)

    def count(self, name: str, value: float):
        self.counters[name] = value

    def add(self, name: str, value: float):
        """Add ``value`` to a counter (from 0)."""
        self.counters[name] = self.counters.get(name, 0) + value

    def note(self, msg: str):
        """One-line engine decision note (fast-path fallbacks etc.); printed
        only in announce (verbose) mode so slow paths are never silent."""
        if self.announce:
            print(f"[engine] {msg}", file=sys.stderr, flush=True)

    def report(self, stream=sys.stderr):
        """One JSON line of the span seconds (and, where spans ran, their
        self seconds) and the counters."""
        doc = {"phases_s": {k: round(v, 4) for k, v in self.phases.items()}}
        if self.self_s:
            doc["self_s"] = {k: round(v, 4) for k, v in self.self_s.items()}
        doc["counters"] = self.counters
        print(json.dumps(doc), file=stream, flush=True)


class Progress:
    """Chunk-level progress reporting (reference: every-1000-points prints;
    here the batch is one device call, so progress is over time chunks)."""

    def __init__(self, total_steps: int, every_s: float = 5.0,
                 stream=sys.stderr):
        self.total = total_steps
        self.done = 0
        self.every = every_s
        self.stream = stream
        self._last = 0.0
        self._t0 = time.perf_counter()

    def update(self, steps: int):
        # chunk updates may overshoot on the padded tail; clamp to total
        self.done = min(self.done + steps, self.total)
        now = time.perf_counter()
        if now - self._last >= self.every or self.done >= self.total:
            rate = self.done / max(now - self._t0, 1e-9)
            eta = (self.total - self.done) / max(rate, 1e-9)
            print(f"\t{self.done} / {self.total} steps "
                  f"({100.0 * self.done / self.total:.0f}%, eta {eta:.0f}s)",
                  file=self.stream, flush=True)
            self._last = now


def failure_summary(failed, lats=None, lons=None, limit: int = 10,
                    stream=sys.stderr, point_range=None):
    """Batched analogue of the reference's per-point BAD-input prints
    (src/InputOutput.f90:63-80): one summary + the first few failing points.
    ``failed`` (a tensor or array) and ``lats``/``lons`` cover this process's
    points; with ``point_range`` (a ``drain="shard"`` result's) the line
    names the global range they are.  Returns the count."""
    if isinstance(failed, torch.Tensor):
        failed = failed.detach().cpu().numpy()
    failed = np.asarray(failed)
    n = int(failed.sum())
    if n == 0:
        return 0
    idx = np.where(failed)[0]
    msg = f"{n}/{failed.size} points failed"
    if point_range is not None:
        msg += f" in points [{point_range[0]}, {point_range[1]})"
    if lats is not None and lons is not None:
        locs = ", ".join(f"({lats[i]:.3f},{lons[i]:.3f})"
                         for i in idx[:limit])
        msg += f"; first: {locs}"
    print(msg, file=stream)
    return n


def detect_nan_points(state):
    """NaN-poisoning detection (SURVEY.md section 5: per-point validity mask +
    NaN detection replaces the reference's sanitizer builds): returns an
    updated state with NaN/Inf-carrying points marked failed, plus the mask.

    The physics cannot produce NaN from valid inputs (all guards are selects),
    so a NaN means corrupted input or hardware fault -- contained per point,
    like every other failure."""
    bad = ~torch.isfinite(state.tmp).all(dim=-1)
    for name in ("tsurf_ave", "wat", "snow", "ice", "ice2", "dep",
                 "q2melt", "blcond", "albedo"):
        bad = bad | ~torch.isfinite(getattr(state, name))
    return state._replace(failed=state.failed | bad), bad


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], summary: bool = False):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, its kernels), written to ``log_dir`` as a Chrome trace
    ``trace_<pid>.json`` (view in chrome://tracing or Perfetto); nothing
    without a directory (observability.py:101-112).  Yields the profiler
    (None without a directory).  The trace records shapes, so the spans'
    ranges carry their ids.  ``summary`` prints, after the trace is
    written, one stderr line of the spans the device's idle time fell in
    (``idle_by_span_of``), the longest first."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}.json"))
    if summary:
        idle = sorted(idle_by_span_of(prof).items(), key=lambda kv: -kv[1])
        print("device idle by span, s: " + (", ".join(
            f"{name} {t:.4f}" for name, t in idle[:8]) or "none"),
            file=sys.stderr, flush=True)


def idle_by_span(device, spans) -> Dict[str, float]:
    """The device's idle time put down to host spans: ``device`` its busy
    intervals ``[(start, end)]``, ``spans`` the host's ranges
    ``[(name, start, end)]``, on one clock.  Each stretch with nothing on
    the device, from the first start to the last end of either, is split
    at span edges; each piece goes to the innermost range that covers it
    (the latest opened of those still open), or to ``OUTSIDE`` where none
    does.  Returns ``{span name: idle time}`` in the inputs' unit."""
    busy = []
    for s, e in sorted(device):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    marks = sorted({t for iv in busy for t in iv}
                   | {t for _, s, e in spans for t in (s, e)})
    by_start = sorted(spans, key=lambda r: r[1])
    out, opened, si, bi = {}, [], 0, 0
    for t0, t1 in zip(marks, marks[1:]):
        while si < len(by_start) and by_start[si][1] <= t0:
            opened.append(by_start[si])
            si += 1
        opened = [r for r in opened if r[2] > t0]
        while bi < len(busy) and busy[bi][1] <= t0:
            bi += 1
        if bi < len(busy) and busy[bi][0] <= t0:
            continue
        # innermost: the latest start, of equal starts the earliest end
        name = (max(opened, key=lambda r: (r[1], -r[2]))[0] if opened
                else OUTSIDE)
        out[name] = out.get(name, 0.0) + t1 - t0
    return out


def idle_by_span_of(prof) -> Dict[str, float]:
    """``idle_by_span`` of a finished ``torch.profiler``: its device
    events (kernels, copies, memsets) against its host ``roadsurf::``
    ranges, in seconds, the range names without the prefix."""
    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for ev in prof.events():
        s = ev.time_range.start * 1e-6
        e = ev.time_range.end * 1e-6
        if ev.name.startswith(RANGE_PREFIX):
            if ev.device_type != cuda:
                spans.append((ev.name[len(RANGE_PREFIX):], s, e))
        elif ev.device_type == cuda:
            device.append((s, e))
    return idle_by_span(device, spans)
