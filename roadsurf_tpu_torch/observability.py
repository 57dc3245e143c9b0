"""Observability: phase timers, progress reporting and profiler traces.

The counterpart of ``roadsurf_tpu/observability.py`` (``RunMetrics``,
``Progress``, ``failure_summary``, ``detect_nan_points`` and
``profile_trace``).  The reference's observability is stdout progress
prints every 1000 points (examples/example1/src/roadrunner.cpp:396-397).
Here: structured phase timers around data plane/init/stream/output, a
progress callback for chunked runs, and a ``torch.profiler`` trace of a
run (the JAX package's ``jax.profiler`` capture).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch


@dataclass
class RunMetrics:
    """Collected phase timings + counters for one simulation run.

    ``announce=True`` prints (flushed) phase start/end lines to stderr so
    long device-bound phases (first device op waiting on a free chip, large
    host->device transfers, kernel builds) are visible while in flight --
    piped/verbose runs would otherwise sit silent for minutes."""
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    announce: bool = False

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        if self.announce:
            print(f"[phase] {name} ...", file=sys.stderr, flush=True)
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if self.announce:
                print(f"[phase] {name} done in {dt:.1f}s", file=sys.stderr,
                      flush=True)

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
        """One JSON line of the phase seconds and the counters."""
        doc = {"phases_s": {k: round(v, 4) for k, v in self.phases.items()},
               "counters": self.counters}
        print(json.dumps(doc), file=stream, flush=True)

    def point_steps_per_s(self, npoints: int, nsteps: int,
                          phase: str = "stream") -> Optional[float]:
        """Point-steps a second over a phase's seconds (None before it
        ran)."""
        t = self.phases.get(phase)
        return npoints * nsteps / t if t else None


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
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, its kernels), written to ``log_dir`` as a Chrome trace
    ``trace_<pid>.json`` (view in chrome://tracing or Perfetto); nothing
    without a directory (observability.py:101-112)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}.json"))
