"""Frozen copy of ``roadsurf_tpu_torch/io/interp.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Time interpolation of raw weather series onto the simulation grid.

Replicates JsonSource::interpolate (examples/example1/src/JsonSource.cpp:49-176):
 * exact time match (tolerance 0.01 s) copies the raw value if not missing;
 * otherwise linear interpolation between the bracketing raw samples, only
   when BOTH endpoints are valid (per variable);
 * PrecPhase takes the NEXT raw sample (nearest-next, :171-172);
 * sim times before the first / after the last raw sample stay missing.

Vectorized numpy.
The counterpart of ``roadsurf_tpu/io/interp.py``: the same host numpy, so
the same values bit for bit.
"""
from __future__ import annotations

import numpy as np

MISSING = -9999.9

# per-variable missing thresholds (JsonSource.cpp:88-110: > -100 except
# lw_net which uses > -1000)
_THRESH = {"lw_net": -1000.0}


def _valid(name, arr):
    return arr > _THRESH.get(name, -100.0)


def interpolate_series(raw_times: np.ndarray, sim_times: np.ndarray,
                       values: dict, int_names=("prec_phase",)) -> dict:
    """values: {name: [..., R] float}; returns {name: [..., S] float} on the
    sim grid.  Leading axes (e.g. a points axis) are broadcast -- all rows
    share the same raw time axis."""
    raw_times = np.asarray(raw_times, np.int64)
    sim_times = np.asarray(sim_times, np.int64)
    R = raw_times.shape[0]
    S = sim_times.shape[0]
    out = {}

    # bracketing indices
    idx = np.searchsorted(raw_times, sim_times, side="left")
    exact = (idx < R) & (np.take(raw_times, np.clip(idx, 0, R - 1)) == sim_times)
    i0 = np.clip(idx - 1, 0, R - 1)
    i1 = np.clip(idx, 0, R - 1)
    in_range = (idx > 0) & (idx < R)
    # the reference loop stops at rawPos+1 == rawLen, so a sim time exactly at
    # the LAST raw sample is still copied; beyond it, missing
    exact_ok = exact & (idx < R)
    denom = (np.take(raw_times, i1) - np.take(raw_times, i0)).astype(np.float64)
    denom = np.where(denom == 0, 1.0, denom)
    w = (sim_times - np.take(raw_times, i0)).astype(np.float64) / denom
    iex = np.clip(idx, 0, R - 1)

    for name, arr in values.items():
        arr = np.asarray(arr, np.float64)
        res = np.full(arr.shape[:-1] + (S,), MISSING)
        if name in int_names:
            # nearest-next (JsonSource.cpp:171-172); exact match copies
            nxt = arr[..., i1]
            ok = in_range & _valid(name, nxt)
            res = np.where(ok & ~exact_ok, nxt, res)
            ex = arr[..., iex]
            res = np.where(exact_ok & _valid(name, ex), ex, res)
        else:
            v0 = arr[..., i0]
            v1 = arr[..., i1]
            ok = in_range & _valid(name, v0) & _valid(name, v1)
            res = np.where(ok & ~exact_ok, v0 + w * (v1 - v0), res)
            ex = arr[..., iex]
            res = np.where(exact_ok & _valid(name, ex), ex, res)
        out[name] = res
    return out


def interpolate_gap_capped(raw_times: np.ndarray, sim_times: np.ndarray,
                           values: np.ndarray,
                           max_gap_minutes: float = 180.0) -> np.ndarray:
    """RoadSurfSource-style interpolation
    (examples/example2/src/RoadSurfSource.cpp:449-507):

     * an exact time match with a valid value is copied;
     * otherwise the NEAREST VALID samples before/after are found (missing
       rows are skipped, unlike JsonSource's adjacent-only brackets);
     * if the valid bracketing samples are more than ``max_gap_minutes``
       apart, the result is missing (the reference's 180-min cap,
       RoadSurfSource.cpp:555);
     * otherwise linear interpolation between them (the reference weighs in
       whole minutes because querydata times are minute-resolution; seconds
       give identical results for minute-aligned inputs);
     * sim times before the first raw sample are missing (pPos == 0 guard).

    values: [R] floats (missing <= -100); returns [S] floats."""
    raw_times = np.asarray(raw_times, np.int64)
    sim_times = np.asarray(sim_times, np.int64)
    values = np.asarray(values, np.float64)
    R = raw_times.shape[0]
    S = sim_times.shape[0]
    out = np.full(S, MISSING)
    if R == 0:
        return out
    valid = values > -100.0

    # nearest valid raw index at-or-after / at-or-before each raw position
    idx_r = np.arange(R)
    nxt = np.where(valid, idx_r, R)
    nxt = np.minimum.accumulate(nxt[::-1])[::-1]       # next valid >= i
    prv = np.where(valid, idx_r, -1)
    prv = np.maximum.accumulate(prv)                   # prev valid <= i

    pos = np.searchsorted(raw_times, sim_times, side="left")
    exact = (pos < R) & (np.take(raw_times, np.clip(pos, 0, R - 1))
                         == sim_times)
    exact_valid = exact & np.take(valid, np.clip(pos, 0, R - 1))

    # interpolation path (pos > 0 required; RoadSurfSource.cpp:462-463)
    can = (~exact_valid) & (pos > 0)
    p2 = np.take(nxt, np.clip(pos, 0, R - 1))          # first valid >= pos
    p2 = np.where(pos >= R, R, p2)
    p1 = np.take(prv, np.clip(pos - 1, 0, R - 1))      # first valid <= pos-1
    can = can & (p2 < R) & (p1 >= 0)
    p1c = np.clip(p1, 0, R - 1)
    p2c = np.clip(p2, 0, R - 1)
    t1 = np.take(raw_times, p1c)
    t2 = np.take(raw_times, p2c)
    gap_ok = (t2 - t1) <= max_gap_minutes * 60.0
    can = can & gap_ok
    denom = np.where(t2 == t1, 1, t2 - t1).astype(np.float64)
    wgt = (sim_times - t1).astype(np.float64) / denom
    v1 = np.take(values, p1c)
    v2 = np.take(values, p2c)
    out = np.where(can, v1 + wgt * (v2 - v1), out)
    out = np.where(exact_valid, np.take(values, np.clip(pos, 0, R - 1)), out)
    return out
