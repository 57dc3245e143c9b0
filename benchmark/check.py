"""The comparison that decides ``correct``.

Every point of a cycle is an answer of its own (points are independent),
so a run keeps, from every cycle of its window, the output rows and the
final state of a few points drawn from the seed, and after the window the
plain reference (``reference/``) forecasts those points again from the
generated input files, each from its cycle's warm start.  The numbers
compared are the widest gaps over the kept points:

* ``tsurf_K``: road-surface temperature in the output rows (K);
* ``tsurf_rms_K``: the root mean square of the same gaps over every kept
  row and point (K), steady where the widest gap swings with the rare
  point that a rounding tips over a threshold;
* ``storage_mm``: water, snow, ice, secondary ice and deposit in the
  output rows (mm);
* ``profile_K``: the final ground temperature profile (K);
* ``failed_points``: points whose failure flag differs (exact: 0).

A missing or non-finite value on one side only is an infinite gap.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple

import numpy as np

FIELDS = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
STORAGES = ("wat", "snow", "ice", "ice2", "dep")
NUMBERS = ("tsurf_K", "tsurf_rms_K", "storage_mm", "profile_K",
           "failed_points")


class Kept(NamedTuple):
    """What one cycle produced at its kept points."""
    cycle: int
    index: np.ndarray          #: [k] point indices
    rows: Dict[str, np.ndarray]  #: field -> [n_out, k]
    state: Dict[str, np.ndarray]  #: leaf -> [k, ...]
    draws: Dict[str, np.ndarray]  #: the warm start's draws, [k]
    steps: np.ndarray          #: [n_out] 0-based steps of the rows


def sample_points(seed: int, cycle: int, n_points: int, k: int):
    """``k`` distinct point indices of cycle ``cycle``, drawn from the seed."""
    rng = np.random.default_rng([abs(int(seed)), int(cycle), 1])
    return np.sort(rng.choice(n_points, size=min(k, n_points),
                              replace=False))


def keep(cycle: int, index: np.ndarray, res, draws) -> Kept:
    """The kept points of a cycle's ``ProductionResult`` ``res``."""
    leaves = ("tmp", "tsurf_ave", "wat", "snow", "ice", "ice2", "dep",
              "failed")
    host = lambda x: np.asarray(x.detach().cpu().numpy()
                                if hasattr(x, "detach") else x)
    return Kept(cycle, index,
                {f: np.array(res.fields[f][:, index], np.float64)
                 for f in FIELDS},
                {n: np.array(host(getattr(res.state, n))[index])
                 for n in leaves},
                {n: host(v)[index].copy() for n, v in draws.items()},
                np.asarray(res.out_steps, np.int64).copy())


def thin(kept: List[Kept], max_points: int, seed: int) -> List[Kept]:
    """At most ``max_points`` kept points over all cycles, the cycles kept
    drawn evenly from the seed where there are more."""
    per = max(len(kept[0].index), 1) if kept else 1
    n_cyc = max(1, max_points // per)
    if len(kept) <= n_cyc:
        return kept
    rng = np.random.default_rng([abs(int(seed)), 2])
    pick = np.sort(rng.choice(len(kept), size=n_cyc, replace=False))
    return [kept[i] for i in pick]


def columns(kept: List[Kept]):
    """(point index [N], draws {name: [N]}) of all kept points in order."""
    index = np.concatenate([k.index for k in kept])
    draws = {n: np.concatenate([k.draws[n] for k in kept])
             for n in kept[0].draws}
    return index, draws


def _gap(a, b) -> float:
    """The widest |a - b|, where a value missing (<= -9000) or not finite
    on one side only is an infinite gap."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    bad_a = ~np.isfinite(a) | (a <= -9000.0)
    bad_b = ~np.isfinite(b) | (b <= -9000.0)
    if np.any(bad_a != bad_b):
        return float("inf")
    both = ~bad_a
    if not both.any():
        return 0.0
    return float(np.max(np.abs(a[both] - b[both])))


def compare(kept: List[Kept], rows: Dict[str, np.ndarray],
            state: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers compared, between the program's kept points and the
    reference's ``rows`` ({field: [n_out, N]}) and final ``state``
    ({leaf: [N, ...]}), N the kept points in order."""
    got_rows = {f: np.concatenate([k.rows[f] for k in kept], axis=1)
                for f in FIELDS}
    got_state = {n: np.concatenate([k.state[n] for k in kept])
                 for n in kept[0].state}
    return compare_arrays(got_rows, got_state, rows, state)


def _rms(a, b) -> float:
    """The root mean square of a - b where both sides hold a value; an
    infinite gap where one side only does."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    bad_a = ~np.isfinite(a) | (a <= -9000.0)
    bad_b = ~np.isfinite(b) | (b <= -9000.0)
    if np.any(bad_a != bad_b):
        return float("inf")
    both = ~bad_a
    if not both.any():
        return 0.0
    return float(np.sqrt(np.mean((a[both] - b[both]) ** 2)))


def compare_arrays(got_rows, got_state, rows, state) -> Dict[str, float]:
    """The numbers compared between two sides' rows and final states."""
    return {
        "tsurf_K": max(_gap(got_rows["tsurf"], rows["tsurf"]),
                       _gap(got_state["tsurf_ave"], state["tsurf_ave"])),
        "tsurf_rms_K": _rms(got_rows["tsurf"], rows["tsurf"]),
        "storage_mm": max(max(_gap(got_rows[f], rows[f]),
                              _gap(got_state[f], state[f]))
                          for f in STORAGES),
        "profile_K": _gap(got_state["tmp"], state["tmp"]),
        "failed_points": float(np.sum(
            got_state["failed"].astype(bool) != state["failed"].astype(bool))),
    }


def load_limits(bench_dir: str, workload: str) -> Dict[str, float]:
    """The limits of a cell (``checks/<workload>.json``)."""
    with open(os.path.join(bench_dir, "checks", f"{workload}.json")) as f:
        doc = json.load(f)
    return {n: float(doc["limits"][n]) for n in NUMBERS}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN is over it)."""
    return all(numbers[n] <= limits[n] for n in NUMBERS)
