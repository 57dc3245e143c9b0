"""Frozen copy of ``roadsurf_tpu_torch/io/gridsource.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Gridded forecast source: the npz grid reader and its extraction at
points and onto the simulation times.

The counterpart of ``roadsurf_tpu/io/gridsource.py``, the re-derivation of
example2's QueryDataSource (examples/example2/src/QueryDataSource.cpp):
gridded NWP fields extracted at
arbitrary simulation points by bilinear spatial interpolation
(``InterpolatedValue(pLatLon)``, QueryDataSource.cpp:931) and interpolated in
time onto the simulation grid with the reference's per-variable semantics
(QueryDataSource.cpp:780-880):

 * exact time match copies the value when valid;
 * otherwise linear interpolation between the nearest VALID samples on each
   side (searching over missing samples, QueryDataSource.cpp:331-386),
   rejected when the valid-sample gap exceeds 180 minutes;
 * precipitation phase uses nearest-time instead (no missing search,
   QueryDataSource.cpp:397-425);
 * RH clamped to [0, 100]; precipitation > 100 mm/h treated as missing
   (QueryDataSource.cpp:867-872).

The container format is not FMI querydata (a proprietary binary tied to
newbase); the container is npz: ``times`` [R] (UTC epochs), ``lats`` [ny],
``lons`` [nx] (regular grid, either axis order), and per variable
``[R, ny, nx]`` float arrays keyed by the short names used throughout this
package (tair, tdew, rhz, vz, prec, sw, lw, sw_dir, lw_net, tsurf_obs,
prec_phase).  Values <= -9000 or NaN are missing.

A ``directory`` source merges every ``*.npz`` in the directory along the time
axis, later files overriding earlier ones at duplicate times -- the
NFmiMultiQueryInfo multi-file view (QueryDataSource.cpp:62-66).

Both extractions are the numpy paths (the program's native library is
expression-identical to them and is not part of this copy).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import MISSING

GRID_VARS = ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw", "sw_dir",
             "lw_net", "tsurf_obs", "prec_phase")

MAX_TIME_GAP_MIN = 180      # QueryDataSource.cpp:811


def _is_missing(a):
    return np.isnan(a) | (a <= -9000.0)


def _load_npz_grid(path: str):
    z = np.load(path)
    times = np.asarray(z["times"], np.int64)
    lats = np.asarray(z["lats"], np.float64)
    lons = np.asarray(z["lons"], np.float64)
    fields = {k: np.asarray(z[k], np.float64) for k in z.files
              if k in GRID_VARS}
    return times, lats, lons, fields


def _merge_directory(paths: Sequence[str]):
    """Multi-file time merge; later (newer) files win at duplicate times
    (gridsource.py:59-86)."""
    parts = [_load_npz_grid(p) for p in paths]
    lats, lons = parts[0][1], parts[0][2]
    for t, la, lo, f in parts[1:]:
        if la.shape != lats.shape or lo.shape != lons.shape or \
                not (np.allclose(la, lats) and np.allclose(lo, lons)):
            raise ValueError("grid files in directory have differing grids")
    names = sorted({k for p in parts for k in p[3]})
    all_times = np.concatenate([p[0] for p in parts])
    # stable keep-last per duplicate time, then time-sorted
    uniq: Dict[int, int] = {}
    for i, t in enumerate(all_times):
        uniq[int(t)] = i                       # later file index wins
    keep = np.array(sorted(uniq.items()))      # [K, 2] (time, row)
    times = keep[:, 0].astype(np.int64)
    rows = keep[:, 1]
    ny, nx = len(lats), len(lons)
    fields = {}
    starts = np.cumsum([0] + [len(p[0]) for p in parts])
    for name in names:
        stacked = np.full((len(all_times), ny, nx), MISSING)
        for pi, (t, _, _, f) in enumerate(parts):
            if name in f:
                stacked[starts[pi]:starts[pi + 1]] = f[name]
        fields[name] = stacked[rows]
    return times, lats, lons, fields


def _cell_geometry(lats, lons, plat, plon):
    """(lats ascending, flip, iy, ix, inside, fy, fx): the bilinear cell of
    each point in float64, shared by both extractions."""
    lats = np.asarray(lats, np.float64)
    lons = np.asarray(lons, np.float64)
    flip = len(lats) > 1 and lats[1] < lats[0]
    if flip:
        lats = lats[::-1]
    plat = np.asarray(plat, np.float64)
    plon = np.asarray(plon, np.float64)
    ny, nx = len(lats), len(lons)
    iy = np.clip(np.searchsorted(lats, plat, side="right") - 1, 0, ny - 2)
    ix = np.clip(np.searchsorted(lons, plon, side="right") - 1, 0, nx - 2)
    inside = ((plat >= lats[0]) & (plat <= lats[-1])
              & (plon >= lons[0]) & (plon <= lons[-1]))
    dy = lats[iy + 1] - lats[iy]
    dx = lons[ix + 1] - lons[ix]
    fy = np.where(dy > 0, (plat - lats[iy]) / np.where(dy > 0, dy, 1.0), 0.0)
    fx = np.where(dx > 0, (plon - lons[ix]) / np.where(dx > 0, dx, 1.0), 0.0)
    return flip, iy, ix, inside, fy, fx


def _corners(fy, fx):
    """(cy, cx, weight) of the four cell corners, in corner order."""
    return ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
            (1, 0, fy * (1 - fx)), (1, 1, fy * fx))


def bilinear_at_points(field: np.ndarray, lats: np.ndarray, lons: np.ndarray,
                       plat: np.ndarray, plon: np.ndarray) -> np.ndarray:
    """Bilinear extraction of ``field`` [..., ny, nx] at points [P]
    (gridsource.py:111-157).

    Missing-aware: corner weights are renormalized over valid corners
    (newbase interpolation tolerates missing corners); all-missing or
    out-of-grid points are missing.  Returns [..., P].
    """
    flip, iy, ix, inside, fy, fx = _cell_geometry(lats, lons, plat, plon)
    if flip:
        field = field[..., ::-1, :]
    wsum = acc = None
    for cy, cx, w in _corners(fy, fx):
        v = field[..., iy + cy, ix + cx]                       # [..., P]
        valid = ~_is_missing(v)
        wv = w * valid
        if acc is None:
            acc = np.where(valid, v, 0.0) * w
            wsum = wv
        else:
            acc = acc + np.where(valid, v, 0.0) * w
            wsum = wsum + wv
    ok = (wsum > 1e-12) & inside
    return np.where(ok, acc / np.where(wsum > 1e-12, wsum, 1.0), MISSING)


def nearest_corner_at_points(field: np.ndarray, lats: np.ndarray,
                             lons: np.ndarray, plat: np.ndarray,
                             plon: np.ndarray) -> np.ndarray:
    """Nearest-valid-corner extraction for categorical fields (PrecPhase;
    gridsource.py:160-205): the valid corner with the largest bilinear
    weight wins, ties to the earlier corner.  Returns exact field values.
    """
    flip, iy, ix, inside, fy, fx = _cell_geometry(lats, lons, plat, plon)
    if flip:
        field = field[..., ::-1, :]
    shp = field.shape[:-2] + np.shape(fy)
    best = np.full(shp, MISSING)
    bestw = np.full(shp, -1.0)
    for cy, cx, w in _corners(fy, fx):
        v = field[..., iy + cy, ix + cx]                       # [..., P]
        valid = ~_is_missing(v)
        wb = np.broadcast_to(w, shp)
        upd = valid & (wb > bestw)
        best = np.where(upd, v, best)
        bestw = np.where(upd, wb, bestw)
    return np.where(inside, best, MISSING)


def interpolate_gapped(raw_times: np.ndarray, sim_times: np.ndarray,
                       values: np.ndarray,
                       max_gap_s: float = MAX_TIME_GAP_MIN * 60.0
                       ) -> np.ndarray:
    """Time interpolation with missing-sample search and gap cap
    (QueryDataSource::interpolate, QueryDataSource.cpp:331-386;
    gridsource.py:208-256).

    values: [..., R] on raw_times; returns [..., S] on sim_times.  For each
    sim time: an exact valid match copies; otherwise interpolate between
    the nearest valid sample at or after pos and the nearest valid sample
    before pos, provided their separation <= max_gap_s.
    """
    raw_times = np.asarray(raw_times, np.int64)
    sim_times = np.asarray(sim_times, np.int64)
    values = np.asarray(values, np.float64)
    R = raw_times.shape[0]
    S = sim_times.shape[0]
    valid = ~_is_missing(values)                                # [..., R]
    ridx = np.arange(R)

    # last valid index <= r / first valid index >= r, per row
    last_valid = np.maximum.accumulate(np.where(valid, ridx, -1), axis=-1)
    nxt = np.where(valid, ridx, R)
    next_valid = np.minimum.accumulate(nxt[..., ::-1], axis=-1)[..., ::-1]

    # pos: first raw index with raw_times[pos] >= sim time (ref :791-795)
    pos = np.searchsorted(raw_times, sim_times, side="left")    # [S]
    in_data = pos < R
    posc = np.clip(pos, 0, R - 1)
    exact = in_data & (np.take(raw_times, posc) == sim_times)

    j2 = next_valid[..., posc]                                  # [..., S]
    j1 = last_valid[..., np.clip(posc - 1, 0, R - 1)]
    have = (pos > 0) & in_data & (j2 < R) & (j1 >= 0)
    j2c = np.clip(j2, 0, R - 1)
    j1c = np.clip(j1, 0, R - 1)
    t2 = np.take(raw_times, j2c).astype(np.float64)
    t1 = np.take(raw_times, j1c).astype(np.float64)
    gap = t2 - t1
    have = have & (gap <= max_gap_s)
    v1 = np.take_along_axis(values, j1c, axis=-1)
    v2 = np.take_along_axis(values, j2c, axis=-1)
    w = np.where(gap > 0, (sim_times - t1) / np.where(gap > 0, gap, 1.0), 0.0)
    res = np.where(have, v1 + w * (v2 - v1), MISSING)

    ex = np.take_along_axis(values, np.broadcast_to(
        posc, res.shape[:-1] + (S,)), axis=-1)
    ex_ok = exact & ~_is_missing(ex)
    return np.where(ex_ok, ex, res)


def nearest_gapped(raw_times: np.ndarray, sim_times: np.ndarray,
                   values: np.ndarray,
                   max_gap_s: float = MAX_TIME_GAP_MIN * 60.0) -> np.ndarray:
    """Nearest-time pick with gap cap (QueryDataSource::nearest,
    QueryDataSource.cpp:397-425; gridsource.py:259-287): candidates are
    pos-1/pos only (no missing search; the chosen neighbor may itself be
    missing -- replicated), ties go to the later sample."""
    raw_times = np.asarray(raw_times, np.int64)
    sim_times = np.asarray(sim_times, np.int64)
    values = np.asarray(values, np.float64)
    R = raw_times.shape[0]
    S = sim_times.shape[0]

    pos = np.searchsorted(raw_times, sim_times, side="left")
    in_data = pos < R
    posc = np.clip(pos, 0, R - 1)
    exact = in_data & (np.take(raw_times, posc) == sim_times)
    p1 = np.clip(posc - 1, 0, R - 1)
    gap1 = (sim_times - np.take(raw_times, p1)).astype(np.float64)
    gap2 = (np.take(raw_times, posc) - sim_times).astype(np.float64)
    have = (pos > 0) & in_data & (np.minimum(gap1, gap2) <= max_gap_s)
    pick = np.where(gap1 < gap2, p1, posc)
    v = np.take_along_axis(values, np.broadcast_to(
        pick, values.shape[:-1] + (S,)), axis=-1)
    res = np.where(have, v, MISSING)
    ex = np.take_along_axis(values, np.broadcast_to(
        posc, values.shape[:-1] + (S,)), axis=-1)
    ex_ok = exact & ~_is_missing(ex)
    return np.where(ex_ok, ex, res)


def timeseries_at_points(times, pv: Dict[str, np.ndarray], sim_abs,
                         max_gap_s: float = MAX_TIME_GAP_MIN * 60.0
                         ) -> Dict[str, np.ndarray]:
    """Per-variable raw->sim time interpolation with the reference's clamps
    and the Tdew <-> RH completion (gridsource.py:290-328), shared by the
    production GridExpander's host values.

    pv: spatially-extracted {name: [P, R]} series on ``times``; returns
    {name: [P, S]} on ``sim_abs``: gap-capped linear interpolation (nearest
    for prec_phase, QueryDataSource.cpp:397-425), RH clamp / prec>100
    missing (:867-872), and the completion Magnus relations (:817-828)."""
    out = {}
    for name, series in pv.items():
        if name == "prec_phase":
            v = nearest_gapped(times, sim_abs, series, max_gap_s)
        else:
            v = interpolate_gapped(times, sim_abs, series, max_gap_s)
        if name == "rhz":
            v = np.where(_is_missing(v), v, np.clip(v, 0.0, 100.0))
        if name == "prec":
            v = np.where(v > 100.0, MISSING, v)
        out[name] = v

    tair = out.get("tair")
    if tair is not None:
        from ..physics.moisture import rh_from_tdew, tdew_from_rh
        td = out.get("tdew", np.full_like(tair, MISSING))
        rh = out.get("rhz", np.full_like(tair, MISSING))
        t_ok = ~_is_missing(tair)
        need_td = _is_missing(td) & ~_is_missing(rh) & t_ok
        need_rh = _is_missing(rh) & ~_is_missing(td) & t_ok
        if need_td.any():
            out["tdew"] = np.where(need_td,
                                   np.asarray(tdew_from_rh(tair, rh)), td)
        if need_rh.any():
            out["rhz"] = np.where(need_rh,
                                  np.asarray(rh_from_tdew(tair, td)), rh)
    return out


class GridSource:
    """Gridded forecast/analysis source (the QueryDataSource equivalent;
    gridsource.py:331-388).

    Config: ``{"type": "grid", "path": file.npz | directory/,
    "source": "forecast"|"observations", "params": [optional subset]}``.
    """

    def __init__(self, cfg: dict, sim_times: np.ndarray,
                 is_observation: bool = False):
        self.is_observation = is_observation
        self.sim_times = np.asarray(sim_times, np.int64)
        path = cfg["path"]
        if os.path.isdir(path):
            files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith(".npz"))
            if not files:
                raise FileNotFoundError(f"no .npz grid files in {path}")
            self.times, self.lats, self.lons, self.fields = \
                _merge_directory(files)
        else:
            self.times, self.lats, self.lons, self.fields = \
                _load_npz_grid(path)
        params = cfg.get("params")
        if params:
            self.fields = {k: v for k, v in self.fields.items()
                           if k in set(params)}
        order = np.argsort(self.times, kind="stable")
        self.times = self.times[order]
        self.fields = {k: v[order] for k, v in self.fields.items()}

    def stations(self):
        """A grid has no stations; the point set must come from the config's
        points section (example2 requires a point mode for querydata)."""
        return []

    def latest_valid_time(self, name: str) -> Optional[int]:
        """GetLatestObsTime analogue (DataManager.cpp:85-104): latest raw
        time at which ``name`` has any valid value on the grid."""
        f = self.fields.get(name)
        if f is None:
            return None
        any_valid = ~_is_missing(f).all(axis=(1, 2))
        if not any_valid.any():
            return None
        return int(self.times[np.where(any_valid)[0][-1]])

    def at_points(self, plat, plon) -> Dict[str, np.ndarray]:
        """Extract all fields at points: bilinear in space, then the
        reference's per-variable time interpolation.  Returns
        {name: [P, S]}."""
        pv = {}
        for name, field in self.fields.items():
            interp_sp = (nearest_corner_at_points if name == "prec_phase"
                         else bilinear_at_points)
            pv[name] = np.moveaxis(
                interp_sp(field, self.lats, self.lons, plat, plon), -1, 0)
        return timeseries_at_points(self.times, pv, self.sim_times)
