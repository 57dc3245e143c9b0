"""Frozen copy of ``roadsurf_tpu_torch/io/points.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Point modes: where the simulation points come from.

Re-derivation of example2's PointMode dispatch
(examples/example2/src/PointMode.cpp:3-25, roadrunner.cpp:779-792):

 * ``stations``    -- points are the input sources' stations (example1 mode);
 * ``coordinate``  -- a single lat/lon;
 * ``coordinates`` -- an explicit list of lat/lon pairs;
 * ``grid``        -- a regular lat/lon grid over a bounding box, optionally
                      filtered by an ASCII character mask
                      (roadrunner.cpp:331-408).

Non-station points take their forcing from the nearest source station within
a radius -- the NearTree pattern of RoadSurfSource
(examples/example2/src/RoadSurfSource.cpp:516-616) applied to all variables.

The counterpart of ``roadsurf_tpu/io/points.py``: the same host numpy, so the
same values bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..forcing import RawForcing

EARTH_R_KM = 6371.0


def haversine_km(lat1, lon1, lat2, lon2):
    """Great-circle distance; inputs degrees, broadcastable."""
    la1, lo1, la2, lo2 = map(np.radians, (lat1, lon1, lat2, lon2))
    a = (np.sin((la2 - la1) / 2.0) ** 2
         + np.cos(la1) * np.cos(la2) * np.sin((lo2 - lo1) / 2.0) ** 2)
    return 2.0 * EARTH_R_KM * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


class PointSet:
    """Resolved simulation point set; grid mode keeps the grid descriptor
    (axes + keep mask) so outputs can be written back onto the grid."""

    def __init__(self, mode, lats, lons, grid_lats=None, grid_lons=None,
                 keep=None):
        self.mode = mode
        self.lats = lats
        self.lons = lons
        self.grid_lats = grid_lats     # [ny] | None
        self.grid_lons = grid_lons     # [nx] | None
        self.keep = keep               # [ny, nx] bool | None


def parse_points_full(config: dict) -> PointSet:
    """Resolve the config 'points' section (example2 PointMode dispatch,
    examples/example2/src/PointMode.cpp:3-25); mode 'stations' yields empty
    arrays (points come from the sources).

    Grid masks (roadrunner.cpp:241-268): ``{"path": grid.txt, "include"}`` is
    an ASCII character mask; ``{"path": grid.npz, "enable": formula}`` is an
    expression mask over the file's static fields (read_querydata_mask,
    roadrunner.cpp:272-323)."""
    sec = config.get("points")
    if not sec:
        return PointSet("stations", np.array([]), np.array([]))
    if "latlon" in sec:                      # single coordinate
        lat, lon = sec["latlon"]
        return PointSet("coordinate", np.array([float(lat)]),
                        np.array([float(lon)]))
    if "coordinates" in sec:
        arr = np.asarray(sec["coordinates"], np.float64)
        return PointSet("coordinates", arr[:, 0], arr[:, 1])
    if "grid" in sec:
        g = sec["grid"]
        lat1, lon1, lat2, lon2 = g["bbox"]
        ny, nx = int(g.get("ny", 10)), int(g.get("nx", 10))
        lats = np.linspace(lat1, lat2, ny)
        lons = np.linspace(lon1, lon2, nx)
        glat, glon = np.meshgrid(lats, lons, indexing="ij")
        keep = np.ones(glat.shape, bool)
        mask_cfg = sec.get("mask") or g.get("mask")
        if mask_cfg:
            if "enable" in mask_cfg:
                from .masks import expression_mask
                keep = expression_mask(
                    mask_cfg["enable"], mask_cfg["path"],
                    glat.ravel(), glon.ravel()).reshape(ny, nx)
            else:
                keep = read_ascii_mask(mask_cfg["path"], ny, nx,
                                       mask_cfg.get("include", "1"))
        return PointSet("grid", glat[keep].ravel(), glon[keep].ravel(),
                        grid_lats=lats, grid_lons=lons, keep=keep)
    raise ValueError("Unrecognized 'points' section")


def parse_points(config: dict):
    """Returns (mode, lats [P], lons [P]); see parse_points_full."""
    ps = parse_points_full(config)
    return ps.mode, ps.lats, ps.lons


def read_ascii_mask(path: str, ny: int, nx: int, include: str) -> np.ndarray:
    """ASCII character-grid mask (examples/example2/src/roadrunner.cpp:331-408):
    row-per-line character grid; a cell is kept iff its character is in
    ``include``."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                rows.append([c in include for c in line[:nx]])
    m = np.zeros((ny, nx), bool)
    for i, r in enumerate(rows[:ny]):
        m[i, :len(r)] = r
    return m


def nearest_station_index(st_lats, st_lons, lats, lons,
                          max_radius_km: float = 50.0) -> np.ndarray:
    """Nearest-station index per point within ``max_radius_km``; -1 when no
    station is in range (the NearTree radius pattern,
    examples/example2/src/RoadSurfSource.cpp:516-616).  The production engine
    ships this index to device and expands station forcing to points there
    (production.StationExpander) -- the [P, T] tensor never materializes."""
    st_lats = np.asarray(st_lats, np.float64)
    st_lons = np.asarray(st_lons, np.float64)
    lats = np.asarray(lats, np.float64)
    lons = np.asarray(lons, np.float64)
    if len(st_lats) == 0 or len(lats) == 0:
        return np.full(len(lats), -1, np.int64)
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if cKDTree is not None and len(st_lats) >= 8:
        # nearest by 3D chord distance == nearest great-circle (monotonic);
        # the radius check stays in haversine km for exact threshold parity.
        # On exact/near-exact distance ties the KD-tree's winner may differ
        # from the brute-force path's lowest-index argmin (float rounding,
        # implementation-defined tie order) -- accepted: the reference's
        # NearTree makes no tie promise either (ex2/RoadSurfSource.cpp:542)
        def unit(lat, lon):
            la, lo = np.radians(lat), np.radians(lon)
            cl = np.cos(la)
            return np.stack([cl * np.cos(lo), cl * np.sin(lo),
                             np.sin(la)], axis=1)
        _, idx = cKDTree(unit(st_lats, st_lons)).query(unit(lats, lons))
        d = haversine_km(lats, lons, st_lats[idx], st_lons[idx])
        return np.where(d <= max_radius_km, idx, -1).astype(np.int64)
    # blocked over points to bound the [Pb, S] distance matrix at large P
    out = np.empty(len(lats), np.int64)
    blk = max(1, min(len(lats), 2_000_000 // max(len(st_lats), 1)))
    for i0 in range(0, len(lats), blk):
        sl = slice(i0, i0 + blk)
        d = haversine_km(lats[sl, None], lons[sl, None],
                         st_lats[None, :], st_lons[None, :])
        idx = np.argmin(d, axis=1)
        ok = d[np.arange(len(idx)), idx] <= max_radius_km
        out[sl] = np.where(ok, idx, -1)
    return out


def nearest_station_forcing(raw: RawForcing, st_lats, st_lons, lats, lons,
                            max_radius_km: float = 50.0
                            ) -> Tuple[RawForcing, np.ndarray]:
    """Map station-keyed forcing [S, T] to arbitrary points [P, T] via
    nearest station within ``max_radius_km``; points with no station in range
    get fully-missing forcing (-> skipped by the required-var validation).

    Returns (RawForcing [P, T], station_index [P] with -1 for out-of-range).
    """
    idx = nearest_station_index(st_lats, st_lons, lats, lons, max_radius_km)
    ok = idx >= 0
    idx_eff = np.where(ok, idx, 0)

    def take(x, fill):
        out = np.asarray(x)[idx_eff]
        out = np.where(ok[:, None], out, fill)
        return out

    mapped = RawForcing(
        tair=take(raw.tair, -9999.9), tdew=take(raw.tdew, -9999.9),
        vz=take(raw.vz, -9999.9), rhz=take(raw.rhz, -9999.9),
        prec=take(raw.prec, -9999.9), sw=take(raw.sw, -9999.9),
        lw=take(raw.lw, -9999.9), sw_dir=take(raw.sw_dir, -9999.9),
        lw_net=take(raw.lw_net, -9999.9),
        tsurf_obs=take(raw.tsurf_obs, -9999.9),
        prec_phase=take(raw.prec_phase, -9999).astype(np.int64))
    return mapped, np.where(ok, idx, -1)
