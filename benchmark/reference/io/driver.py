"""Frozen copy of ``roadsurf_tpu_torch/io/driver.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Driver-layer input semantics: what example1's read_input does per point
before handing arrays to the physics (examples/example1/src/roadrunner.cpp:157-278).

Derives, from merged per-point forcing:
 * the initialization length (InitLenI) and relaxation anchors,
 * the coupling observation index/value and the in-window obs blanking,
keeping the reference's index conventions (GetLatestObsIndex returns a 1-based
index; the C++ 0-based TSurfObs position is passed to Fortran where it is
consumed as a 1-based step index -- an off-by-one we replicate, see
roadrunner.cpp:258-276 and src/Coupling.f90:511-519).

The counterpart of ``roadsurf_tpu/io/driver.py``; it returns the port's
``state.PointParams`` (host numpy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import ModelSettings, MISSING
from ..state import PointParams, default_point_params


def is_missing(x):
    return np.isnan(x) | (x < -9000.0)


def latest_obs_index(obs_tair: np.ndarray) -> np.ndarray:
    """GetLatestObsIndex (examples/example1/src/JsonSource.cpp:397-414):
    1-based index of the last valid tair in the OBSERVATION source's data,
    -9999 if none.  obs_tair: [P, T]."""
    valid = ~is_missing(obs_tair)
    any_valid = valid.any(axis=-1)
    last0 = obs_tair.shape[-1] - 1 - np.argmax(valid[..., ::-1], axis=-1)
    return np.where(any_valid, last0 + 1, -9999).astype(np.int32)


def coupling_window_from_last(i0, obs_v, settings: ModelSettings):
    """Coupling window fields from the per-point LAST-valid-obs index/value
    (the shared math of the read_input derivation, examples/example1/src/
    roadrunner.cpp:258-276 + src/Coupling.f90:511-519): ``i0`` is the
    0-based sim index of the last valid TSurfObs (-1/-9999 = none), which
    Fortran consumes as the 1-based end step (the replicated off-by-one).

    Returns (coupling_start [P] i32, coupling_end [P] i32,
    coupling_tsurf [P] f64)."""
    i0 = np.asarray(i0)
    cl = int(settings.coupling_minutes * 60 / settings.dt)
    usable = i0 >= cl
    end = np.where(usable, i0, -99).astype(np.int32)
    start = np.where(usable, np.maximum(i0 - cl, 1), -99).astype(np.int32)
    tsurf = np.where(usable, np.asarray(obs_v, np.float64), MISSING)
    return start, end, tsurf


def derive_point_params(raw, settings: ModelSettings,
                        obs_tair: Optional[np.ndarray] = None,
                        lat=None, lon=None, sky_view=None, horizons=None
                        ) -> Tuple[PointParams, np.ndarray]:
    """Replicates read_input (examples/example1/src/roadrunner.cpp:157-278).

    raw: RawForcing with numpy [P, T] arrays (merged across sources).
    obs_tair: the observation source's tair [P, T] (drives the relaxation
    anchor index); None => no obs source => relaxation anchors missing.

    Returns (PointParams, blanked_tsurf_obs [P, T]).
    """
    P, T = np.asarray(raw.tair).shape
    pts = default_point_params(P)
    if lat is not None:
        pts = pts._replace(lat=np.asarray(lat, np.float64))
    if lon is not None:
        pts = pts._replace(lon=np.asarray(lon, np.float64))
    if sky_view is not None:
        pts = pts._replace(sky_view=np.asarray(sky_view, np.float64))
    if horizons is not None:
        pts = pts._replace(horizons=np.asarray(horizons, np.float64))

    # InitLenI default: 1 + analysis_secs/dt (roadrunner.cpp:166-168) -- the
    # caller sets it via settings-level knowledge; here it defaults to the
    # relaxation anchor when available.
    init_len = np.full(P, 1, np.int32)
    tair_relax = np.full(P, MISSING)
    vz_relax = np.full(P, MISSING)
    rh_relax = np.full(P, MISSING)
    if settings.use_relaxation and obs_tair is not None:
        last = latest_obs_index(np.asarray(obs_tair))
        has = last > -1
        init_len = np.where(has, last, init_len).astype(np.int32)
        idx = np.clip(last, 0, T - 1)     # reference reads data[last] (0-based
        rows = np.arange(P)               # read of the 1-based index: one past)
        tair_relax = np.where(has, np.asarray(raw.tair)[rows, idx], MISSING)
        vz_relax = np.where(has, np.asarray(raw.vz)[rows, idx], MISSING)
        rh_relax = np.where(has, np.asarray(raw.rhz)[rows, idx], MISSING)

    # coupling index + obs blanking (roadrunner.cpp:258-276)
    tsurf_obs = np.array(raw.tsurf_obs, np.float64, copy=True)
    coupling_start = np.full(P, -99, np.int32)
    coupling_end = np.full(P, -99, np.int32)
    coupling_tsurf = np.full(P, MISSING)
    if settings.use_coupling:
        cl = int(settings.coupling_minutes * 60 / settings.dt)
        valid = ~(is_missing(tsurf_obs) | (tsurf_obs < -100.0))
        any_valid = valid.any(axis=-1)
        i0 = T - 1 - np.argmax(valid[..., ::-1], axis=-1)   # C++ 0-based i
        i0 = np.where(any_valid, i0, -1)
        obs_v = tsurf_obs[np.arange(P), np.clip(i0, 0, T - 1)]
        coupling_start, coupling_end, coupling_tsurf = \
            coupling_window_from_last(i0, obs_v, settings)
        usable = coupling_end >= 1
        # blank obs rows (i0-cl, i0] (roadrunner.cpp:269-275)
        cols = np.arange(T)[None, :]
        blank = (usable[:, None] & (cols <= i0[:, None])
                 & (cols > (i0 - cl)[:, None]))
        tsurf_obs = np.where(blank, -9999.9, tsurf_obs)

    pts = pts._replace(init_len=init_len, tair_relax=tair_relax,
                       vz_relax=vz_relax, rh_relax=rh_relax,
                       coupling_start=coupling_start,
                       coupling_end=coupling_end,
                       coupling_tsurf=coupling_tsurf)
    return pts, tsurf_obs
