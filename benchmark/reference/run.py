"""The plain reference forecast of a sample of a cycle's road points.

The runner's scan engine (``roadsurf_tpu_torch/runner.py:run`` without the
kernel engine, frozen here as the rest of this package is): the config's
sources read and merged at the sample's points, each point's read_input
parameters, the initial state from the first step's values with the
cycle's warm-start change applied, and the torch time loop
(``model.scan_steps``, or ``coupling.run_coupled`` with coupling on) over
the whole forecast.  It works everything out again from the generated
input files; it takes no value that the program derived.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams
from .forcing import Calendar, RawForcing
from .io.driver import derive_point_params
from .io.points import nearest_station_forcing, parse_points_full
from .io.skyview import sky_variables
from .io.sources import DataHandler
from .model import Model, scan_steps
from .physics.boundary_layer import BLCount

#: the variables read_input requires at every step (roadrunner.cpp:183-231)
REQUIRED = ("tair", "rhz", "prec", "sw", "lw", "vz")
FIELDS = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
STATE_LEAVES = ("tmp", "tsurf_ave", "wat", "snow", "ice", "ice2", "dep",
                "failed")


class Inputs(NamedTuple):
    """The sample's merged forcing and parameters, shared by every run
    over the same points (they do not depend on the cycle)."""
    settings: ModelSettings
    params: PhysicsParams
    cal: Calendar
    raw: RawForcing            #: numpy [N, T] float64
    pts: object                #: PointParams of numpy [N]


class Forecast(NamedTuple):
    rows: dict                 #: field -> numpy [n_out, N] at ``steps``
    state: dict                #: leaf -> numpy [N, ...] final state
    bl_iters_per_step: float   #: boundary-layer iterations a point-step


def times(config: dict, now: str, dt: float):
    """(start, now, sim_len) from the config's ``time`` block and the
    forecast time ``now``, YYYYMMDDTHHMM (InputSettings.cpp:43-99)."""
    import calendar
    import time as timelib
    tsec = config["time"]
    now = calendar.timegm(timelib.strptime(now, "%Y%m%dT%H%M"))
    start = now - int(tsec.get("analysis", 24)) * 3600
    end = now + int(tsec.get("forecast", 48)) * 3600
    return start, now, 1 + int((end - start) / dt)


def _skip_missing_required(raw: RawForcing) -> RawForcing:
    """A point missing a required variable at any step fails from the
    start (read_input, roadrunner.cpp:183-231)."""
    ok = np.ones(np.asarray(raw.tair).shape[0], bool)
    for name in REQUIRED:
        ok &= ~(np.asarray(getattr(raw, name)) < -9000.0).any(axis=1)
    tair = np.asarray(raw.tair).copy()
    tair[~ok, :] = -9999.9
    return raw._replace(tair=tair)


def inputs(config: dict, now: str, index: np.ndarray) -> Inputs:
    """Read the config's sources and merge them at the points ``index``
    (indices into the config's ``points`` raster), for the forecast time
    ``now``."""
    settings0 = ModelSettings.from_json(config)
    start, now, sim_len = times(config, now, settings0.dt)
    settings = dataclasses.replace(settings0, sim_len=sim_len)
    cal = Calendar.from_start(start, settings.dt, sim_len)
    sim_epochs = start + (np.arange(sim_len) * settings.dt).astype(np.int64)
    handler = DataHandler.from_config(config, sim_epochs)
    pset = parse_points_full(config)
    plats = np.asarray(pset.lats)[index]
    plons = np.asarray(pset.lons)[index]
    radius = float((config.get("points") or {}).get("max_radius_km", 50.0))
    if handler.has_grid_source():
        raw, obs_tair = handler.merged_at_points(plats, plons, sim_len,
                                                 max_radius_km=radius)
    else:
        raw0, obs_tair0 = handler.merged(sim_len)
        locs = handler.locations()
        lats0 = np.array([l[0] for l in locs])
        lons0 = np.array([l[1] for l in locs])
        raw, st_idx = nearest_station_forcing(raw0, lats0, lons0, plats,
                                              plons, max_radius_km=radius)
        obs_tair = np.where(
            (st_idx >= 0)[:, None],
            np.asarray(obs_tair0)[np.clip(st_idx, 0, None)], -9999.9)
    ids = [int(i) + 1 for i in index]
    pcfg = config.get("parameters", {}) or {}
    svf, horizons = sky_variables(ids, pcfg.get("sky_view_file"),
                                  pcfg.get("local_horizon_file"))
    pts, blanked = derive_point_params(
        raw, settings, obs_tair=obs_tair, lat=plats, lon=plons,
        sky_view=svf, horizons=horizons)
    if not settings.use_relaxation:
        pts = pts._replace(init_len=np.full(
            len(ids), 1 + int((now - start) / settings.dt), np.int32))
    raw = _skip_missing_required(raw._replace(tsurf_obs=blanked))
    return Inputs(settings, PhysicsParams.from_json(settings, pcfg), cal,
                  raw, pts)


def forecast(inp: Inputs, warm, steps: np.ndarray,
             dtype: torch.dtype = torch.float64, device="cpu") -> Forecast:
    """The forecast of every point of ``inp``, each from its initial state
    changed by ``warm(state) -> state`` (the cycle's warm start), in
    ``dtype``; the output rows at the 0-based ``steps``."""
    raw = RawForcing(*(torch.as_tensor(np.asarray(x)) if n == "prec_phase"
                       else torch.as_tensor(np.asarray(x, np.float64),
                                            dtype=dtype)
                       for n, x in zip(RawForcing._fields, inp.raw)))
    model = Model(inp.settings, inp.params, device=device)
    prep = model.prepare(raw, inp.pts, inp.cal)
    state = warm(model.init(raw, inp.cal, dtype=dtype))
    pts_t = model.point_tensors(inp.pts)
    steps_t = torch.as_tensor(np.asarray(steps, np.int64))
    with BLCount() as bl:
        if inp.settings.use_coupling:
            from .coupling import run_coupled
            final, out = run_coupled(state, prep, pts_t, inp.settings,
                                     model.cfg, model.grid, model.params)
            rows = {f: out[steps_t, :, i] for i, f in enumerate(FIELDS)}
        else:
            ones = torch.ones(prep.tair.shape, dtype=dtype, device=device)
            final, out = scan_steps(state, prep, ones, ones,
                                    pts_t.coupling_tsurf, model.cfg,
                                    model.grid, model.params)
            rows = {f: getattr(out, f)[steps_t] for f in FIELDS}
    host = lambda x: x.detach().to("cpu", torch.float64).numpy() \
        if x.is_floating_point() else x.detach().cpu().numpy()
    return Forecast(rows={f: host(v) for f, v in rows.items()},
                    state={n: host(getattr(final, n)) for n in STATE_LEAVES},
                    bl_iters_per_step=bl.iters / max(bl.evals, 1))
