"""A deployment's set-up through the program's own pieces, and its cycles.

The composition of ``roadsurf_tpu_torch.runner.run_production_config``
(the data plane, the expanders, the CheckValues screen, the coupling
windows, the relaxation anchors and the initial state), with a span
around each call and without the output files, so that a cycle is one
call of the engine entry that the runner's kernel engine calls
(``production.run_production_coupled`` with coupled points, else
``production.run_production``).  It reads only the program's public
entries.
"""
from __future__ import annotations

import calendar
import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch


class Spans:
    """Host-clock seconds of named spans, summed per name."""

    def __init__(self):
        self.s = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] = (self.s.get(name, 0.0)
                            + time.perf_counter() - t0)


def times(config: dict, now: str, dt: float):
    """(start, now, sim_len) from the config's ``time`` block and the
    forecast time ``now`` (YYYYMMDDTHHMM), as ``runner.build_times``."""
    t_now = calendar.timegm(time.strptime(now, "%Y%m%dT%H%M"))
    tsec = config.get("time", {})
    start = t_now - int(tsec.get("analysis", 24)) * 3600
    end = t_now + int(tsec.get("forecast", 48)) * 3600
    return start, t_now, 1 + int((end - start) / dt)


class Deployment(NamedTuple):
    """What a cycle is called with: the runner's arguments to its engine."""
    model: object
    expander: object
    pts: object              #: PointParams, numpy [P]
    cal: object
    state0: object           #: State on the card, the cold start
    anchors: Optional[tuple]
    devices: list
    chunk_t: int
    coupled: bool            #: a coupled run (the runner's ``use_coupled``)
    n_points: int
    settings: object
    grid_fields: tuple       #: the NWP grids' fields, sorted; () without


def build(config: dict, now: str, device: torch.device,
          spans: Spans) -> Deployment:
    """Read the config's sources and build everything a cycle needs, as
    ``runner.run_production_config`` does (runner.py:419-718), without
    its prints and files."""
    from roadsurf_tpu_torch import production
    from roadsurf_tpu_torch.config import ModelSettings, PhysicsParams
    from roadsurf_tpu_torch.forcing import Calendar, relax_anchors
    from roadsurf_tpu_torch.io.driver import (coupling_window_from_last,
                                              derive_point_params,
                                              latest_obs_index)
    from roadsurf_tpu_torch.io.points import (nearest_station_index,
                                              parse_points_full)
    from roadsurf_tpu_torch.io.skyview import sky_variables
    from roadsurf_tpu_torch.io.sources import DataHandler
    from roadsurf_tpu_torch.model import Model
    from roadsurf_tpu_torch.parallel import sharding
    from roadsurf_tpu_torch.runner import REQUIRED, SCAN_CHUNK_T
    from roadsurf_tpu_torch.state import PointParams, init_state

    settings0 = ModelSettings.from_json(config)
    start, t_now, sim_len = times(config, now, settings0.dt)
    settings = dataclasses.replace(settings0, sim_len=sim_len)
    cal = Calendar.from_start(start, settings.dt, sim_len)
    sim_epochs = start + (np.arange(sim_len) * settings.dt).astype(np.int64)

    with spans.span("data_plane"):
        with spans.span("data_plane.sources"):
            handler = DataHandler.from_config(config, sim_epochs)
        with spans.span("data_plane.points"):
            pset = parse_points_full(config)
            if pset.mode == "stations":
                locs = handler.locations()
                lats = np.array([l[0] for l in locs])
                lons = np.array([l[1] for l in locs])
                point_ids = handler.point_ids()
            else:
                lats, lons = pset.lats, pset.lons
                point_ids = list(range(1, len(lats) + 1))
        grid_srcs = [(i, s) for i, s in enumerate(handler.sources)
                     if hasattr(s, "at_points")]
        station_srcs = [s for s in handler.sources
                        if not hasattr(s, "at_points")]
        grid_has_obsts = any("tsurf_obs" in s.fields for _, s in grid_srcs)
        sub = DataHandler(station_srcs)
        have_st = bool(station_srcs) and bool(sub.point_ids())
        P = len(point_ids)
        anchors_st = None
        with spans.span("data_plane.stations"):
            if have_st:
                raw_st, obs_tair_st = sub.merged(sim_len)
                locs = sub.locations()
                st_lats = np.array([l[0] for l in locs])
                st_lons = np.array([l[1] for l in locs])
                if pset.mode == "stations":
                    st_idx = np.arange(P, dtype=np.int64)
                else:
                    radius = float((config.get("points") or {}).get(
                        "max_radius_km", 50.0))
                    st_idx = nearest_station_index(st_lats, st_lons, lats,
                                                   lons, radius)
                pts_st, blanked_st = derive_point_params(
                    raw_st, settings, obs_tair=obs_tair_st)
                if not (settings.use_coupling and grid_has_obsts):
                    raw_st = raw_st._replace(tsurf_obs=blanked_st)
                if not grid_srcs:
                    raw_st = _skip_missing_required(raw_st, REQUIRED)
                anchors_st = (relax_anchors(raw_st, pts_st)
                              if settings.use_relaxation else None)
                ok = st_idx >= 0
                ie = np.where(ok, st_idx, 0)
                g = lambda a, fill: np.where(ok, np.asarray(a)[ie], fill)
            else:
                st_idx = np.full(P, -1, np.int64)
        with spans.span("data_plane.params"):
            pcfg = config.get("parameters", {}) or {}
            svf, horizons = sky_variables(point_ids,
                                          pcfg.get("sky_view_file"),
                                          pcfg.get("local_horizon_file"))
            default_init = 1 + int((t_now - start) / settings.dt)
            names_r = ("tair_relax", "vz_relax", "rh_relax", "coupling_tsurf")
            if have_st:
                init_len = (g(pts_st.init_len, 1).astype(np.int32)
                            if settings.use_relaxation
                            else np.full(P, default_init, np.int32))
                relax = {n: g(getattr(pts_st, n), -9999.9) for n in names_r}
                cpl = {n: g(getattr(pts_st, n), -99).astype(np.int32)
                       for n in ("coupling_start", "coupling_end")}
            else:
                init_len = np.full(P, default_init, np.int32)
                relax = {n: np.full(P, -9999.9) for n in names_r}
                cpl = {n: np.full(P, -99, np.int32)
                       for n in ("coupling_start", "coupling_end")}
            pts = PointParams(
                lat=np.asarray(lats, np.float64),
                lon=np.asarray(lons, np.float64),
                sky_view=np.asarray(svf, np.float64),
                horizons=np.asarray(horizons, np.float64),
                init_len=init_len, out_depth=np.full(P, -9999.9), **relax,
                **cpl)
            anchors = (tuple(np.asarray(g(a, -9999.9)) for a in anchors_st)
                       if anchors_st is not None else None)
            if settings.use_relaxation and anchors is None:
                anchors = tuple(np.full(P, -9999.9) for _ in range(3))
            model = Model(settings, PhysicsParams.from_json(settings, pcfg),
                          device=device)

    with spans.span("init"):
        mesh = sharding.make_mesh([device] if device.type == "cpu" else None)
        exp_dev = mesh.devices[0]
        p_pad = production.padded_points(P, len(mesh))
        chunk_t = production.auto_chunk_t(p_pad)
        parts, gexp_by_src = [], {}
        with spans.span("init.expanders"):
            skyview_any = production.sky_route(pts)[0]
            if have_st:
                st_idx_pad = np.pad(np.asarray(st_idx), (0, p_pad - P),
                                    constant_values=-1)
                st_pos = min(i for i, s in enumerate(handler.sources)
                             if not hasattr(s, "at_points"))
                prep_ctx = None
                if not grid_srcs and not skyview_any:
                    prep_ctx = _station_prep_ctx(
                        pts_st, anchors_st, st_lats, settings, model, cal,
                        sim_len, default_init, PointParams)
                parts.append((st_pos, production.StationExpander(
                    raw_st, st_idx_pad, exp_dev, chunk_t=chunk_t,
                    prep_ctx=prep_ctx)))
            if grid_srcs:
                lat_pad, lon_pad = (
                    np.pad(np.asarray(a, np.float64), (0, p_pad - P),
                           mode="edge") for a in (lats, lons))
                for i, s in grid_srcs:
                    gexp = production.GridExpander(
                        s.times, s.lats, s.lons, s.fields, lat_pad, lon_pad,
                        sim_epochs, exp_dev, chunk_t=chunk_t)
                    gexp_by_src[i] = gexp
                    parts.append((i, gexp))
            parts = [p for _, p in sorted(parts, key=lambda t: t[0])]
            expander = (parts[0] if len(parts) == 1
                        else production.CompositeExpander(parts))
        if grid_srcs:
            with spans.span("init.screen"):
                production.validation_counts(expander, sim_len,
                                             chunk_t=SCAN_CHUNK_T, n_real=P)
        if settings.use_coupling and grid_has_obsts:
            with spans.span("init.coupling_windows"):
                lv = production.last_valid_scan(
                    expander, sim_len, chunk_t=SCAN_CHUNK_T,
                    names=("tsurf_obs",), n_real=P)
                i0, obs_v = lv["tsurf_obs"]
                cs, ce, ct_obs = coupling_window_from_last(i0, obs_v,
                                                           settings)
                pts = pts._replace(coupling_start=cs, coupling_end=ce,
                                   coupling_tsurf=ct_obs)
        if grid_srcs and settings.use_relaxation:
            with spans.span("init.relaxation"):
                pts, anchors = _grid_relaxation(
                    expander, gexp_by_src, grid_srcs, pts, sim_len, P,
                    (g(latest_obs_index(obs_tair_st), -9999).astype(np.int64)
                     if have_st else np.full(P, -9999, np.int64)),
                    production, SCAN_CHUNK_T)
        with spans.span("init.state"):
            date0 = (int(cal.year[0]), int(cal.month[0]), int(cal.day[0]))
            first = lambda name: torch.tensor(
                np.asarray(expander.first_host[name][:P], np.float32),
                device=exp_dev)
            state0 = init_state(settings, model.params, model.grid,
                                first("tair"), first("vz"), first("rhz"),
                                first("tsurf_obs"), date0,
                                depth_idx=model.cfg.depth_idx,
                                depth_w=model.cfg.depth_w,
                                use_depth=model.cfg.use_depth)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    coupled = bool(settings.use_coupling) and bool(np.any(
        (np.asarray(pts.coupling_end) >= 1)
        & (np.asarray(pts.coupling_tsurf) > -100.0)))
    grid_fields = tuple(sorted({n for _, s in grid_srcs for n in s.fields}))
    return Deployment(model, expander, pts, cal, state0, anchors,
                      mesh.devices, chunk_t, coupled, P, settings,
                      grid_fields)


def _skip_missing_required(raw, required):
    """A station missing a required variable at any step poisons its tair,
    so its points fail (runner.py:114-136, without the report)."""
    ok = np.ones(np.asarray(raw.tair).shape[0], bool)
    for name in required:
        ok &= ~(np.asarray(getattr(raw, name)) < -9000.0).any(axis=1)
    tair = np.asarray(raw.tair).copy()
    tair[~ok, :] = -9999.9
    return raw._replace(tair=tair)


def _station_prep_ctx(pts_st, anchors_st, st_lats, settings, model, cal,
                      sim_len, default_init, PointParams):
    """The station-rank preparation context of the K2 fast path, with the
    virtual station row (rank S+1) of the out-of-radius points
    (runner.py:509-543)."""
    S = len(st_lats)
    app = lambda a, fill, dt=None: np.concatenate(
        [np.asarray(a, dt), np.asarray([fill], dt)])
    il1 = (app(pts_st.init_len, 1, np.int32) if settings.use_relaxation
           else np.full(S + 1, default_init, np.int32))
    st_pts1 = PointParams(
        lat=np.zeros(S + 1), lon=np.zeros(S + 1), sky_view=np.ones(S + 1),
        horizons=np.zeros((S + 1, 1)), init_len=il1,
        tair_relax=app(pts_st.tair_relax, -9999.9),
        vz_relax=app(pts_st.vz_relax, -9999.9),
        rh_relax=app(pts_st.rh_relax, -9999.9),
        coupling_start=app(pts_st.coupling_start, -99, np.int32),
        coupling_end=app(pts_st.coupling_end, -99, np.int32),
        coupling_tsurf=app(pts_st.coupling_tsurf, -9999.9),
        out_depth=np.full(S + 1, -9999.9))
    anch1 = (tuple(app(a, -9999.9) for a in anchors_st)
             if anchors_st is not None else None)
    return {"st_pts": st_pts1, "anchors": anch1, "settings": settings,
            "params": model.params, "hour": cal.hour, "t_total": sim_len}


def _grid_relaxation(expander, gexp_by_src, grid_srcs, pts, sim_len, P,
                     last_p, production, scan_chunk_t):
    """The relaxation fields from the merged overlay of grid and station
    values (runner.py:617-683): the anchor step is the latest observation
    over every observation source, the values the overlay's there."""

    def merged_at(step_p, names):
        out_v = {n: np.full(P, -9999.9) for n in names}
        vp = step_p >= 0
        uniq = np.unique(step_p[vp])
        rows = np.arange(P)
        for lo_u in range(0, len(uniq), 64):
            sel = uniq[lo_u:lo_u + 64]
            met = expander.host_at(sel, names)
            j = np.searchsorted(sel, np.clip(step_p, sel[0], None))
            hit = vp & (j < len(sel))
            jc = np.clip(j, 0, len(sel) - 1)
            hit &= sel[jc] == np.where(vp, step_p, -1)
            for n in names:
                out_v[n] = np.where(hit, met[n][:P][rows, jc], out_v[n])
        return out_v

    for i, s in grid_srcs:
        if not s.is_observation or "tair" not in s.fields:
            continue
        lvg = production.last_valid_scan(
            gexp_by_src[i], sim_len, chunk_t=scan_chunk_t, names=("tair",),
            n_real=P)
        li0 = lvg["tair"][0].astype(np.int64)
        last_p = np.maximum(last_p, np.where(li0 >= 0, li0 + 1, -9999))
    has_p = last_p > -1
    init_len = np.where(has_p, last_p, 1).astype(np.int32)
    vals_r = merged_at(np.where(has_p, np.clip(last_p, 0, sim_len - 1), -1),
                       ("tair", "vz", "rhz"))
    idx_a = np.clip(init_len.astype(np.int64) - 1, 0, sim_len - 1)
    vals_a = merged_at(idx_a, ("tair", "vz", "rhz"))
    vz_a = np.where(idx_a == 0, np.maximum(vals_a["vz"], 0.4), vals_a["vz"])
    pts = pts._replace(
        init_len=init_len,
        tair_relax=np.where(has_p, vals_r["tair"], -9999.9),
        vz_relax=np.where(has_p, vals_r["vz"], -9999.9),
        rh_relax=np.where(has_p, vals_r["rhz"], -9999.9))
    return pts, (vals_a["tair"], vz_a, vals_a["rhz"])


def cycle(dep: Deployment, state, metrics):
    """One forecast cycle from ``state``: the engine entry the runner's
    kernel engine calls, its rows and final state in host memory
    (``ProductionResult``)."""
    from roadsurf_tpu_torch import production
    run_fn = (production.run_production_coupled if dep.coupled
              else production.run_production)
    return run_fn(dep.model, dep.expander, dep.pts, dep.cal, state,
                  anchors=dep.anchors, devices=dep.devices,
                  chunk_t=dep.chunk_t, metrics=metrics, drain="gather")
