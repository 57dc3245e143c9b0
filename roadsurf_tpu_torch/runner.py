"""CLI runner: the example1 ``roadrunner`` equivalent, batched on the card.

The counterpart of ``roadsurf_tpu/runner.py``.  Replicates the reference
driver flow (examples/example1/src/roadrunner.cpp): config JSON ->
simulation times -> data sources -> per-point read_input semantics ->
simulation -> JSON output -- except the per-point WorkQueue thread pool
becomes one batched device run over all points (optionally over several
point blocks, devices and processes), and warm-start state checkpoints
replace re-initialization.

Usage:
    roadsurf-tpu-torch -c config.json [-t YYYYMMDDTHHMM] [-o out.json]
        [--checkpoint-in ck.npz] [--checkpoint-out ck.npz]
        [--device cuda|cpu] [--engine auto|scan|kernel]
    python -m roadsurf_tpu_torch.runner ...   (the same)
    roadsurf-tpu-torch merge-shards merged.npz out.npz.shard*.npz

Config format == example1's example_config.json (time/model/parameters/
output/input sections; missing_limit budget honored) and example2's point
modes (``points``: coordinate, coordinates, grid with masks).

Engines: ``kernel`` streams the forecast through the hand-written CUDA
whole-scan kernel (``production.run_production``; the JAX package's
``pallas`` engine, a name accepted here too); ``scan`` runs the torch time
loop (``Model.run``) over the whole [P, T] forcing.  ``auto`` takes the
kernel engine on the card and the scan engine on the CPU, by the device the
caller names; nothing probes for a card to choose the CPU, and the default
device, the card, raises where there is none.
"""
from __future__ import annotations

import argparse
import calendar
import contextlib
import dataclasses
import sys
import time as timelib
from typing import Optional

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams
from .forcing import Calendar, RawForcing
from .io.driver import derive_point_params
from .io.skyview import sky_variables
from .io.sources import DataHandler, read_json_tolerant
from .io.writer import restore_state, save_checkpoint, write_forecast_json
from .model import Model

#: engine names -> the engine they run (``pallas``: the JAX package's name)
ENGINES = {"auto": "auto", "scan": "scan", "kernel": "kernel",
           "pallas": "kernel"}

#: the variables read_input requires at every step (roadrunner.cpp:183-231)
REQUIRED = ("tair", "rhz", "prec", "sw", "lw", "vz")

#: the longest window of the merged-forcing scans (the CheckValues screen,
#: the merged obs windows): ``production.validation_counts`` and
#: ``last_valid_scan`` take at most the expander's own chunk, and 64 steps
#: keep a window's 11 channels near 3 GB at 1M points whatever the run's
#: chunk (a grid's interpolated values may differ by an ulp between window
#: lengths, as between chunk lengths)
SCAN_CHUNK_T = 64


def parse_forecast_time(s: str) -> int:
    return calendar.timegm(timelib.strptime(s, "%Y%m%dT%H%M"))


def build_times(config: dict, forecast_time: Optional[int], dt: float):
    """InputSettings time arithmetic
    (examples/example1/src/InputSettings.cpp:43-99): start = now - analysis_h,
    end = now + forecast_h, SimLen = 1 + total/dt."""
    tsec = config.get("time", {})
    if forecast_time is None:
        now_s = tsec.get("now")
        if now_s:
            forecast_time = parse_forecast_time(now_s)
        else:
            forecast_time = int(timelib.time()) // 60 * 60
    analysis_h = int(tsec.get("analysis", 24))
    forecast_h = int(tsec.get("forecast", 48))
    start = forecast_time - analysis_h * 3600
    end = forecast_time + forecast_h * 3600
    sim_len = 1 + int((end - start) / dt)
    return start, forecast_time, sim_len


def check_device(device) -> torch.device:
    """The run's device; the card where there is none is an error (the
    caller asks for the CPU by naming it), as ``sharding.make_mesh(None)``
    is."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA device and there is none; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def _resolve_engine(engine: str, device) -> str:
    """'auto' picks the streamed kernel engine on the card (coupled runs
    take the segmented production driver) and the torch scan engine on the
    CPU (runner.py:59-71, with CUDA in the TPU's place).  The config path
    never sets per-point output depths (the reference's tsurfOutputDepth is
    global, ex1/InputSettings.h:20); library callers who build PointParams
    with per-point out_depth must pass engine='scan' -- the kernel engine
    raises on it."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; engines: "
                         f"{sorted(ENGINES)}")
    engine = ENGINES[engine]
    if engine != "auto":
        return engine
    return "kernel" if torch.device(device).type == "cuda" else "scan"


def _skip_missing_required(raw, lats, lons, verbose: bool, what: str):
    """Required-variable validation (read_input, roadrunner.cpp:183-231): a
    row missing any required variable anywhere is skipped (reported) by
    poisoning its tair.  Returns (raw, ok)."""
    ok = np.ones(np.asarray(raw.tair).shape[0], bool)
    for name in REQUIRED:
        missing = np.asarray(getattr(raw, name)) < -9000.0
        bad = missing.any(axis=1)
        for i in np.where(bad & ok)[0]:
            if verbose:
                t_bad = int(np.argmax(missing[i]))
                print(f"{name} missing at step {t_bad} "
                      f"{lats[i]:.4f} {lons[i]:.4f}")
        ok &= ~bad
    if verbose and (~ok).any():
        print(what.format(n=int((~ok).sum()), total=len(ok)))
    tair = np.asarray(raw.tair).copy()
    tair[~ok, :] = -9999.9
    return raw._replace(tair=tair), ok


def _missing_limit(config) -> float:
    """The failed-point budget (example2/src/roadrunner.cpp:536-543,
    700-706), as a ratio."""
    return float(config.get("missing_limit", 100.0)) / 100.0


def _grid_tdew(tair, tdew, rhz):
    """Dew point for the grid writer: Tdew from RH where only RH is
    there."""
    from .physics.moisture import tdew_from_rh
    need = (tdew < -100.0) & (tair > -100.0) & (rhz > -100.0)
    return np.where(need, np.asarray(tdew_from_rh(tair, rhz)), tdew)


def auto_chunk_t(n_points: int) -> int:
    """The kernel engine's chunk length when the caller gives none:
    ``production.auto_chunk_t`` of the point count, whatever the grid
    sources' clocks (roadsurf_tpu/runner.py:457-458).  An explicit chunk
    length is the caller's."""
    from . import production
    return production.auto_chunk_t(n_points)


@contextlib.contextmanager
def _parts(metrics, prefix: str):
    """``part(name)`` ends the part open (if any) and opens the span
    ``prefix.name``: the parts of a phase, one after the other, the last
    ending with the block."""
    parts = contextlib.ExitStack()

    def part(name):
        parts.close()
        parts.enter_context(metrics.phase(f"{prefix}.{name}"))
    with parts:
        yield part


def _scan_engine(model, raw, pts, cal, point_ids, checkpoint_in):
    """The scan engine's simulation (runner.py:204-239): Model.run or
    Model.run_coupled over the whole [P, T] forcing, or from a checkpoint's
    state.  Returns (final_state, {field: [T or n_out, P] numpy})."""
    settings = model.settings
    warm_state = None
    if checkpoint_in:
        # warm start: previous cycle's prognostic state replaces the
        # obs+climatology reconstruction (RoadSurfSource analogue done right;
        # the obs-feedback variant is the 'RoadSurf' input source type)
        template = model.init(raw, cal)
        warm_state = restore_state(checkpoint_in, point_ids, template)
    if settings.use_coupling:
        if warm_state is not None:
            from .coupling import run_coupled
            prep = model.prepare(raw, pts, cal)
            final_state, out = run_coupled(
                warm_state, prep, model.point_tensors(pts), settings,
                model.cfg, model.grid, model.params)
        else:
            final_state, out = model.run_coupled(raw, pts, cal)
        out_arr = out.cpu().numpy()
        return final_state, {
            "tsurf": out_arr[:, :, 0], "wat": out_arr[:, :, 1],
            "snow": out_arr[:, :, 2], "ice": out_arr[:, :, 3],
            "ice2": out_arr[:, :, 4], "dep": out_arr[:, :, 5]}
    if warm_state is not None:
        from .model import scan_steps
        prep = model.prepare(raw, pts, cal)
        ones = torch.ones(prep.tair.shape, dtype=prep.tair.dtype,
                          device=model.device)
        final_state, sim_out = scan_steps(
            warm_state, prep, ones, ones,
            model.point_tensors(pts).coupling_tsurf, model.cfg, model.grid,
            model.params)
    else:
        final_state, sim_out = model.run(raw, pts, cal)
    return final_state, {name: getattr(sim_out, name).cpu().numpy()
                         for name in ("tsurf", "wat", "snow", "ice", "ice2",
                                      "dep")}


def run(config_path: str, forecast_time_s: Optional[str] = None,
        output_path: Optional[str] = None,
        checkpoint_in: Optional[str] = None,
        checkpoint_out: Optional[str] = None,
        verbose: bool = True, engine: str = "auto",
        profile_dir: Optional[str] = None, chunk_t: int = 0,
        metrics=None, device="cuda", dtype: torch.dtype = torch.float64):
    """Run a config end to end (runner.py:74-290).  ``device``: where the
    run goes, the card unless the caller asks for the CPU (the kernel
    engine on the card takes every visible card, one point block each);
    ``dtype``: the scan engine's float type, float64 as the data plane's
    (float32 gives a run's float32 reference; the kernel engine is
    float32).  Returns (final_state, {field: [T or n_out, P]}), with
    ``steps`` among the kernel engine's fields."""
    from .observability import RunMetrics, failure_summary, profile_trace

    dev = check_device(device)
    metrics = metrics if metrics is not None else RunMetrics()
    if verbose:
        metrics.announce = True
    config = read_json_tolerant(config_path)
    settings0 = ModelSettings.from_json(config)
    ftime = parse_forecast_time(forecast_time_s) if forecast_time_s else None
    start, now, sim_len = build_times(config, ftime, settings0.dt)
    settings = dataclasses.replace(settings0, sim_len=sim_len)
    cal = Calendar.from_start(start, settings.dt, sim_len)
    sim_epochs = start + (np.arange(sim_len) * settings.dt).astype(np.int64)

    if verbose:
        print(f"Simulation: {sim_len} steps of {settings.dt}s from "
              f"{timelib.strftime('%Y-%m-%dT%H:%M', timelib.gmtime(start))}")

    engine = _resolve_engine(engine, dev)
    if engine == "kernel":
        with profile_trace(profile_dir, summary=verbose):
            return run_production_config(
                config, settings, cal, sim_epochs, now, start,
                output_path=output_path, checkpoint_in=checkpoint_in,
                checkpoint_out=checkpoint_out, verbose=verbose,
                metrics=metrics, chunk_t=chunk_t, device=dev)

    # ---- data plane ----------------------------------------------------
    handler = DataHandler.from_config(config, sim_epochs)

    # point modes (example2 Coordinate/Coordinates/Grid; io/points.py)
    from .io.points import nearest_station_forcing, parse_points_full
    pset = parse_points_full(config)
    mode, plats, plons = pset.mode, pset.lats, pset.lons
    if mode == "stations":
        if handler.has_grid_source() and not handler.point_ids():
            raise SystemExit(
                "Grid sources have no stations; a 'points' section "
                "(coordinate/coordinates/grid) is required")
        raw, obs_tair = handler.merged(sim_len)
        point_ids = handler.point_ids()
        locs = handler.locations()
        if not point_ids:
            raise SystemExit("No points found in input sources")
        lats = np.array([l[0] for l in locs])
        lons = np.array([l[1] for l in locs])
    else:
        radius = float((config.get("points") or {}).get(
            "max_radius_km", 50.0))
        if handler.has_grid_source():
            # example2 DataManager: every source queried per latlon
            raw, obs_tair = handler.merged_at_points(
                plats, plons, sim_len, max_radius_km=radius)
            st_idx = np.zeros(len(plats), np.int64)
        else:
            raw0, obs_tair0 = handler.merged(sim_len)
            locs = handler.locations()
            lats0 = np.array([l[0] for l in locs])
            lons0 = np.array([l[1] for l in locs])
            raw, st_idx = nearest_station_forcing(
                raw0, lats0, lons0, plats, plons, max_radius_km=radius)
            obs_tair = np.where(
                (st_idx >= 0)[:, None],
                np.asarray(obs_tair0)[np.clip(st_idx, 0, None)], -9999.9)
        lats, lons = plats, plons
        point_ids = list(range(1, len(plats) + 1))
        if verbose:
            print(f"Point mode '{mode}': {len(plats)} points "
                  f"({int((st_idx < 0).sum())} outside station radius)")

    pcfg = config.get("parameters", {}) or {}
    svf, horizons = sky_variables(point_ids,
                                  pcfg.get("sky_view_file"),
                                  pcfg.get("local_horizon_file"))
    params = PhysicsParams.from_json(settings, pcfg)

    # init_len default when relaxation is off: 1 + analysis/dt
    # (roadrunner.cpp:166-168)
    pts, blanked = derive_point_params(
        raw, settings, obs_tair=obs_tair if handler.sources else None,
        lat=lats, lon=lons, sky_view=svf, horizons=horizons)
    default_init = 1 + int((now - start) / settings.dt)
    if not settings.use_relaxation:
        pts = pts._replace(init_len=np.full(len(point_ids), default_init,
                                            np.int32))
    raw = raw._replace(tsurf_obs=blanked)
    raw, _ = _skip_missing_required(
        raw, lats, lons, verbose,
        "Skipping {n} / {total} points with missing required input")
    # the run's float type (the data plane is float64)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    raw = RawForcing(*(np.asarray(x) if n == "prec_phase"
                       else np.asarray(x, np_dtype)
                       for n, x in zip(RawForcing._fields, raw)))

    # ---- run ------------------------------------------------------------
    model = Model(settings, params, device=dev)
    t0 = timelib.time()
    metrics.count("points", len(point_ids))
    metrics.count("steps", sim_len)
    with profile_trace(profile_dir, summary=verbose), \
            metrics.phase("simulate"):
        final_state, out_fields = _scan_engine(model, raw, pts, cal,
                                               point_ids, checkpoint_in)
    elapsed = timelib.time() - t0
    metrics.count("point_steps_per_s",
                  round(len(point_ids) * sim_len / max(elapsed, 1e-9), 1))
    if verbose:
        print(f"Simulated {len(point_ids)} points x {sim_len} steps "
              f"in {elapsed:.2f}s (scan engine)")

    failed = final_state.failed.cpu().numpy()
    fail_ratio = float(failed.mean())
    if fail_ratio > 0 and verbose:
        failure_summary(failed, lats, lons)
    if fail_ratio > _missing_limit(config):
        raise SystemExit(
            f"Failed-point ratio {fail_ratio:.1%} exceeds missing_limit "
            f"{_missing_limit(config):.1%}")

    # ---- output ---------------------------------------------------------
    out_cfg = config.get("output", {}) or {}
    out_path = output_path or out_cfg.get("filename")
    if out_path and out_path.endswith(".npz") and mode == "grid":
        # gridded output (the querydata writer path; QueryDataTools.cpp)
        from .io.writer import write_forecast_grid
        tair_g = np.asarray(raw.tair, np.float64).T
        td = _grid_tdew(tair_g, np.asarray(raw.tdew, np.float64).T,
                        np.asarray(raw.rhz, np.float64).T)
        write_forecast_grid(out_path, pset.grid_lats, pset.grid_lons,
                            pset.keep, sim_epochs, out_fields, tair_g, td,
                            output_stride=settings.output_stride)
        if verbose:
            print(f"Wrote {out_path}")
    elif out_path:
        write_forecast_json(
            out_path, point_ids, lats, lons, sim_epochs,
            out_fields["tsurf"], out_fields["wat"], out_fields["snow"],
            out_fields["ice"], out_fields["dep"],
            output_stride=settings.output_stride)
        if verbose:
            print(f"Wrote {out_path}")
    if checkpoint_out:
        save_checkpoint(checkpoint_out, final_state, point_ids,
                        sim_epochs[-1])
        if verbose:
            print(f"Wrote checkpoint {checkpoint_out}")
    if verbose:
        metrics.report()
    return final_state, out_fields


def run_production_config(config, settings, cal, sim_epochs, now, start, *,
                          output_path=None, checkpoint_in=None,
                          checkpoint_out=None, verbose=True, metrics=None,
                          chunk_t: int = 64, out_stride=None, device="cuda"):
    """The production path: streamed, blocked execution of an
    example1/example2 config through the CUDA whole-scan kernel
    (runner.py:293-742).

    The data plane stays station-keyed ([S, T]) and grid-keyed ([K, ny,
    nx]); per-point forcing expands on the device chunk by chunk
    (production.StationExpander / GridExpander / CompositeExpander), so
    memory is O(S*T + chunk), not O(P*T) -- the re-design of the
    reference's async operational driver
    (examples/example2/src/roadrunner.cpp:595-719).  Routes, by the port's
    own rules: a station config without sky view prepares its forcing at
    station rank (K2); a grid, a grid + station overlay or stations with
    sky view go to K3 fused through their tile geometry; a composite K3
    fused declines (two grids) runs K3 on the eager prep.  Every chunk of
    every block is one sharded launch (K4).

    The point blocks of this process: one on each visible card, or the
    one CPU block when ``device`` is the CPU.  In a run of several
    processes (``parallel.distributed``) each process drains and
    writes its own shard and checkpoint (``.shard{index:05d}``) and the
    failed-point budget is summed over the processes."""
    from . import production
    from .forcing import relax_anchors
    from .io.points import nearest_station_index, parse_points_full
    from .observability import Progress, RunMetrics, failure_summary
    from .parallel import distributed, sharding
    from .state import PointParams, init_state

    dev = check_device(device)
    metrics = metrics or RunMetrics()
    if verbose:
        metrics.announce = True
    sim_len = settings.sim_len
    with metrics.phase("data_plane"), _parts(metrics, "data_plane") as part:
        part("sources")
        handler = DataHandler.from_config(config, sim_epochs)
        part("stations")
        pset = parse_points_full(config)
        if pset.mode == "stations":
            if handler.has_grid_source():
                raise SystemExit(
                    "Grid sources have no stations; a 'points' section "
                    "(coordinate/coordinates/grid) is required")
            point_ids = handler.point_ids()
            if not point_ids:
                raise SystemExit("No points found in input sources")
            locs = handler.locations()
            lats = np.array([l[0] for l in locs])
            lons = np.array([l[1] for l in locs])
        else:
            lats, lons = pset.lats, pset.lons
            point_ids = list(range(1, len(lats) + 1))

        grid_srcs = [(i, s) for i, s in enumerate(handler.sources)
                     if hasattr(s, "at_points")]
        station_srcs = [s for s in handler.sources
                        if not hasattr(s, "at_points")]
        # any grid source carrying tsurf_obs changes the MERGED obs series,
        # so coupling windows must derive per point from the composite
        # expander (device scan) instead of at station level
        grid_has_obsts = any("tsurf_obs" in s.fields for _, s in grid_srcs)

        sub = DataHandler(station_srcs)
        have_st = bool(station_srcs) and bool(sub.point_ids())
        P = len(point_ids)
        if have_st:
            raw_st, obs_tair_st = sub.merged(sim_len)
            locs = sub.locations()
            st_lats = np.array([l[0] for l in locs])
            st_lons = np.array([l[1] for l in locs])
            if pset.mode == "stations":
                st_idx = np.arange(len(point_ids), dtype=np.int64)
            else:
                radius = float((config.get("points") or {}).get(
                    "max_radius_km", 50.0))
                st_idx = nearest_station_index(st_lats, st_lons, lats, lons,
                                               radius)
                if verbose:
                    print(f"Point mode '{pset.mode}': {len(lats)} points "
                          f"({int((st_idx < 0).sum())} outside station "
                          f"radius)")

            # station-level read_input semantics (derive + obs blanking).
            # When a grid source carries tsurf_obs the coupling windows are
            # per-point properties of the MERGED series (derived below via
            # production.last_valid_scan); the station-level blanking is then
            # skipped -- prepare_window's in/after-window obs mask with the
            # per-point windows subsumes it (runner.py:368-380)
            pts_st, blanked_st = derive_point_params(
                raw_st, settings,
                obs_tair=obs_tair_st if handler.sources else None)
            if not (settings.use_coupling and grid_has_obsts):
                raw_st = raw_st._replace(tsurf_obs=blanked_st)

            # required-variable validation at station level; a bad station
            # poisons every point mapped to it.  Skipped when grid sources
            # overlay the stations (they may fill the gaps); the in-kernel
            # CheckValues containment then owns missing-data failure.
            if not grid_srcs:
                raw_st, _ = _skip_missing_required(
                    raw_st, st_lats, st_lons, verbose,
                    "Skipping points mapped to {n} stations with missing "
                    "required input")

            anchors_st = (relax_anchors(raw_st, pts_st)
                          if settings.use_relaxation else None)
            ok = st_idx >= 0
            ie = np.where(ok, st_idx, 0)
            g = lambda a, fill: np.where(ok, np.asarray(a)[ie], fill)
        else:
            if settings.use_coupling and verbose and not grid_has_obsts:
                print("No station sources and no grid tsurf_obs: coupling "
                      "inactive")
            st_idx = np.full(P, -1, np.int64)
            anchors_st = None

        part("params")
        # expand per-point parameters from their stations
        pcfg = config.get("parameters", {}) or {}
        svf, horizons = sky_variables(point_ids, pcfg.get("sky_view_file"),
                                      pcfg.get("local_horizon_file"))
        default_init = 1 + int((now - start) / settings.dt)
        if have_st:
            init_len = (g(pts_st.init_len, 1).astype(np.int32)
                        if settings.use_relaxation
                        else np.full(P, default_init, np.int32))
            relax = {n: g(getattr(pts_st, n), -9999.9)
                     for n in ("tair_relax", "vz_relax", "rh_relax",
                               "coupling_tsurf")}
            cpl = {n: g(getattr(pts_st, n), -99).astype(np.int32)
                   for n in ("coupling_start", "coupling_end")}
        else:
            init_len = np.full(P, default_init, np.int32)
            relax = {n: np.full(P, -9999.9)
                     for n in ("tair_relax", "vz_relax", "rh_relax",
                               "coupling_tsurf")}
            cpl = {n: np.full(P, -99, np.int32)
                   for n in ("coupling_start", "coupling_end")}
        pts = PointParams(
            lat=np.asarray(lats, np.float64),
            lon=np.asarray(lons, np.float64),
            sky_view=np.asarray(svf, np.float64),
            horizons=np.asarray(horizons, np.float64),
            init_len=init_len, out_depth=np.full(P, -9999.9), **relax, **cpl)
        anchors = (tuple(np.asarray(g(a, -9999.9)) for a in anchors_st)
                   if anchors_st is not None else None)
        if settings.use_relaxation and anchors is None:
            anchors = tuple(np.full(P, -9999.9) for _ in range(3))
        model = Model(settings, PhysicsParams.from_json(settings, pcfg),
                      device=dev)

    with metrics.phase("init"), _parts(metrics, "init") as part:
        part("expanders")
        mesh = sharding.make_mesh([dev] if dev.type == "cpu" else None)
        nproc = distributed.process_count()
        exp_dev = mesh.devices[0]
        p_pad = production.padded_points(P, len(mesh) * nproc)
        if not chunk_t:        # 0/None = size chunks for the point count
            chunk_t = auto_chunk_t(p_pad)
        metrics.count("chunk_t", chunk_t)
        # expander parts in config-source order (overlay semantics); all
        # station sources collapse into one part at the first station
        # source's position (DataHandler.merged already overlays them)
        parts = []
        gexp_by_src = {}
        skyview_any = production.sky_route(pts)[0]
        if have_st:
            st_idx_pad = np.pad(np.asarray(st_idx), (0, p_pad - P),
                                constant_values=-1)
            st_pos = min(i for i, s in enumerate(handler.sources)
                         if not hasattr(s, "at_points"))
            # station-level forcing preparation (the K2 fast path): valid
            # whenever every per-point prep input is station-derived -- a
            # pure station config with sky view inactive.  The virtual
            # station row (rank S+1) carries the same fill values the
            # per-point expansion uses for out-of-radius points.
            prep_ctx = None
            if not grid_srcs and not skyview_any:
                S_st = len(st_lats)
                app = lambda a, fill, dt=None: np.concatenate(
                    [np.asarray(a, dt), np.asarray([fill], dt)])
                if settings.use_relaxation:
                    il1 = app(pts_st.init_len, 1, np.int32)
                else:
                    il1 = np.full(S_st + 1, default_init, np.int32)
                st_pts1 = PointParams(
                    lat=np.zeros(S_st + 1), lon=np.zeros(S_st + 1),
                    sky_view=np.ones(S_st + 1),
                    horizons=np.zeros((S_st + 1, 1)),
                    init_len=il1,
                    tair_relax=app(pts_st.tair_relax, -9999.9),
                    vz_relax=app(pts_st.vz_relax, -9999.9),
                    rh_relax=app(pts_st.rh_relax, -9999.9),
                    coupling_start=app(pts_st.coupling_start, -99, np.int32),
                    coupling_end=app(pts_st.coupling_end, -99, np.int32),
                    coupling_tsurf=app(pts_st.coupling_tsurf, -9999.9),
                    out_depth=np.full(S_st + 1, -9999.9))
                anch1 = (tuple(app(a, -9999.9) for a in anchors_st)
                         if anchors_st is not None else None)
                prep_ctx = {"st_pts": st_pts1, "anchors": anch1,
                            "settings": settings, "params": model.params,
                            "hour": cal.hour, "t_total": sim_len}
            parts.append((st_pos, production.StationExpander(
                raw_st, st_idx_pad, exp_dev, chunk_t=chunk_t,
                prep_ctx=prep_ctx)))
        if grid_srcs:
            lat_pad = production._pad_tail(np.asarray(lats, np.float64),
                                           p_pad)
            lon_pad = production._pad_tail(np.asarray(lons, np.float64),
                                           p_pad)
            for i, s in grid_srcs:
                gexp = production.GridExpander(
                    s.times, s.lats, s.lons, s.fields, lat_pad, lon_pad,
                    sim_epochs, exp_dev, chunk_t=chunk_t)
                gexp_by_src[i] = gexp
                parts.append((i, gexp))
        parts = [p for _, p in sorted(parts, key=lambda t: t[0])]
        expander = (parts[0] if len(parts) == 1
                    else production.CompositeExpander(parts))

        if grid_srcs and verbose:
            part("screen")
            # the up-front station required-var check was skipped (grid
            # sources may fill the gaps): recover the reference's per-point
            # skip report from the MERGED forcing (roadrunner.cpp:183-231),
            # over windows of the expander's own chunk
            counts, n_bad = production.validation_counts(
                expander, sim_len, chunk_t=SCAN_CHUNK_T, n_real=P)
            if n_bad:
                per_var = ", ".join(f"{k}={v}" for k, v in counts.items()
                                    if v)
                print(f"Post-merge CheckValues screen: {n_bad}/{P} points "
                      f"carry invalid/missing input and will fail in-kernel "
                      f"({per_var})")
            else:
                print("Post-merge CheckValues screen: all points valid")

        if settings.use_coupling and grid_has_obsts:
            part("coupling_windows")
            # coupling window from the MERGED obs series, per point: last
            # valid TSurfObs index/value via a device scan over the composite
            # (read_input derivation, examples/example1/src/roadrunner.cpp:
            # 258-276 on the DataManager-merged series)
            from .io.driver import coupling_window_from_last
            lv = production.last_valid_scan(
                expander, sim_len, chunk_t=SCAN_CHUNK_T,
                names=("tsurf_obs",), n_real=P)
            i0, obs_v = lv["tsurf_obs"]
            cs, ce, ct_obs = coupling_window_from_last(i0, obs_v, settings)
            pts = pts._replace(coupling_start=cs, coupling_end=ce,
                               coupling_tsurf=ct_obs)
            if verbose:
                print(f"Grid-obs coupling: {int((ce >= 1).sum())}/{P} "
                      f"points carry a usable merged obs window")

        if grid_srcs and settings.use_relaxation:
            part("relaxation")
            # the relaxation fields read the MERGED overlay (read_input works
            # on DataManager-merged per-point arrays, roadrunner.cpp:157-278)
            # -- re-derive them per point: the anchor step is the latest obs
            # over ALL observation sources (station obs gathered host-side,
            # grid obs via a device scan), the values from the grid+station
            # overlay at that step
            from .io.driver import latest_obs_index

            def merged_at(step_p, names):
                """Overlay values at per-point 0-based sim steps (-1 = skip);
                {name: [P]}.  Unique steps are few (shared obs end times)."""
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
                        out_v[n] = np.where(hit, met[n][:P][rows, jc],
                                            out_v[n])
                return out_v

            last_p = (g(latest_obs_index(obs_tair_st),
                        -9999).astype(np.int64) if have_st
                      else np.full(P, -9999, np.int64))
            for i, s in grid_srcs:
                if not s.is_observation or "tair" not in s.fields:
                    continue
                lvg = production.last_valid_scan(
                    gexp_by_src[i], sim_len, chunk_t=SCAN_CHUNK_T,
                    names=("tair",), n_real=P)
                li0 = lvg["tair"][0].astype(np.int64)    # 0-based sim index
                last_p = np.maximum(                     # 1-based, max over
                    last_p, np.where(li0 >= 0, li0 + 1, -9999))  # obs srcs
            has_p = last_p > -1
            init_len = np.where(has_p, last_p, 1).astype(np.int32)
            # X_R values at the one-past-the-obs read index (driver quirk,
            # io.driver.derive_point_params)
            vals_r = merged_at(
                np.where(has_p, np.clip(last_p, 0, sim_len - 1), -1),
                ("tair", "vz", "rhz"))
            # anchors X_initEnd at init_len-1, first-step wind floor applied
            # (forcing.relax_anchors semantics)
            idx_a = np.clip(init_len.astype(np.int64) - 1, 0, sim_len - 1)
            vals_a = merged_at(idx_a, ("tair", "vz", "rhz"))
            vz_a = np.where(idx_a == 0, np.maximum(vals_a["vz"], 0.4),
                            vals_a["vz"])
            pts = pts._replace(
                init_len=init_len,
                tair_relax=np.where(has_p, vals_r["tair"], -9999.9),
                vz_relax=np.where(has_p, vals_r["vz"], -9999.9),
                rh_relax=np.where(has_p, vals_r["rhz"], -9999.9))
            anchors = (vals_a["tair"], vz_a, vals_a["rhz"])

        part("state")
        # the initial state from the first step's merged values, float32 on
        # the expander's device (runner.py:638-654)
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
        if checkpoint_in:
            state0 = restore_state(checkpoint_in, point_ids, state0)

    progress = Progress(sim_len) if verbose else None
    use_coupled = bool(settings.use_coupling) and bool(
        np.any((np.asarray(pts.coupling_end) >= 1)
               & (np.asarray(pts.coupling_tsurf) > -100.0)))
    run_fn = (production.run_production_coupled if use_coupled
              else production.run_production)
    # several processes: each drains and writes ONLY its own shard (no
    # tensor crosses between them; merge with io.writer.merge_shards)
    drain = "shard" if nproc > 1 else "gather"
    res = run_fn(
        model, expander, pts, cal, state0, anchors=anchors,
        devices=mesh.devices, chunk_t=chunk_t, out_stride=out_stride,
        metrics=metrics, progress=progress, drain=drain)
    lo_r, hi_r = res.point_range

    failed = res.state.failed.numpy()
    if drain == "shard":
        # the budget is the whole run's: each process adds its own count
        n_failed, n_all = distributed.sum_over_processes(
            [int(failed.sum()), int(failed.size)])
        fail_ratio = n_failed / max(n_all, 1)
    else:
        fail_ratio = float(failed.mean())
    if failed.any() and verbose:
        failure_summary(failed, lats[lo_r:hi_r], lons[lo_r:hi_r],
                        point_range=res.point_range if drain == "shard"
                        else None)
    if fail_ratio > _missing_limit(config):
        raise SystemExit(
            f"Failed-point ratio {fail_ratio:.1%} exceeds missing_limit "
            f"{_missing_limit(config):.1%}")

    out_cfg = config.get("output", {}) or {}
    out_path = output_path or out_cfg.get("filename")
    epochs_out = sim_epochs[res.out_steps]
    fields = res.fields
    with metrics.phase("write"):
        if drain == "shard":
            pid = distributed.process_index()
            if out_path:
                from .io.writer import write_shard_npz
                spath = f"{out_path}.shard{pid:05d}.npz"
                write_shard_npz(spath, res.point_range, res.out_steps,
                                fields, epochs=epochs_out)
                if verbose:
                    print(f"Wrote shard [{lo_r}, {hi_r}) -> {spath} "
                          f"(merge with roadsurf-tpu-torch merge-shards)")
            if checkpoint_out:
                save_checkpoint(f"{checkpoint_out}.shard{pid:05d}",
                                res.state, point_ids[lo_r:hi_r],
                                sim_epochs[-1])
        elif out_path and out_path.endswith(".npz") and pset.mode == "grid":
            from .io.writer import write_forecast_grid
            # tair/tdew per point at the output steps only
            met = expander.host_at(res.out_steps)
            ta_p = met["tair"][:P]
            td_p = _grid_tdew(ta_p, met["tdew"][:P], met["rhz"][:P])
            write_forecast_grid(out_path, pset.grid_lats, pset.grid_lons,
                                pset.keep, epochs_out, fields,
                                ta_p.T, td_p.T, output_stride=1)
            if verbose:
                print(f"Wrote {out_path}")
        elif out_path:
            write_forecast_json(out_path, point_ids, lats, lons, epochs_out,
                                fields["tsurf"], fields["wat"],
                                fields["snow"], fields["ice"], fields["dep"],
                                output_stride=1)
            if verbose:
                print(f"Wrote {out_path}")
        if checkpoint_out and drain != "shard":
            save_checkpoint(checkpoint_out, res.state, point_ids,
                            sim_epochs[-1])
            if verbose:
                print(f"Wrote checkpoint {checkpoint_out}")
    if verbose:
        print(f"Simulated {P} points x {sim_len} steps: "
              f"{res.point_steps_per_s / 1e6:.1f} M point-steps/s "
              f"(kernel engine)")
        metrics.report()
    out_fields = dict(fields)
    out_fields["steps"] = res.out_steps
    return res.state, out_fields


def merge_shards_cli(argv):
    """``roadsurf-tpu-torch merge-shards out.npz shard0.npz shard1.npz ...``
    -- assemble per-process output shards (the kernel engine's
    ``drain='shard'`` writes, io.writer.write_shard_npz) into one
    full-range npz (runner.py:745-761).  The multi-process equivalent of
    the reference's single shared output object
    (examples/example2/src/QueryDataTools.cpp:299-345)."""
    ap = argparse.ArgumentParser(prog="roadsurf-tpu-torch merge-shards")
    ap.add_argument("output", help="merged npz path")
    ap.add_argument("shards", nargs="+", help="shard npz files (any order)")
    args = ap.parse_args(argv)
    from .io.writer import merge_shards
    steps, fields, epochs = merge_shards(args.shards)
    np.savez_compressed(args.output, steps=np.asarray(steps, np.int64),
                        epochs=np.asarray(epochs, np.int64), **fields)
    npts = next(iter(fields.values())).shape[-1] if fields else 0
    print(f"Merged {len(args.shards)} shards -> {args.output} "
          f"({npts} points x {len(np.asarray(steps))} output steps)")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "merge-shards":
        return merge_shards_cli(argv[1:])
    ap = argparse.ArgumentParser(
        prog="roadsurf-tpu-torch",
        description="Road weather model runner on the GPU "
                    "(example1-compatible)")
    ap.add_argument("-c", "--config", required=False)
    ap.add_argument("config_pos", nargs="?", help="config file (positional)")
    ap.add_argument("-t", "--time", help="forecast time YYYYMMDDTHHMM")
    ap.add_argument("-o", "--output", help="output file override")
    ap.add_argument("-j", "--jobs", type=int, default=1,
                    help="accepted for CLI compatibility; batching replaces "
                         "thread-level parallelism")
    ap.add_argument("--checkpoint-in", dest="ck_in")
    ap.add_argument("--checkpoint-out", dest="ck_out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run goes (default: the card)")
    ap.add_argument("--engine", choices=tuple(ENGINES), default="auto",
                    help="auto = the streamed kernel engine on the card, "
                         "the torch scan engine on the CPU; pallas = "
                         "kernel")
    ap.add_argument("--profile", dest="profile_dir",
                    help="write a torch.profiler trace to this directory")
    ap.add_argument("--chunk-t", dest="chunk_t", type=int, default=0,
                    help="forcing streaming chunk length (kernel engine); "
                         "0 = auto-size for the point count")
    ap.add_argument("-v", "--verbose", action="store_true", default=True)
    args = ap.parse_args(argv)
    cfg = args.config or args.config_pos
    if not cfg:
        ap.error("Configuration file not given")
    run(cfg, args.time, args.output, args.ck_in, args.ck_out,
        verbose=args.verbose, engine=args.engine,
        profile_dir=args.profile_dir, chunk_t=args.chunk_t,
        device=args.device)


if __name__ == "__main__":
    main()
