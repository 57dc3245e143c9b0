"""The sky route of a run (``production.sky_route``): whether any point's
sky view is active, and whether every horizon is zero.

 * with no sky view active the route is ``(False, True)`` and the [P, 360]
   horizon table is never read (a stand-in that fails the test wherever it
   is converted, scanned or indexed);
 * with sky view active it scans the table as before: ``(True, True)``
   flat, ``(True, False)`` not;
 * ``RunMetrics`` counts the routes that read the table
   (``horizon_table_scans``): 0 on a run without sky view, 1 with it;
 * with sky view off the table does not reach the result: an all-zero
   table and a random one give the same rows, final state and failed mask,
   bit for bit, on the station K2 route, the generic route, K3 fused's
   plain version on a grid, and the coupled runs (K2 with K5, K3 fused with
   K5 fused);
 * on the card (marker ``cuda``): K3 fused and K5 fused with sky view off
   give the same bits with ``flat_hor`` 0 and 1.

Inputs come from numpy seeds and the port's own synthetic forcing; the file
imports nothing of JAX.
"""
import calendar
import time as timelib

import numpy as np
import pytest
import torch

from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.config import MISSING, ModelSettings
from roadsurf_tpu_torch.forcing import Calendar, RawForcing
from roadsurf_tpu_torch.io.synthetic import synthetic_raw
from roadsurf_tpu_torch.model import Model
from roadsurf_tpu_torch.observability import RunMetrics
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.ops import window_kernel as wk
from roadsurf_tpu_torch.state import State, default_point_params

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
P, S, T, CHUNK_T, OUT_STRIDE = 384, 5, 49, 16, 6
WS, WE = 11, 40                        # the station coupling window


class _Untouchable:
    """A horizon table that fails the test wherever it is read."""

    def _read(self, *args, **kwargs):
        raise AssertionError("the horizon table was read")

    __array__ = __bool__ = __len__ = __iter__ = __getitem__ = any = _read


def _parent_route(pts):
    """Both tests made always: what the route must give wherever some sky
    view is active."""
    sky = np.asarray(pts.sky_view)
    return (bool(np.any((sky < 1.0) & (sky > -0.01))),
            not np.asarray(pts.horizons).any())


@pytest.mark.parametrize("sky", [
    np.ones(P), np.ones(P, np.float32),
    np.resize([1.0, 1.25, -0.01, -0.5, 7.0], P)],
    ids=["ones", "ones_f32", "outside"])
def test_route_without_sky_view_never_reads_the_table(sky):
    pts = default_point_params(P)._replace(sky_view=sky,
                                           horizons=_Untouchable())
    assert tprod.sky_route(pts) == (False, True)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "horizons"])
@pytest.mark.parametrize("on", [0.6, 0.0, -0.005], ids=str)
def test_route_with_sky_view_scans_the_table(on, flat):
    """One point's sky view in [-0.01, 1) turns the route on; the table's
    scan decides ``flat_horizons``, as it did before."""
    sky = np.ones(P)
    sky[P // 3] = on
    hor = np.zeros((P, 360))
    if not flat:
        hor[P - 1, 200] = 3.5
    pts = default_point_params(P)._replace(sky_view=sky, horizons=hor)
    assert tprod.sky_route(pts) == (True, flat) == _parent_route(pts)


def _utc(s):
    return calendar.timegm(timelib.strptime(s, "%Y-%m-%d %H:%M"))


#: the runs' first step: the sun is up over the points, so horizons shade
#: them wherever sky view reads the table
DAY = _utc("2019-12-02 10:00")


def _station_case(coupled):
    """A station network on ``P`` points (a few out of every station's
    radius), with its station-rank prep_ctx (every per-point value its
    station's, the fast path's contract); coupled: the window [WS, WE],
    obs below the station's air temperature at WE, station 2 without
    obs."""
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False,
                             use_coupling=coupled)
    raw_st, cal = synthetic_raw(S, T, seed=23, start_epoch=DAY,
                                dtype=np.float32)
    rng = np.random.default_rng(23)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::97] = -1
    ok = st_idx >= 0
    sidx = np.where(ok, st_idx, 0)
    raw_pt = RawForcing(*(
        np.where(ok[:, None], np.asarray(getattr(raw_st, n))[sidx],
                 -9999 if n == "prec_phase" else np.float32(MISSING))
        for n in RawForcing._fields))
    pts = default_point_params(P)._replace(
        lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P))
    st_pts = default_point_params(S + 1)._replace(
        init_len=np.full(S + 1, 1, np.int32))
    if coupled:
        obs = np.asarray(raw_st.tair)[:, WE - 1] - rng.uniform(0.5, 2.5, S)
        obs[2] = MISSING
        app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
        pts = pts._replace(coupling_start=np.full(P, WS, np.int32),
                           coupling_end=np.full(P, WE, np.int32),
                           coupling_tsurf=np.where(ok, obs[sidx], MISSING))
        st_pts = st_pts._replace(
            coupling_start=app(np.full(S, WS, np.int32), -99).astype(
                np.int32),
            coupling_end=app(np.full(S, WE, np.int32), -99).astype(np.int32),
            coupling_tsurf=app(obs, MISSING))
    model = Model(settings, device="cpu")
    ctx = {"st_pts": st_pts, "anchors": None, "settings": settings,
           "params": model.params, "hour": cal.hour, "t_total": T}
    return settings, raw_st, raw_pt, cal, pts, st_idx, ctx


def _station_run(pts, device, *, fast, coupled, metrics=None):
    settings, raw_st, raw_pt, cal, pts0, st_idx, ctx = _station_case(
        coupled)
    model = Model(settings, device=device)
    exp = tprod.StationExpander(
        raw_st, np.pad(st_idx, (0, tprod.padded_points(P) - P),
                       constant_values=-1),
        device, chunk_t=CHUNK_T, prep_ctx=ctx if fast else None, slim=True)
    run = (tprod.run_production_coupled if coupled
           else tprod.run_production)
    state0 = model.init(raw_pt, cal, dtype=torch.float32)
    return run(model, exp, pts, cal, state0, chunk_t=CHUNK_T,
               out_stride=OUT_STRIDE, metrics=metrics)


def _grid_case(coupled, device):
    """An hourly 3 x 4 grid of every channel over ten hours from an hour
    before ``DAY``, ``P`` points inside it, 2-minute steps; coupled: each
    point's window ends at its last valid tsurf_obs (the runner's
    coupling_window_from_last)."""
    t0 = DAY - 3600
    times = t0 + 3600 * np.arange(10, dtype=np.int64)
    rng = np.random.default_rng(3)
    shp = (len(times), 3, 4)
    hr = np.arange(len(times))[:, None, None]
    fields = {
        "tair": -3.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "rhz": np.clip(85.0 + rng.normal(0, 30.0, shp), -20, 140),
        "vz": np.abs(rng.normal(3.0, 1.0, shp)),
        "prec": np.where(rng.random(shp) < 0.2,
                         rng.uniform(0, 150.0, shp), 0.0),
        "sw": np.abs(rng.normal(20.0, 10.0, shp)),
        "lw": 290.0 + rng.normal(0, 5.0, shp),
        "sw_dir": np.abs(rng.normal(15.0, 5.0, shp)),
        "lw_net": -10.0 + rng.normal(0, 2.0, shp),
        "tsurf_obs": -4.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "prec_phase": rng.integers(0, 4, shp).astype(float),
    }
    lats, lons = np.linspace(60.0, 61.0, 3), np.linspace(24.0, 25.5, 4)
    sim = DAY + (120.0 * np.arange(T)).astype(np.int64)
    settings = ModelSettings(sim_len=T, dt=120.0, use_relaxation=False,
                             use_coupling=coupled, coupling_minutes=30.0)
    cal = Calendar.from_epochs(sim)
    plat = 60.0 + rng.uniform(0, 1.0, P)
    plon = 24.0 + rng.uniform(0, 1.5, P)
    exp = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                             device, chunk_t=CHUNK_T)
    pts = default_point_params(P)._replace(lat=plat, lon=plon)
    if coupled:
        last = tprod.last_valid_scan(exp, T, chunk_t=CHUNK_T)["tsurf_obs"]
        cl = int(settings.coupling_minutes * 60 / settings.dt)
        usable = last[0] >= cl
        pts = pts._replace(
            coupling_start=np.where(usable, np.maximum(last[0] - cl, 1),
                                    -99).astype(np.int32),
            coupling_end=np.where(usable, last[0], -99).astype(np.int32),
            coupling_tsurf=np.where(usable, last[1], MISSING))
    model = Model(settings, device=device)
    raw0 = RawForcing(*(np.asarray(exp.first_host[n])[:, None]
                        for n in RawForcing._fields))
    state0 = model.init(raw0, cal, dtype=torch.float32, pts=pts)
    return model, exp, pts, cal, state0


def _grid_run(pts, device, *, coupled, metrics=None):
    model, exp, pts0, cal, state0 = _grid_case(coupled, device)
    run = (tprod.run_production_coupled if coupled
           else tprod.run_production)
    return run(model, exp, pts0._replace(sky_view=pts.sky_view,
                                         horizons=pts.horizons),
               cal, state0, chunk_t=CHUNK_T, out_stride=OUT_STRIDE,
               metrics=metrics)


def _base_pts(route):
    if route.startswith("grid"):
        return _grid_case(route == "grid_coupled", "cpu")[2]
    return _station_case(route == "coupled")[4]


def _run(route, pts, device="cpu", metrics=None):
    if route.startswith("grid"):
        return _grid_run(pts, device, coupled=route == "grid_coupled",
                         metrics=metrics)
    return _station_run(pts, device, fast=route != "generic",
                        coupled=route == "coupled", metrics=metrics)


def _assert_bitwise(got, want):
    assert np.array_equal(got.out_steps, want.out_steps)
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    for name in NAMES:
        np.testing.assert_array_equal(bits(got.fields[name]),
                                      bits(want.fields[name]), err_msg=name)
    for name in State._fields:
        assert torch.equal(getattr(got.state, name).cpu(),
                           getattr(want.state, name).cpu()), name


def _differs(a, b):
    return any(not np.array_equal(a.fields[n], b.fields[n]) for n in NAMES)


def _sky_off():
    """Sky view off at every point: ones, with values outside [-0.01, 1)
    between them."""
    return np.resize([1.0, 1.0, 1.25, -0.01, -0.5], P)


#: each route's engine: the station K2 route, the generic per-point route
#: (forced), K3 fused on a grid, K2 coupled (K5 in phase B) and K3 fused
#: coupled (K5 fused)
ROUTES = {"k2": dict(slim=True),
          "generic": dict(fast=False, tile_major=False),
          "grid": dict(fused=True, fast=False),
          "coupled": dict(slim=True),
          "grid_coupled": dict(fused=True, window_fused=True)}


def _engines(monkeypatch):
    """The list every ``_Engine`` built from now on is appended to."""
    engines = []
    init = tprod._Engine.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        engines.append(self)

    monkeypatch.setattr(tprod._Engine, "__init__", spy)
    return engines


@pytest.mark.parametrize("route", list(ROUTES))
def test_horizons_do_not_reach_a_run_without_sky_view(route, monkeypatch):
    """An all-zero horizon table and a random one, sky view off: equal
    rows, final state and failed mask, bit for bit; neither run reads the
    table (``horizon_table_scans`` 0).  The control: with sky view on at
    every third point the two tables give different rows."""
    if route == "generic":
        monkeypatch.setattr(tprod._Engine, "force_generic", True)
    base = _base_pts(route)._replace(sky_view=_sky_off())
    engines = _engines(monkeypatch)
    rng = np.random.default_rng(41)
    res, counts = [], []
    for hor in (np.zeros((P, 360)), rng.uniform(0, 25, (P, 360))):
        m = RunMetrics()
        res.append(_run(route, base._replace(horizons=hor), metrics=m))
        counts.append(m.counters["horizon_table_scans"])
        eng = engines[-1]
        assert (eng.enable_sky, eng.flat_horizons) == (False, True)
        assert tuple(eng.pts_dev.horizons.shape) == (eng.P_pad, 1)
        for name, want in ROUTES[route].items():
            assert getattr(eng, name) == want, name
    _assert_bitwise(res[1], res[0])
    assert counts == [0, 0]
    assert not res[0].state.failed.all()
    sky = base._replace(sky_view=np.where(np.arange(P) % 3 == 0, 0.6, 1.0))
    on = [_run(route, sky._replace(horizons=hor))
          for hor in (np.zeros((P, 360)), rng.uniform(0, 25, (P, 360)))]
    assert _differs(on[0], on[1])


@pytest.mark.parametrize("sky_on", [False, True], ids=["sky_off", "sky"])
def test_horizon_table_scans_count_the_routes_that_read_it(sky_on):
    """The counter reads 0 on a run without sky view and 1 on a run with
    it (sky view 0.6 and horizons on every third point); a second cycle
    with the same metrics adds its own."""
    pts = _base_pts("generic")
    if sky_on:
        rng = np.random.default_rng(7)
        hor = np.zeros((P, 360))
        hor[::3] = rng.uniform(0, 25, (len(hor[::3]), 360))
        pts = pts._replace(sky_view=np.where(np.arange(P) % 3 == 0, 0.6, 1.0),
                           horizons=hor)
    m = RunMetrics()
    _run("generic", pts, metrics=m)
    assert m.counters["horizon_table_scans"] == int(sky_on)
    _run("generic", pts, metrics=m)
    assert m.counters["horizon_table_scans"] == 2 * int(sky_on)
    assert m.calls["cycle_setup.sky_route"] == 2


@pytest.mark.cuda
def test_fused_kernels_ignore_flat_hor_without_sky_view(monkeypatch):
    """K3 fused (phases A and C) and K5 fused (phase B) of the coupled grid
    on the card, sky view off, with the kernels' ``flat_hor`` 0 and 1:
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    seen = []
    fuse_args = sk.fuse_args

    def spy(src, device):
        fa = fuse_args(src, device)
        seen.append((fa.sky_on, fa.flat_hor))
        return fa

    monkeypatch.setattr(sk, "fuse_args", spy)
    pts = _base_pts("grid_coupled")._replace(sky_view=_sky_off())
    res = {}
    for flat in (False, True):
        monkeypatch.setattr(tprod, "sky_route",
                            lambda pts, flat=flat: (False, flat))
        seen.clear()
        k3, k5 = sk.LAUNCHES_TM_FUSED, wk.LAUNCHES_FUSED
        res[flat] = _run("grid_coupled", pts, device=dev)
        assert sk.LAUNCHES_TM_FUSED > k3 and wk.LAUNCHES_FUSED > k5
        assert set(seen) == {(0, int(flat))}
    assert res[True].state.failed.cpu().sum() < P
    _assert_bitwise(res[True], res[False])
