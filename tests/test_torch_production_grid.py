"""The port's grid, grid+station and sky-view production paths against the
JAX package's, on the same seeded inputs, float32 on both sides:

 * ``GridExpander`` windows (device and host extraction), ``first_host`` and
   ``host_at`` against ``roadsurf_tpu.production.GridExpander``;
 * inside the port, the tile layout against the flat one, bit for bit: the
   grid interpolation, the station and composite raw windows, and
   ``prepare_window(time_axis=1)`` with sky view and horizons;
 * ``last_valid_scan`` and ``validation_counts`` against JAX's;
 * ``run_production`` (grid, composite, station with sky view) against
   JAX's ``run_production(interpret=True)`` at rtol 2e-4 / atol 2e-3 with
   equal failed masks (the coupled run is in
   tests/test_torch_production_grid_coupled.py), and the port's tile-major
   route (K3) against its generic route (K1), bit for bit, uncoupled and
   coupled.  The kernels run as their plain versions on the
   CPU.  Inputs after tests/test_production_fused_generic.py and
   tests/test_production_grid.py."""
import calendar
import functools
import time as timelib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import production as jprod
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import Calendar, RawForcing
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import forcing as tforcing
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.ops import scan_kernel as sk

torch.set_num_threads(1)

MISSING = -9999.9
NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
P = 1024


def utc(s):
    return calendar.timegm(timelib.strptime(s, "%Y-%m-%d %H:%M"))


def _grid_case(with_missing=True, T=97, dt=120.0, ny=3, nx=4, gap=False):
    """tests/test_production_fused_generic.py:35-63 (``gap``: the 4-hour
    hole of tests/test_production_grid.py:66-71, so the 180-min cap
    bites)."""
    t0 = utc("2019-12-02 00:00")
    hours = [0, 1, 2, 3, 4, 8, 9, 10, 11, 12] if gap else list(range(10))
    times = t0 + 3600 * np.array(hours, np.int64)
    rng = np.random.default_rng(3)
    R = len(times)
    shp = (R, ny, nx)
    hr = np.arange(R)[:, None, None]
    fields = {
        "tair": -3.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "rhz": np.clip(85.0 + rng.normal(0, 30.0, shp), -20, 140),
        "vz": np.abs(rng.normal(3.0, 1.0, shp)),
        "prec": np.where(rng.random(shp) < 0.2,
                         rng.uniform(0, 150.0, shp), 0.0),
        "sw": np.abs(rng.normal(20.0, 10.0, shp)),
        "lw": 290.0 + rng.normal(0, 5.0, shp),
        "sw_dir": np.zeros(shp),
        "lw_net": -10.0 + rng.normal(0, 2.0, shp),
        "tsurf_obs": -4.0 + 0.5 * hr + rng.normal(0, 0.3, shp),
        "prec_phase": rng.integers(0, 4, shp).astype(float),
    }
    if with_missing:
        for name in ("tair", "rhz", "prec", "sw", "prec_phase"):
            m = rng.random(shp) < 0.15
            fields[name] = np.where(m, MISSING, fields[name])
    lats = np.linspace(60.0, 61.0, ny)
    lons = np.linspace(24.0, 25.5, nx)
    sim = t0 + (dt * np.arange(T)).astype(np.int64)
    return times, lats, lons, fields, sim


def _points(seed=5, clip=True):
    rng = np.random.default_rng(seed)
    plat = 59.9 + rng.uniform(0, 1.3, P)
    plon = 23.9 + rng.uniform(0, 1.8, P)
    if clip:
        plat = np.clip(plat, 60.0, 61.0)
        plon = np.clip(plon, 24.0, 25.5)
    return plat, plon


def _station_case(T, S=7, seed=9, only=None):
    """tests/test_production_fused_generic.py:163-174; ``only``: the
    channels the stations carry (the rest all missing)."""
    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::83] = -1
    mk = lambda lo, hi, mf=0.1: np.where(
        rng.random((S, T)) < mf, MISSING, rng.uniform(lo, hi, (S, T)))
    raw_st = RawForcing(
        tair=mk(-20, 5), tdew=mk(-25, 2), vz=mk(0, 10), rhz=mk(10, 100),
        prec=mk(0, 5), sw=mk(0, 300), lw=mk(200, 350), sw_dir=mk(0, 200),
        lw_net=mk(-50, 30), tsurf_obs=mk(-15, 5, 0.6),
        prec_phase=rng.integers(-1, 4, (S, T)))
    if only is not None:
        raw_st = RawForcing(*(
            getattr(raw_st, n) if n in only
            else np.full_like(np.asarray(getattr(raw_st, n)),
                              -9999 if n == "prec_phase" else MISSING)
            for n in RawForcing._fields))
    return raw_st, st_idx


def _fields_equal(a, b, label=""):
    for n in RawForcing._fields:
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype, (label, n)
        assert torch.equal(x, y), (label, n)


def _tm_to_flat(w):
    """[n_tiles, tc, TP] leaves -> [tc, P]."""
    return RawForcing(*(x.transpose(0, 1).reshape(x.shape[1], -1)
                        for x in w))


@pytest.mark.parametrize("extract", ["device", "host"])
def test_grid_window_matches_jax(extract):
    """Windows (flat and tile layout), first-step values and host values
    against JAX's GridExpander: descending latitudes (the flip), points off
    the grid, missing samples; float32 values at rtol 1e-6 / atol 1e-5,
    prec_phase exactly."""
    times, lats, lons, fields, sim = _grid_case(gap=True)
    lats = lats[::-1].copy()
    fields = {k: np.asarray(v)[:, ::-1, :].copy() for k, v in fields.items()}
    plat, plon = _points(clip=False)
    jexp = jprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                              make_mesh(), chunk_t=32, extract=extract)
    texp = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                              "cpu", chunk_t=32, extract=extract)
    assert (texp.K, texp.KW, texp.MB, texp.SPAN) == (jexp.K, jexp.KW,
                                                     jexp.MB, jexp.SPAN)
    jwin = jax.jit(lambda d, t0: jexp.window(d, t0, 32))
    for t0 in (0, 17, 32, 64):
        want = jwin(jexp.device_data, np.int32(t0))
        for got in (texp.window(t0, 32), _tm_to_flat(texp.window_tm(t0, 32))):
            for n in RawForcing._fields:
                g, w = getattr(got, n).numpy(), np.asarray(getattr(want, n))
                assert g.dtype == w.dtype, n
                if n == "prec_phase":
                    np.testing.assert_array_equal(g, w, err_msg=n)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5,
                                               err_msg=f"{n}@t0={t0}")
    # host values in float64: the JAX side may extract through its native
    # library, expression-identical up to rounding
    for n in RawForcing._fields:
        np.testing.assert_allclose(texp.first_host[n],
                                   np.asarray(jexp.first_host[n]),
                                   rtol=1e-12, atol=1e-12, err_msg=n)
    sel = np.arange(0, len(sim), 5)
    names = ("tair", "tdew", "rhz", "vz", "prec_phase", "sw_dir")
    got, want = texp.host_at(sel, names), jexp.host_at(sel, names)
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-12, atol=1e-12,
                                   err_msg=n)


def test_tiled_windows_equal_flat(monkeypatch):
    """Inside the port, bit for bit: the tile-layout grid interpolation
    against the flat storage of an expander over the first 1,000 of the
    points (no multiple of 128: no tile layout), window_tm against window
    for grid, station and composite expanders, and the tile geometry
    rule."""
    assert tprod.tile_geometry(1024) == (1, 1024)
    assert tprod.tile_geometry(1152) == (3, 384)
    assert tprod.tile_geometry(1000) is None
    monkeypatch.setattr(tprod, "TILE_P", 256)
    assert tprod.tile_geometry(1024) == (4, 256)
    times, lats, lons, fields, sim = _grid_case(gap=True)
    T = len(sim)
    plat, plon = _points(clip=False)
    tiled = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                               "cpu", chunk_t=32)
    flat = tprod.GridExpander(times, lats, lons, fields, plat[:1000],
                              plon[:1000], sim, "cpu", chunk_t=32)
    assert tiled.tile_geom == (4, 256) and flat.tile_geom is None
    raw_st, st_idx = _station_case(T, only={"tsurf_obs", "vz"})
    sexp = tprod.StationExpander(raw_st, st_idx, "cpu", chunk_t=32)
    comp = tprod.CompositeExpander([tiled, sexp])
    assert comp.tile_geom == (4, 256)
    for t0 in (0, 17, 64):
        _fields_equal(RawForcing(*(x[:, :1000]
                                   for x in tiled.window(t0, 32))),
                      flat.window(t0, 32), "grid")
        for exp in (tiled, sexp, comp):
            _fields_equal(_tm_to_flat(exp.window_tm(t0, 32)),
                          exp.window(t0, 32), type(exp).__name__)
    assert tprod.CompositeExpander([flat, tprod.StationExpander(
        raw_st, st_idx[:1000], "cpu", chunk_t=32)]).tile_geom is None


def test_prepare_window_tiled_equals_flat():
    """prepare_window on the tile layout (time_axis=1) equals the [Tc, P]
    call bit for bit, with relaxation, coupling flags, sky view and
    per-point horizons (the lookup is a gather on the 360 axis in either
    layout), over a window holding the run's last step."""
    rng = np.random.default_rng(11)
    Tc, nt, tp, t_off, T_total = 16, 4, 256, 48, 64
    settings = tmodel.ModelSettings(sim_len=T_total, dt=300.0,
                                    use_relaxation=True, use_coupling=True)
    tm = tmodel.Model(settings, device="cpu")

    def rnd(lo, hi, miss=0.1):
        v = rng.uniform(lo, hi, (Tc, P))
        return torch.tensor(np.where(rng.random((Tc, P)) < miss, MISSING, v),
                            dtype=torch.float32)
    raw = tforcing.RawForcing(
        tair=rnd(-20, 5), tdew=rnd(-25, 2), vz=rnd(0, 10), rhz=rnd(10, 100),
        prec=rnd(0, 5), sw=rnd(0, 300), lw=rnd(200, 350),
        sw_dir=rnd(0, 200), lw_net=rnd(-50, 30), tsurf_obs=rnd(-15, 5, 0.5),
        prec_phase=torch.tensor(rng.integers(-1, 4, (Tc, P)),
                                dtype=torch.int32))
    sky = np.where(np.arange(P) % 3 == 0, 0.6, 1.0)
    pts = default_point_params(P)._replace(
        lat=60.0 + rng.uniform(0, 1, P), lon=24.0 + rng.uniform(0, 2, P),
        sky_view=sky, horizons=rng.uniform(0, 25, (P, 360)),
        init_len=rng.integers(1, 50, P).astype(np.int32),
        tair_relax=rng.uniform(-15, 5, P), vz_relax=rng.uniform(0, 8, P),
        rh_relax=rng.uniform(20, 100, P),
        coupling_start=rng.integers(1, 30, P).astype(np.int32),
        coupling_end=rng.integers(30, 60, P).astype(np.int32),
        coupling_tsurf=rng.uniform(-15, 5, P))
    f32 = lambda x: x.to(torch.float32) if x.is_floating_point() else x
    tpts = tforcing.PointParams(*(f32(x) for x in interop.point_params(
        pts, device="cpu")))
    anchors = tuple(torch.tensor(rng.uniform(-10, 10, P),
                                 dtype=torch.float32) for _ in range(3))
    hour = torch.tensor(rng.integers(0, 24, Tc))
    jde = torch.tensor(2458820.0 + rng.uniform(0, 1, Tc), dtype=torch.float32)
    kw = dict(t_offset=t_off, t_total=T_total, jde=jde, enable_skyview=True)
    flat = tforcing.prepare_window(raw, tpts, hour, settings, tm.params,
                                   anchors=anchors, **kw)
    tile = lambda x: x.reshape(Tc, nt, tp).transpose(0, 1)
    ptile = lambda x: x.reshape((nt, tp) + tuple(x.shape[1:]))
    tiled = tforcing.prepare_window(
        tforcing.RawForcing(*(tile(x) for x in raw)),
        tforcing.PointParams(*(ptile(x) for x in tpts)), hour, settings,
        tm.params, anchors=tuple(ptile(a) for a in anchors), time_axis=1,
        **kw)
    assert not torch.equal(flat.sw, raw.sw)          # sky view acted
    for n in flat._fields:
        if n == "trf_fric":
            assert torch.equal(flat.trf_fric, tiled.trf_fric)
        else:
            assert torch.equal(tile(getattr(flat, n)), getattr(tiled, n)), n
    # flat horizons skip the table: the same values as an all-zero table
    zero = tpts._replace(horizons=torch.zeros((P, 360)))
    a = tforcing.prepare_window(raw, zero, hour, settings, tm.params,
                                anchors=anchors, **kw)
    b = tforcing.prepare_window(raw, zero._replace(horizons=torch.zeros(
        (P, 1))), hour, settings, tm.params, anchors=anchors,
        flat_horizons=True, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_scans_match_jax():
    """last_valid_scan and validation_counts over a grid with missing
    samples and a 4-hour hole, against JAX's, on the device chunk loop."""
    times, lats, lons, fields, sim = _grid_case(gap=True, dt=300.0)
    T = len(sim)
    plat, plon = _points(clip=False)
    mesh = make_mesh()
    jexp = jprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                              mesh, chunk_t=32)
    texp = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                              "cpu", chunk_t=32)
    names = ("tsurf_obs", "tair")
    want = jprod.last_valid_scan(jexp, mesh, T, chunk_t=32, names=names)
    got = tprod.last_valid_scan(texp, T, chunk_t=32, names=names)
    for n in names:
        np.testing.assert_array_equal(got[n][0], want[n][0], err_msg=n)
        assert got[n][0].dtype == np.int32 and (got[n][0] >= 0).any()
        np.testing.assert_allclose(got[n][1], want[n][1], rtol=1e-6,
                                   atol=1e-5, err_msg=n)
    assert (tprod.validation_counts(texp, T, chunk_t=32, n_real=1000)
            == jprod.validation_counts(jexp, mesh, T, chunk_t=32,
                                       n_real=1000))


def test_scans_cap_window_at_expander_chunk():
    """A scan asked for windows longer than the expander's chunk runs at
    that chunk: its SPAN covers no longer window, and past it a step would
    take the previous segment's line.  The road-surface obs end with the
    02:00 sample, so the last valid step is 60 (dt 120 s) with the exact
    sample's value, whatever the chunk asked for; a longer window itself is
    refused."""
    times, lats, lons, fields, sim = _grid_case(with_missing=False, T=97)
    fields["tsurf_obs"][3:] = MISSING
    T = len(sim)
    plat, plon = _points()
    texp = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                              "cpu", chunk_t=32)
    assert texp.SPAN == 3
    by_chunk = {c: tprod.last_valid_scan(texp, T, chunk_t=c)["tsurf_obs"]
                for c in (32, 64)}
    for idx, val in by_chunk.values():
        np.testing.assert_array_equal(idx, 60)
        np.testing.assert_array_equal(val, by_chunk[32][1])
    np.testing.assert_array_equal(
        by_chunk[32][1], texp.window(32, 32).tsurf_obs[60 - 32].numpy())
    assert (tprod.validation_counts(texp, T, chunk_t=64)
            == tprod.validation_counts(texp, T, chunk_t=32))
    with pytest.raises(ValueError, match="longer than the expander's chunk"):
        texp.window(0, 33)


def _setup(config, T=64, use_coupling=False, with_jax=True):
    """(JAX expander, port expander, JAX settings, cal, pts, state0 [JAX
    float32]) of one configuration: ``grid``; ``composite``, the grid
    forecast overlaid by station obs and wind; ``composite_2st``, that
    composite under a second station network's radiation (K3 fused takes
    at most one station source: K3 on the eager prep); ``station_sky``, a
    station
    expander with sky view 0.6 and U(0, 25) degree horizons on every third
    point (tests/test_production_fused_generic.py:279-299).  The JAX side
    takes its generic route for the station part.  With ``use_coupling``
    the coupling window and obs come from the port's last_valid_scan of the
    merged tsurf_obs (the JAX package's coupling_window_from_last).
    ``with_jax=False`` skips the JAX expander (None)."""
    mesh = make_mesh() if with_jax else None
    times, lats, lons, fields, sim = _grid_case(with_missing=False, T=T)
    settings = ModelSettings(sim_len=T, dt=float(sim[1] - sim[0]),
                             use_relaxation=False, use_coupling=use_coupling,
                             coupling_minutes=30.0)
    cal = Calendar.from_epochs(sim)
    plat, plon = _points()
    pts = default_point_params(P)._replace(lat=plat, lon=plon)
    if config == "station_sky":
        raw_st, st_idx = _station_case(T, seed=13)
        rng = np.random.default_rng(7)
        sky = np.where(np.arange(P) % 3 == 0, 0.6, 1.0)
        hor = np.zeros((P, 360))
        hor[::3] = rng.uniform(0, 25, (len(hor[::3]), 360))
        pts = pts._replace(sky_view=sky, horizons=hor)
        jexp = (jprod.StationExpander(raw_st, st_idx, mesh, chunk_t=32)
                if with_jax else None)
        texp = tprod.StationExpander(raw_st, st_idx, "cpu", chunk_t=32)
    else:
        if config in ("composite", "composite_2st"):
            fields.pop("tsurf_obs")
        jexp = (jprod.GridExpander(times, lats, lons, fields, plat, plon,
                                   sim, mesh, chunk_t=32)
                if with_jax else None)
        texp = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                                  "cpu", chunk_t=32)
        if config in ("composite", "composite_2st"):
            sources = [_station_case(T, only={"tsurf_obs", "vz"})]
            if config == "composite_2st":
                # a second station network, radiation only
                sources.append(_station_case(T, S=5, seed=17,
                                             only={"sw", "lw"}))
            if with_jax:
                jexp = jprod.CompositeExpander([jexp] + [
                    jprod.StationExpander(r, i, mesh, chunk_t=32)
                    for r, i in sources])
            texp = tprod.CompositeExpander([texp] + [
                tprod.StationExpander(r, i, "cpu", chunk_t=32)
                for r, i in sources])
    if use_coupling:
        last = tprod.last_valid_scan(texp, T, chunk_t=32)["tsurf_obs"]
        cl = int(settings.coupling_minutes * 60 / settings.dt)
        usable = last[0] >= cl
        pts = pts._replace(
            coupling_start=np.where(usable, np.maximum(last[0] - cl, 1),
                                    -99).astype(np.int32),
            coupling_end=np.where(usable, last[0], -99).astype(np.int32),
            coupling_tsurf=np.where(usable, last[1], MISSING))
    raw0 = RawForcing(*(np.asarray(texp.first_host[n])[:, None]
                        for n in RawForcing._fields))
    state0 = Model(settings).init(raw0, cal, dtype=jnp.float32, pts=pts)
    return jexp, texp, settings, cal, pts, state0


@functools.lru_cache(maxsize=None)
def _jax_reference(config, coupled=False):
    """(``_setup``'s tuple, JAX's run at output stride 1): uncoupled over
    64 steps, coupled over 49.  One JAX run serves every output stride: a
    run's rows at stride k are its every-step rows at steps 0, k, 2k, ...
    (the kernel emits rows at the global step, pallas_step.py:545-568)."""
    setup = _setup(config, T=49 if coupled else 64, use_coupling=coupled)
    jexp, _, settings, cal, pts, state0 = setup
    run = jprod.run_production_coupled if coupled else jprod.run_production
    want = run(Model(settings), jexp, pts, cal, state0, mesh=make_mesh(),
               chunk_t=32, out_stride=1, interpret=True)
    assert np.array_equal(want.out_steps, np.arange(settings.sim_len))
    return setup, want


def _assert_match(got, want, out_stride):
    """The port's run at ``out_stride`` against JAX's every-step run."""
    assert np.array_equal(got.out_steps, want.out_steps[::out_stride])
    for name in NAMES:
        np.testing.assert_allclose(got.fields[name],
                                   want.fields[name][::out_stride],
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    assert np.array_equal(got.state.failed.numpy(),
                          np.asarray(want.state.failed))


def _assert_same(a, b):
    for name in NAMES:
        np.testing.assert_array_equal(a.fields[name], b.fields[name],
                                      err_msg=name)
    assert torch.equal(a.state.tmp, b.state.tmp)
    assert torch.equal(a.state.failed, b.state.failed)


@functools.lru_cache(maxsize=None)
def _model_runs(config):
    """Model.run over the expander's merged forcing on the host: the JAX
    package's in float64 (the reference; a float64 Julian day) and the
    port's in float32 (which sizes the bound): (failed, {field: [T, P]})
    of the JAX run and {field: [T, P]} of the port's."""
    _, texp, settings, cal, pts, _ = _setup(config, with_jax=False)
    T = settings.sim_len
    vals = texp.host_at(np.arange(T), RawForcing._fields)

    def raw(cls, dt):
        return cls(*(
            np.where(vals[n] <= -9000.0, -9999, vals[n]).astype(np.int32)
            if n == "prec_phase" else np.asarray(vals[n], dt)
            for n in RawForcing._fields))

    final, out = Model(settings).run(raw(RawForcing, np.float64), pts, cal)
    assert out.tsurf.dtype == jnp.float64
    out64 = {n: np.asarray(getattr(out, n)) for n in NAMES}
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    _, out32 = tm.run(raw(tforcing.RawForcing, np.float32), pts, cal)
    return (np.asarray(final.failed), out64,
            {n: getattr(out32, n).numpy() for n in NAMES})


@pytest.mark.parametrize("out_stride", [1, 6])
@pytest.mark.parametrize("config", ["grid", "composite", "station_sky"])
def test_port_production_matches_jax(config, out_stride):
    """Grid and composite: against JAX's float32 run_production.  Station
    + sky view: against the JAX package's float64 Model.run on the merged
    forcing, at twice the port's float32 Model.run's error against it plus
    the kernel tolerance, with equal failed masks; not against JAX's
    float32 run, whose sun position reads a Julian day rounded to float32
    (0.25 day; roadsurf_tpu/forcing.py:301), where the port forms the
    sun's time terms in float64."""
    if config == "station_sky":
        _, texp, settings, cal, pts, state0 = _setup(config, with_jax=False)
    else:
        (_, texp, settings, cal, pts, state0), want = _jax_reference(config)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    eng = tprod._Engine(tm, texp, pts, cal, interop.state(state0, "cpu"),
                        chunk_t=32)
    assert eng.tile_major and eng.fused and not eng.fast
    assert eng.enable_sky == (config == "station_sky")
    before = (sk.LAUNCHES, sk.LAUNCHES_SLIM, sk.LAUNCHES_TM,
              sk.LAUNCHES_TM_FUSED)
    got = tprod.run_production(tm, texp, pts, cal,
                               interop.state(state0, "cpu"), chunk_t=32,
                               out_stride=out_stride)
    assert (sk.LAUNCHES, sk.LAUNCHES_SLIM, sk.LAUNCHES_TM,
            sk.LAUNCHES_TM_FUSED) == before
    assert np.array_equal(got.out_steps,
                          np.arange(0, settings.sim_len, out_stride))
    if config != "station_sky":
        _assert_match(got, want, out_stride)
        return
    failed64, out64, out32 = _model_runs(config)
    for k, name in enumerate(NAMES):
        ref = out64[name][::out_stride]
        err = np.abs(got.fields[name] - ref).max()
        err32 = np.abs(out32[name][::out_stride] - ref).max()
        assert err <= 2.0 * err32 + (2e-4 if k == 0 else 2e-3), \
            (name, err, err32)
    assert np.array_equal(got.state.failed.numpy(), failed64)


@pytest.mark.parametrize("config", ["grid", "composite", "station_sky",
                                    "composite_2st"])
def test_tile_major_route_equals_generic(config, monkeypatch):
    """The port's tile-major route (K3 fused on the raw inputs; K3 slim on
    the tile-layout prep for a composite K3 fused does not take; in-kernel
    decay) against its generic route (K1 on the [Tc, P] prep, cof_window
    channels, forced by the engine's switch), bit for bit, uncoupled and
    coupled, on the same inputs."""
    _, exp, settings, cal, pts, state0 = _setup(
        config, T=49, use_coupling=True, with_jax=False)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    st = interop.state(state0, "cpu")
    routes = {}
    for tile in (True, False):
        monkeypatch.setattr(tprod._Engine, "force_generic", not tile)
        eng = tprod._Engine(tm, exp, pts, cal, st, chunk_t=32)
        assert eng.tile_major == tile
        assert eng.fused == (tile and config != "composite_2st")
        routes[tile] = (
            tprod.run_production(tm, exp, pts, cal, st, chunk_t=32,
                                 out_stride=6),
            tprod.run_production_coupled(tm, exp, pts, cal, st, chunk_t=32,
                                         out_stride=6))
    for a, b in zip(routes[True], routes[False]):
        _assert_same(a, b)
