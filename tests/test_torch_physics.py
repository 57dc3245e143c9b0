"""Module-level parity of the port with the JAX package: the static grid and
parameters bitwise, every ported physics function in float64 at 1e-12 on
random inputs that cross 0 C, forcing preparation, and the interop round
trip."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import config as jconfig
from roadsurf_tpu import forcing as jforcing
from roadsurf_tpu import grid as jgrid
from roadsurf_tpu import state as jstate
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.physics import boundary_layer as jbl
from roadsurf_tpu.physics import moisture as jmo
from roadsurf_tpu.physics import radiation as jrad
from roadsurf_tpu.physics import soil as jsoil
from roadsurf_tpu.physics import storage as jsto
from roadsurf_tpu.physics import sun as jsun
from roadsurf_tpu_torch import config as tconfig
from roadsurf_tpu_torch import forcing as tforcing
from roadsurf_tpu_torch import grid as tgrid
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import state as tstate
from roadsurf_tpu_torch.io.synthetic import synthetic_raw as tsynthetic_raw
from roadsurf_tpu_torch.physics import boundary_layer as tbl
from roadsurf_tpu_torch.physics import moisture as tmo
from roadsurf_tpu_torch.physics import radiation as trad
from roadsurf_tpu_torch.physics import soil as tsoil
from roadsurf_tpu_torch.physics import storage as tsto
from roadsurf_tpu_torch.physics import sun as tsun

torch.set_num_threads(1)

N = 512
JP = jconfig.PhysicsParams().derive(30.0)
TP = tconfig.PhysicsParams().derive(30.0)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


def _close(got, want, tol=1e-12):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if a.dtype == bool or b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f"leaf {i}")


def _pair(*arrays):
    """The same float64 numpy inputs as (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(np.asarray(a)) for a in arrays])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (N,))
    amount = lambda: np.where(rng.random(N) < 0.5, 0.0, u(0.0, 3.0))
    return rng, {
        "t": u(-15.0, 15.0), "t2": u(-12.0, 12.0), "rh": u(30.0, 100.0),
        "vz": u(0.4, 12.0), "bl0": u(5.0, 40.0), "sw": u(0.0, 600.0),
        "lw": u(150.0, 400.0), "alb": u(0.1, 0.6), "le": u(-50.0, 50.0),
        "wat": amount(), "snow": amount(), "ice": amount(),
        "ice2": amount(), "dep": amount(), "q2": amount() * 300.0,
        "t4": np.where(rng.random(N) < 0.5, 0.25, 1.25),
        "evap": u(-0.01, 0.01)}


def test_grid_bitwise():
    for nl in (15, 9, 24):
        want = jgrid.make_grid(JP, nl)
        got = tgrid.make_grid(TP, nl)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert np.array_equal(a, b), f.name
        for depth in (0.0, 0.03, 0.5, 9.0):
            assert (tgrid.depth_interp_coeffs(got, depth)
                    == jgrid.depth_interp_coeffs(want, depth))
        d = np.array([0.0, 0.05, -9999.9, 0.5, 30.0])
        for a, b in zip(tgrid.depth_interp_coeffs_vec(got, d),
                        jgrid.depth_interp_coeffs_vec(want, d)):
            assert np.array_equal(a, b)
    assert tgrid.day_of_year(2020, 3, 1) == jgrid.day_of_year(2020, 3, 1)


def test_params_and_settings_bitwise():
    for dt in (30.0, 60.0, 17.5):
        assert (dataclasses.asdict(tconfig.PhysicsParams().derive(dt))
                == dataclasses.asdict(jconfig.PhysicsParams().derive(dt)))
    js = jconfig.ModelSettings(sim_len=10, dt=60.0, tsurf_output_depth=0.03)
    ts = interop.settings(js)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert (ts.output_stride, ts.tph) == (js.output_stride, js.tph)
    for prop in ("log_mom", "log_heat", "log_cond", "log_ustar"):
        assert getattr(TP, prop) == getattr(JP, prop)
    cfg = {"parameters": {"MaxPormms": 1.5, "Emiss": 0.9}}
    assert (dataclasses.asdict(tconfig.PhysicsParams.from_json(
        ts, cfg["parameters"])) == dataclasses.asdict(
        jconfig.PhysicsParams.from_json(js, cfg["parameters"])))


def test_moisture():
    _, x = _inputs(1)
    t, t2, rh = x["t"], x["t2"], x["rh"]
    (jt, jt2, jrh), (tt, tt2, trh) = _pair(t, t2, rh)
    _close(tmo.esat(tt), jmo.esat(jt))
    _close(tmo.esat_air_convention(tt), jmo.esat_air_convention(jt))
    _close(tmo.rh_from_tdew(tt, tt2), jmo.rh_from_tdew(jt, jt2))
    _close(tmo.tdew_from_rh(tt, trh), jmo.tdew_from_rh(jt, jrh))
    # the host (numpy) path stays numpy and equals the JAX package's
    for fn in ("esat", "esat_air_convention"):
        got = getattr(tmo, fn)(t)
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, getattr(jmo, fn)(t))
    assert np.array_equal(tmo.tdew_from_rh(t, rh), jmo.tdew_from_rh(t, rh))
    assert np.array_equal(tmo.rh_from_tdew(t, t2), jmo.rh_from_tdew(t, t2))


def test_sun():
    cal = jforcing.Calendar.from_start(1575244800, 1800.0, 96)
    jde = cal.jde
    assert np.array_equal(tsun.julian_ephemeris_day(*cal), jde)
    rng = np.random.default_rng(2)
    lat, lon = rng.uniform(55, 70, 64), rng.uniform(15, 35, 64)
    want = jsun.elevation_azimuth(jnp.asarray(jde)[:, None],
                                  jnp.asarray(lat)[None], jnp.asarray(lon)[None])
    got = tsun.sun_at_points(
        *(x[:, None] for x in tsun.sun_time_terms(torch.tensor(jde))),
        torch.tensor(lat)[None], torch.tensor(lon)[None])
    _close(got, want)


def test_net_radiation():
    _, x = _inputs(3)
    args = (x["t"], x["alb"], x["sw"], x["lw"], 1.0 + 0.1 * x["alb"],
            1.0 - 0.1 * x["alb"])
    j, t = _pair(*args)
    _close(trad.net_radiation(*t, TP), jrad.net_radiation(*j, JP))


@pytest.mark.parametrize("horizons", ["per_point", "shared"])
def test_modify_radiation(horizons):
    """Per-point horizon tables through one gather on the 360 axis, with
    negative, 359.5 and -9999.9 azimuths (radiation.py:55)."""
    rng = np.random.default_rng(4)
    P, T = 32, 24
    sw = rng.uniform(0, 500, (P, T))
    sw_dir = 0.7 * sw
    lw = rng.uniform(200, 350, (P, T))
    lw_net = lw - 300.0
    elev = rng.uniform(-5, 40, (P, T))
    azim = rng.uniform(-30, 400, (P, T))
    azim[:, 0] = 359.5
    azim[:, 1] = -9999.9
    azim[:, 2] = -0.5
    azim[:, 3] = 0.5
    azim[:, 4] = -179.5
    sky = rng.uniform(0.3, 1.0, P)
    hor = (rng.uniform(0, 20, (P, 360)) if horizons == "per_point"
           else rng.uniform(0, 20, 360))
    # the JAX function is point-major [P, T] here (its default layout);
    # the port's is time-major [T, P]
    want = jrad.modify_radiation(*map(jnp.asarray, (
        sw, sw_dir, lw, lw_net, elev, azim)), jnp.asarray(sky)[:, None],
        jnp.asarray(hor), JP)
    got = trad.modify_radiation(*(torch.tensor(a.T) for a in (
        sw, sw_dir, lw, lw_net, elev, azim)), torch.tensor(sky)[None],
        torch.tensor(hor), TP)
    _close([g.T for g in got], want)


def test_boundary_layer():
    _, x = _inputs(5)
    t, tair, rh, vz, bl0 = x["t"], x["t2"], x["rh"], x["vz"], x["bl0"]
    j, tt = _pair(t, tair, rh, vz, bl0, x["wat"])
    _close(tbl.air_properties(tt[1], TP), jbl.air_properties(j[1], JP))
    jvcap = jbl.air_properties(j[1], JP)[2]
    tvcap = tbl.air_properties(tt[1], TP)[2]
    got = tbl.bl_conductance(tt[4], tt[0], tt[1], tt[3], tvcap, TP)
    want = jbl.bl_conductance(j[4], j[0], j[1], j[3], jvcap, JP)
    _close(got, want)
    _close(tbl.aerodynamic_resistance(got[1], got[2], tt[3], TP),
           jbl.aerodynamic_resistance(want[1], want[2], j[3], JP))
    raero = tbl.aerodynamic_resistance(got[1], got[2], tt[3], TP)
    _close(tbl.latent_heat(tt[0], tt[1], tt[2], raero, tt[5], 30.0, TP),
           jbl.latent_heat(j[0], j[1], j[2], jnp.asarray(raero.numpy()),
                           j[5], 30.0, JP))
    # the cold start of init_state (BLCond sentinel -99.9)
    cold = np.full(N, -99.9)
    _close(tbl.bl_cond_and_le(torch.tensor(cold), tt[0], None, 30.0, tt[5],
                              tt[1], tt[3], tt[2], TP, max_iter=17),
           jbl.bl_cond_and_le(jnp.asarray(cold), j[0], None, 30.0, j[5],
                              j[1], j[3], j[2], JP, max_iter=17))


def test_soil():
    rng, x = _inputs(6)
    grid = jgrid.make_grid(JP, 15)
    tmp = rng.uniform(-10, 10, (N, 17))
    j, t = _pair(tmp, grid.wcont, grid.dyc, grid.cond_dz, x["bl0"],
                 x["sw"] - 200.0, x["le"], np.full(N, 10.0))
    _close(tsoil.volumetric_heat_capacity(t[0][:, 1:16], t[1], TP),
           jsoil.volumetric_heat_capacity(j[0][:, 1:16], j[1], JP))
    _close(tsoil.soil_step(*t, 30.0, TP), jsoil.soil_step(*j, 30.0, JP))
    for idx, w in ((1, 0.0), (2, 0.37), (16, 0.0)):
        _close(tsoil.temp_at_depth(t[0], idx, w),
               jsoil.temp_at_depth(j[0], idx, w))
    _close(tsoil.surface_average(t[0], 1, 0.0, False),
           jsoil.surface_average(j[0], 1, 0.0, False))
    _close(tsoil.surface_average(t[0], 3, 0.25, True),
           jsoil.surface_average(j[0], 3, 0.25, True))
    idx, w, use = jgrid.depth_interp_coeffs_vec(
        grid, rng.choice([-9999.9, 0.0, 0.04, 0.3, 5.0], N))
    _close(tsoil.surface_average(t[0], torch.tensor(idx), torch.tensor(w),
                                 torch.tensor(use)),
           jsoil.surface_average(j[0], jnp.asarray(idx), jnp.asarray(w),
                                 jnp.asarray(use)))


def _storages(x, mod, conv):
    return mod.Storages(*(conv(x[k]) for k in ("wat", "snow", "ice", "ice2",
                                               "dep")))


@pytest.mark.parametrize("force", [False, True])
def test_storage(force):
    rng, x = _inputs(7 + force)
    J, T = jnp.asarray, torch.tensor
    js, ts = _storages(x, jsto, J), _storages(x, tsto, T)
    tsurf = x["t"] / 5.0
    phase = rng.choice([-9999, 0, 1, 2, 3, 4, 5, 6, 7], N)
    prec = np.where(rng.random(N) < 0.3, 0.0, rng.uniform(0, 0.1, N))
    _close(tsto.calc_prec_type(T(phase), T(prec), T(x["t"]), T(x["rh"]), TP),
           jsto.calc_prec_type(J(phase), J(prec), J(x["t"]), J(x["rh"]), JP))
    jw, tw = jsto.wear_factors(js, 30 / 3600, JP), tsto.wear_factors(
        ts, 30 / 3600, TP)
    _close(tw, jw)
    _close(tsto.water_storage(ts, T(tsurf), T(x["evap"]), tw.wat_wear, True,
                              TP),
           jsto.water_storage(js, J(tsurf), J(x["evap"]), jw.wat_wear, True,
                              JP))
    srf = np.clip(x["wat"] - 1.0, 0, None)
    wet = rng.random(N) < 0.5
    _close(tsto.snow_storage(ts, T(srf), T(tsurf), T(x["q2"]), T(wet), tw,
                             30.0, force, TP),
           jsto.snow_storage(js, J(srf), J(tsurf), J(x["q2"]), J(wet), jw,
                             30.0, force, JP))
    _close(tsto.ice_storage(ts, T(tsurf), T(x["q2"]), tw, 30.0, force, TP),
           jsto.ice_storage(js, J(tsurf), J(x["q2"]), jw, 30.0, force, JP))
    _close(tsto.deposit_storage(ts, T(tsurf), T(x["evap"]), tw.dep_wear, TP),
           jsto.deposit_storage(js, J(tsurf), J(x["evap"]), jw.dep_wear, JP))
    _close(tsto.new_melt_freeze_heat(ts, T(x["t4"]), 30.0, TP),
           jsto.new_melt_freeze_heat(js, J(x["t4"]), 30.0, JP))
    _close(tsto.albedo_update(T(x["alb"]), ts, TP),
           jsto.albedo_update(J(x["alb"]), js, JP))
    vc = rng.random(N) < 0.5
    cold_t = rng.uniform(-25, -15, N)
    _close(tsto.very_cold_update(T(vc), T(cold_t), TP),
           jsto.very_cold_update(J(vc), J(cold_t), JP))
    _close(tsto.road_cond(ts, T(tsurf), T(x["evap"]), T(x["q2"]), T(x["t4"]),
                          T(vc), 30 / 3600, 30.0, force, force, TP),
           jsto.road_cond(js, J(tsurf), J(x["evap"]), J(x["q2"]), J(x["t4"]),
                          J(vc), 30 / 3600, 30.0, force, force, JP))


@pytest.mark.parametrize("can_change,depth", [
    (True, (1, 0.0, False)), (True, (3, 0.4, True)),
    (False, (1, 0.0, False))])
def test_melting_limiter(can_change, depth):
    rng, x = _inputs(9)
    J, T = jnp.asarray, torch.tensor
    tmp = rng.uniform(-3, 3, (N, 17))
    tsurf = rng.uniform(-1, 3, N)
    hstor = rng.uniform(-1e3, 1e3, N)
    hs1 = rng.uniform(1e3, 5e3, N)
    in_cpl = rng.random(N) < 0.3
    obs = rng.uniform(-2, 2, N)
    args = lambda conv, mod: (
        _storages(x, mod, conv), conv(tmp), conv(tsurf), conv(x["q2"]),
        conv(x["t4"]), conv(hstor), conv(hs1), conv(in_cpl), conv(obs),
        *depth, can_change)
    _close(tsto.melting_limiter(*args(T, tsto), TP),
           jsto.melting_limiter(*args(J, jsto), JP))


def test_init_state():
    rng, x = _inputs(10)
    grid = jgrid.make_grid(JP, 15)
    obs = np.where(rng.random(N) < 0.5, -9999.9, x["t"])
    settings = jconfig.ModelSettings(sim_len=10)
    for depth in ((1, 0.0, False), (2, 0.3, True)):
        want = jstate.init_state(settings, JP, grid, x["t2"], x["vz"],
                                 x["rh"], obs, (2019, 12, 2), *depth)
        got = tstate.init_state(interop.settings(settings), TP, grid,
                                *(torch.tensor(a) for a in (
                                    x["t2"], x["vz"], x["rh"], obs)),
                                (2019, 12, 2), *depth)
        _close(list(got), list(want))


@pytest.mark.parametrize("use_relaxation", [False, True])
def test_prepare(use_relaxation):
    """forcing.prepare with relaxation, sky view (per-point horizons),
    missing inputs and the first/last-step quirks."""
    P, T = 48, 73
    settings = jconfig.ModelSettings(sim_len=T, use_relaxation=use_relaxation)
    raw, cal = synthetic_raw(P, T, seed=12, scenario="winter_mix")
    raw = raw._replace(tair=raw.tair.copy())
    raw.tair[3, 10] = -9999.9
    rng = np.random.default_rng(12)
    pts = jstate.default_point_params(P)._replace(
        lat=rng.uniform(58, 66, P), lon=rng.uniform(20, 30, P),
        sky_view=np.where(np.arange(P) % 3 == 0, 0.6, 1.0),
        horizons=rng.uniform(0, 25, (P, 360)))
    if use_relaxation:
        il = np.full(P, 20, np.int32)
        rows = np.arange(P)
        pts = pts._replace(init_len=il, tair_relax=raw.tair[rows, il] + 0.4,
                           vz_relax=raw.vz[rows, il] + 0.1,
                           rh_relax=raw.rhz[rows, il] - 2.0)
    want = jforcing.prepare(raw, pts, cal, settings, JP)
    got = tforcing.prepare(interop.raw_forcing(raw, device="cpu"),
                           interop.point_params(pts, device="cpu"),
                           interop.calendar(cal), interop.settings(settings),
                           TP)
    _close(list(got), list(want))
    anchors = [np.asarray(a) for a in jforcing.relax_anchors(raw, pts)]
    _close(tforcing.relax_anchors(interop.raw_forcing(raw, device="cpu"),
                                  interop.point_params(pts, device="cpu")),
           anchors)
    for a, b in zip(tforcing.relax_anchors(raw, pts), anchors):
        assert np.array_equal(a, b)


def test_synthetic_raw_is_the_same():
    for sc in ("winter_mix", "cold_snow", "warm_rain"):
        want, wcal = synthetic_raw(8, 50, seed=3, scenario=sc,
                                   dtype=np.float32)
        got, gcal = tsynthetic_raw(8, 50, seed=3, scenario=sc,
                                   dtype=np.float32)
        for a, b in zip(list(got) + list(gcal), list(want) + list(wcal)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_interop_round_trip_exact():
    raw, cal = synthetic_raw(16, 20, seed=13, dtype=np.float32)
    pts = jstate.default_point_params(16)
    settings = jconfig.ModelSettings(sim_len=20)
    state = jstate.init_state(settings, JP, jgrid.make_grid(JP, 15),
                              raw.tair[:, 0], raw.vz[:, 0], raw.rhz[:, 0],
                              raw.tsurf_obs[:, 0], (2019, 12, 2))
    prep = jforcing.prepare(raw, pts, cal, settings, JP)
    for obj, conv in ((raw, interop.raw_forcing), (pts, interop.point_params),
                      (state, interop.state), (prep, interop.prepared)):
        back = interop.to_numpy(conv(obj, device="cpu"), cls=type(obj))
        assert type(back) is type(obj)
        for name in obj._fields:
            a, b = np.asarray(getattr(back, name)), np.asarray(
                getattr(obj, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    back_cal = interop.calendar(cal)
    assert all(np.array_equal(a, b) for a, b in zip(back_cal, cal))
    assert dataclasses.asdict(interop.params(JP)) == dataclasses.asdict(JP)
