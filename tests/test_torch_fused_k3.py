"""K3 fused: the tile-major route whose kernel prepares each step's forcing
from the raw series rows, and the sun position split that it reads.

 * the sun's time terms in float64 (``physics.sun.sun_time_terms``) and the
   per-point part in the run dtype: float64 against the JAX package at
   1e-9, float32 within 0.01 degree of float64 at a Julian day of 2.46e6
   (where a float32 day steps by 0.25 day);
 * the grid's segment stage (``GridExpander.plan`` / ``segments``),
   evaluated one step at a time as the kernel does, equals the windows bit
   for bit in both layouts, and the kernel's derivation of the plan from the
   expander's [T_pad] vectors gives the plan's rows;
 * routing: the engine takes the fused route (a ``FusedChunk`` a block a
   chunk) and its runs equal the unfused tile-major route's bit for bit on
   grid, composite, station + sky view, relaxation, and a coupled run with
   the in-kernel decay.  On the CPU both sides run the same eager prep
   into ``scan_reference``, so these cases test the routing and the
   chunk's wiring, not the kernel or its prep (the ``cuda`` cases and
   chip_smoke.py phase 3c do);
 * ``fuse_args`` builds the kernel's arguments from every configuration
   (dtypes, contiguity, null channels);
 * on the card (marker ``cuda``): the kernel against its plain version at
   the kernel tolerances with equal failed masks.

Inputs: the configurations of tests/test_torch_production_grid.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from roadsurf_tpu.physics import sun as jsun
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.forcing import RawForcing, relax_anchors
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.physics import sun as tsun

from test_torch_production_grid import (NAMES, P, _grid_case, _points,
                                        _setup)

torch.set_num_threads(1)

# tests/test_pallas_step.py:47-57 (tsurf and the profile; the storages)
TOL_T = dict(rtol=2e-5, atol=2e-4)
TOL_S = dict(rtol=2e-5, atol=2e-3)


def _sun_inputs(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    jde = 2458820.0 + np.sort(rng.uniform(0, 3, n))
    return jde, rng.uniform(55, 70, n), rng.uniform(20, 32, n)


def _elevation_azimuth(jde, lat, lon):
    """The sun from a day in ``jde``'s dtype: its time terms in that dtype,
    the per-point part in ``lat``'s (the composition the package ran
    before the split, when ``jde`` was the run dtype's)."""
    terms = tsun.sun_time_terms(jde)
    return tsun.sun_at_points(*(x.to(lat.dtype) for x in terms), lat, lon)


def test_sun_split_float64_matches_jax():
    """The float64 split (time terms, then the per-point part) against the
    JAX package's elevation_azimuth at 1e-9."""
    jde, lat, lon = _sun_inputs()
    want = jsun.elevation_azimuth(jnp.asarray(jde), jnp.asarray(lat),
                                  jnp.asarray(lon))
    terms = tsun.sun_time_terms(torch.tensor(jde))
    assert all(t.dtype == torch.float64 for t in terms)
    got = tsun.sun_at_points(*terms, torch.tensor(lat), torch.tensor(lon))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)


def test_sun_split_float32_near_float64():
    """A float32 run's elevation and azimuth from the float64 day's time
    terms lie within 0.01 degree of float64 at a day of 2.46e6, sunrise and
    sunset included; the float32 day itself puts the sun degrees off."""
    jde, lat, lon = _sun_inputs()
    lat32, lon32 = (torch.tensor(x, dtype=torch.float32) for x in (lat, lon))
    e64, a64 = _elevation_azimuth(torch.tensor(jde), torch.tensor(lat),
                                      torch.tensor(lon))
    terms = tsun.sun_time_terms(torch.tensor(jde))
    e32, a32 = tsun.sun_at_points(*(t.float() for t in terms), lat32, lon32)
    up = (e64 > 0.01) & (a64 > -9000.0)
    assert int(up.sum()) > 500
    assert torch.equal(e32[up] > 0, e64[up] > 0)
    assert float((e32.double() - e64)[up].abs().max()) < 0.01
    assert float((a32.double() - a64)[up].abs().max()) < 0.01
    e_old, _ = _elevation_azimuth(torch.tensor(jde, dtype=torch.float32),
                                      lat32, lon32)
    both = up & (e_old > 0)
    assert float((e_old.double() - e64)[both].abs().max()) > 1.0


def test_prepare_float32_sky_view_reads_float64_day():
    """``forcing.prepare`` of a float32 run with sky view: its radiation
    equals a float64 run's to float32 rounding, where the sun computed from
    a float32 day moves it by tens of W/m2."""
    T, n = 96, 64
    settings = tmodel.ModelSettings(sim_len=T, dt=900.0)
    from roadsurf_tpu_torch.io.synthetic import synthetic_raw
    from roadsurf_tpu_torch.state import default_point_params
    raw, cal = synthetic_raw(n, T, seed=4, scenario="winter_mix")
    rng = np.random.default_rng(2)
    pts = default_point_params(n)._replace(
        lat=rng.uniform(58, 66, n), lon=rng.uniform(20, 30, n),
        sky_view=np.full(n, 0.5), horizons=rng.uniform(0, 20, (n, 360)))
    raw = raw._replace(sw_dir=0.6 * np.asarray(raw.sw),
                       lw_net=np.asarray(raw.lw) - 320.0)
    preps = {}
    for dt in (np.float64, np.float32):
        m = tmodel.Model(settings, device="cpu")
        r = RawForcing(*(x.astype(dt) if x.dtype.kind == "f" else x
                         for x in raw))
        preps[dt] = m.prepare(r, pts, cal)
    d = (preps[np.float32].sw.double() - preps[np.float64].sw).abs()
    assert float(d.max()) < 1e-2, float(d.max())


def _kernel_plan(exp, t0, tc):
    """The kernel's derivation of a chunk's time machinery from the
    expander's [T_pad] vectors and (k0, lo) (csrc/scan_kernel.cu:
    grid_value, grid_segments, fused_prep), in numpy."""
    d = {k: v.numpy() for k, v in exp.device_data.items() if k != "pv"}
    k0, lo = exp.window_rows(t0)
    tg = t0 + np.arange(tc)
    clampi = lambda x, a, b: np.minimum(np.maximum(x, a), b)
    st = clampi(d["pos"][tg] - k0, 0, exp.SPAN - 1)
    kg = k0 + np.arange(exp.SPAN)
    return dict(
        s_t=st, tex=d["tex"][tg],
        trd=d["trel"][tg] - d["trel"][t0],
        kl=clampi(kg - lo, 0, exp.KW - 1),
        klm1=clampi(kg - lo - 1, 0, exp.KW - 1),
        lpos=clampi(d["pos"][tg] - lo, 0, exp.KW - 1),
        lpick=clampi(d["pick"][tg] - lo, 0, exp.KW - 1),
        havep=d["havep"][tg], tw=d["trw"][lo:lo + exp.KW])


@pytest.mark.parametrize("tiled", [True, False])
def test_segment_stage_equals_window(tiled):
    """The segment stage, evaluated one step at a time (each step's line
    from its segment, the exact-time valid sample over it), equals the
    expander's window bit for bit, in the tile layout and the flat one (an
    expander over 1,000 points has no tile layout); the plan equals the
    kernel's derivation from the [T_pad] vectors."""
    times, lats, lons, fields, sim = _grid_case(gap=True)
    plat, plon = _points(clip=False)
    n = P if tiled else 1000
    exp = tprod.GridExpander(times, lats, lons, fields, plat[:n], plon[:n],
                             sim, "cpu", chunk_t=32)
    assert (exp.tile_geom is not None) == tiled
    ta = 1 if tiled else 0
    for t0 in (0, 17, 32, 64):
        plan = exp.plan(t0, 32)
        kp = _kernel_plan(exp, t0, 32)
        np.testing.assert_array_equal(plan.s_t.numpy(), kp["s_t"])
        np.testing.assert_array_equal(plan.tex.numpy(), kp["tex"])
        np.testing.assert_array_equal(plan.trd.numpy(), kp["trd"])
        np.testing.assert_array_equal(plan.tw.numpy(), kp["tw"])
        np.testing.assert_array_equal(plan.kl, kp["kl"])
        np.testing.assert_array_equal(plan.klm1, kp["klm1"])
        for k in ("lpos", "lpick", "havep"):
            np.testing.assert_array_equal(getattr(plan, k).numpy(), kp[k])
        win = exp.window_tm(t0, 32) if tiled else exp.window(t0, 32)
        for name in ("tair", "vz", "sw", "tsurf_obs"):
            pvw = exp.device_data["pv"][name].narrow(ta, plan.lo, exp.KW)
            alpha, beta, ex_v, ex_ok = exp.segments(plan, pvw, ta)
            for t in range(32):
                s = int(plan.s_t[t])
                v = alpha[s] + plan.trd[t] * beta[s]
                if bool(plan.tex[t]):
                    v = torch.where(ex_ok[s], ex_v[s], v)
                assert torch.equal(v, getattr(win, name).select(ta, t)), \
                    (name, t0, t)


_CASES = ("grid", "composite", "station_sky", "grid_relax",
          "composite_coupled", "composite_flipped")


def _case(case):
    """(model, expander, pts, cal, state, anchors, coupled) of a case: the
    three configurations of test_torch_production_grid.py, the grid with
    relaxation on (anchors from the host forcing at init_len), the
    composite coupled to its merged obs, and the composite with its parts
    in the other order (the grid overlays the stations)."""
    config = case.split("_")[0]
    coupled = case.endswith("coupled")
    _, exp, settings, cal, pts, state0 = _setup(
        "station_sky" if case == "station_sky" else config,
        T=49, use_coupling=coupled, with_jax=False)
    anchors = None
    if case == "composite_flipped":
        exp = tprod.CompositeExpander(exp.parts[::-1])
    if case == "grid_relax":
        rng = np.random.default_rng(17)
        settings = dataclasses.replace(settings, use_relaxation=True)
        pts = pts._replace(
            init_len=rng.integers(1, 30, P).astype(np.int32),
            tair_relax=rng.uniform(-8, 2, P), vz_relax=rng.uniform(0, 8, P),
            rh_relax=rng.uniform(40, 100, P))
        vals = exp.host_at(np.arange(settings.sim_len), RawForcing._fields)
        anchors = relax_anchors(RawForcing(**vals), pts)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    return tm, exp, pts, cal, interop.state(state0, "cpu"), anchors, coupled


@pytest.mark.parametrize("case", _CASES)
def test_fused_route_equals_unfused(case, monkeypatch):
    """Routing: the fused route (a FusedChunk a block a chunk, K3 fused's
    plain version on the CPU) against the unfused tile-major route (the
    engine's eager prep stacked into K3's slim forcing), bit for bit, over
    the whole run at output stride 6.  Both run the same prep and
    scan_reference here, so this holds the route and the chunk's offsets,
    blocks and coupling phases, not the kernel."""
    tm, exp, pts, cal, st, anchors, coupled = _case(case)
    run = (tprod.run_production_coupled if coupled
           else tprod.run_production)
    res = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(tprod, "fused_parts", lambda e: None)
        eng = tprod._Engine(tm, exp, pts, cal, st, anchors=anchors,
                            chunk_t=32)
        assert eng.tile_major and eng.fused == fused
        res[fused] = run(tm, exp, pts, cal, st, anchors=anchors, chunk_t=32,
                         out_stride=6)
    for name in NAMES:
        np.testing.assert_array_equal(res[True].fields[name],
                                      res[False].fields[name], err_msg=name)
    assert torch.equal(res[True].state.tmp, res[False].state.tmp)
    assert torch.equal(res[True].state.failed, res[False].state.failed)


def test_fused_parts():
    """Which expanders K3 fused takes, and the merge order it reads."""
    _, grid, *_ = _setup("grid", T=49, with_jax=False)
    _, comp, *_ = _setup("composite", T=49, with_jax=False)
    _, station, *_ = _setup("station_sky", T=49, with_jax=False)
    assert tprod.fused_parts(grid) == (grid, None, False)
    assert tprod.fused_parts(station) == (None, station, False)
    g, s, last = tprod.fused_parts(comp)
    assert (g, s, last) == (comp.parts[0], comp.parts[1], False)
    flipped = tprod.CompositeExpander(comp.parts[::-1])
    assert tprod.fused_parts(flipped)[2] is True
    assert tprod.fused_parts(tprod.CompositeExpander([grid, grid])) is None
    _, comp2, *_ = _setup("composite_2st", T=49, with_jax=False)
    assert tprod.fused_parts(comp2) is None


@pytest.mark.parametrize("case", _CASES)
def test_fuse_args_build(case):
    """``fuse_args`` accepts every configuration's chunk (dtypes,
    contiguity, devices), with null pointers exactly for the channels a
    part lacks (a grid carries only its variables; a station part carries
    every channel)."""
    tm, exp, pts, cal, st, anchors, _ = _case(case)
    eng = tprod._Engine(tm, exp, pts, cal, st, anchors=anchors, chunk_t=32)
    src, kw = eng.kernel_inputs(32)
    assert sk.is_fused(src)
    fa = sk.fuse_args(src, torch.device("cpu"))
    grid, station, _ = eng.fused_parts
    for i, n in enumerate(sk.RAW_FIELDS):
        assert bool(fa.g[i]) == (grid is not None and n in grid.var_names)
        assert bool(fa.s[i]) == (station is not None)
    assert fa.has_grid == (grid is not None)
    assert bool(fa.anc_t) == (anchors is not None)
    assert bool(fa.sun) == eng.enable_sky
    if grid is not None:
        assert (fa.k0, fa.lo) == grid.window_rows(32)
        assert fa.span == grid.SPAN and fa.KW == grid.KW


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES)
def test_fused_kernel_matches_plain_on_card(case):
    """K3 fused on the card against its plain version on the same chunk
    inputs at the kernel tolerances, with equal failed masks, every chunk
    of the run (with the decay on the coupled case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    tm, exp, pts, cal, st, anchors, coupled = _case(case)
    settings = tm.settings
    tmc = tmodel.Model(settings, device=dev)
    expc = exp.block(0, exp.num_points, dev)
    eng = tprod._Engine(tmc, expc, pts, cal, st, anchors=anchors,
                        chunk_t=32)
    assert eng.fused
    cofs = None
    if coupled:
        rng = np.random.default_rng(3)
        cofs = tuple(torch.tensor(rng.uniform(-0.4, 0.6, P),
                                  dtype=torch.float32, device=dev)
                     for _ in range(2))
    for t0 in range(0, settings.sim_len, 32):
        nsteps = min(32, settings.sim_len - t0)
        src, kw = eng.kernel_inputs(t0, cofs)
        args = (eng.tmp0, eng.scal0, src, eng.cfg, eng.params, eng.grid)
        geo = eng.scan_kwargs(t0, nsteps)
        got = sk.scan_cuda_fused(*args, **geo, **kw)
        want = sk.scan_fused_reference(*args, **geo, **kw)
        torch.cuda.synchronize()
        L = eng.grid.nlayers
        # the output rows this chunk writes (the kernel leaves the rest of
        # its allocation unwritten)
        k = len(range(-(-t0 // eng.os_) * eng.os_, t0 + nsteps, eng.os_))
        for g, w, tol in ((got[0][:L + 2], want[0][:L + 2], TOL_T),
                          (got[2][:k, 0], want[2][:k, 0], TOL_T),
                          (got[2][:k, 1:6], want[2][:k, 1:6], TOL_S)):
            torch.testing.assert_close(g, w, equal_nan=True, **tol)
        assert torch.equal(got[1][sk.R_FAILED], want[1][sk.R_FAILED])
