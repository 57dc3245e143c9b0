"""The port's observation coupling against the JAX package, float64: the
snowIceCheck melt, the post-window coefficient rows (``cof_window``,
``cof_schedule``) and ``coupling_control`` on inputs that reach every
branch at 1e-12; ``Model.run_coupled`` (the per-point-PC engine) at 1e-9
on the scenarios of tests/test_parity_coupled.py:17-45 and on the coupled
golden (tests/test_golden.py:84-105); and the segmented engine
(``run_coupled_segmented``) bit for bit against the port's own PC engine,
as tests/test_coupling_segmented.py holds the JAX pair."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import coupling as jcoupling
from roadsurf_tpu.config import ModelSettings, PhysicsParams
from roadsurf_tpu.forcing import Calendar, RawForcing, cof_schedule, \
    cof_window
from roadsurf_tpu.io.driver import derive_point_params
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.physics import storage as jstorage
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import coupling as tcoupling
from roadsurf_tpu_torch import forcing as tforcing
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch.physics import storage as tstorage

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden.npz")
TOL12 = dict(rtol=1e-12, atol=1e-12)
TOL9 = dict(rtol=1e-9, atol=1e-9)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_snow_ice_check_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    s = [np.where(rng.random(n) < 0.3, 0.0, rng.uniform(0, 3, n))
         for _ in range(5)]
    # obs around the melt thresholds, and the missing sentinel
    obs = rng.choice([-9999.9, -2.0, -0.5, 0.0, 0.5, 1.5, 3.0], n)
    p = PhysicsParams()
    want = jstorage.snow_ice_check(
        jstorage.Storages(*(jnp.asarray(x) for x in s)), jnp.asarray(obs), p)
    got = tstorage.snow_ice_check(tstorage.Storages(*(_t(x) for x in s)),
                                  _t(obs), interop.params(p))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL12)
    # ice2 is zeroed without adding to water, as in the reference
    warm = (obs > p.t_lim_melt_ice) & (s[3] > 0)
    assert warm.any() and not got.ice2.numpy()[warm].any()


def _cof_inputs(P=24, T=40, seed=4):
    rng = np.random.default_rng(seed)
    sw = rng.uniform(-0.4, 0.6, P)
    lw = rng.uniform(-0.4, 0.6, P)
    end = rng.integers(1, T, P).astype(np.int32)
    end[::5] = -99                         # no window
    end[1] = T - 1                         # a window ending at the last row
    return sw, lw, end


@pytest.mark.parametrize("t_offset,tc", [(0, 40), (17, 9), (39, 1)])
def test_cof_window_matches_jax(t_offset, tc):
    """Rows [t_offset, t_offset + tc) of a T = 40 run; the last case is the
    lastValues row alone."""
    T = 40
    sw, lw, end = _cof_inputs(T=T)
    settings = ModelSettings(sim_len=T, dt=30.0)
    want = cof_window(jnp.asarray(sw), jnp.asarray(lw), end, t_offset, tc,
                      T, settings, jnp.float64)
    got = tforcing.cof_window(_t(sw), _t(lw), _t(end), t_offset, tc, T,
                              interop.settings(settings), torch.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL12)
    if t_offset + tc == T:
        # the lastValues row reuses the step-(T-1) value: the undecayed
        # trial coefficient where the window ends at T-1, not 1
        assert got[0][-1, 1] == 1.0 + sw[1]


def test_cof_schedule_matches_jax():
    T = 40
    sw, lw, end = _cof_inputs(T=T)
    settings = ModelSettings(sim_len=T, dt=30.0)
    want = cof_schedule(jnp.asarray(sw), jnp.asarray(lw), end, T, settings,
                        jnp.float64)
    got = tforcing.cof_schedule(_t(sw), _t(lw), _t(end), T,
                                interop.settings(settings), torch.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL12)


# inputs of Coupling_control that reach each branch (src/Coupling.f90:
# 292-481): overrides of the base state, the surface temperature's offset
# from the obs (K), and what the branch must leave behind
CONTROL_CASES = {
    "max_iterations": (dict(iterations=25), 1.0,
                       lambda cv: cv.failed.all()),
    "missing_obs": (dict(obs=-9999.9), 1.0,
                    lambda cv: cv.failed.all() and cv.again.all()),
    "abnormal": (dict(tsurf=-150.0), None,
                 lambda cv: cv.failed.all() and cv.again.all()),
    "above": (dict(), 1.0, lambda cv: (cv.radcoeff == 0.5).all()),
    "above_secant": (dict(t_below=-0.5, radc_below=1.5), 1.0,
                     lambda cv: ((cv.radcoeff > 1.0)
                                 & (cv.radcoeff < 1.5)).all()),
    "below": (dict(), -1.0, lambda cv: (cv.radcoeff == 2.0).all()),
    "stuck": (dict(radc_prev=0.50001), 1.0,
              lambda cv: (cv.t_above < -100.0).all()),
    "too_small": (dict(radcoeff=0.015), 1.0,
                  lambda cv: cv.failed.all() and (cv.radcoeff == 1.0).all()),
    "success": (dict(radcoeff=1.3), 0.05,
                lambda cv: (~cv.failed).all() and (cv.iterations == 0).all()),
    "success_radcoeff_above_3": (
        dict(radcoeff=3.5), 0.0,
        lambda cv: (~cv.failed).all() and (cv.sw_cof == 1.0).all()
        and (cv.lw_corr == 0.0).all()),
}


def _control_inputs(case, n=4, seed=9):
    over, offset, _ = CONTROL_CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda v: np.full(n, v, np.float64)
    obs = f(over["obs"]) if "obs" in over else rng.uniform(-5.0, 5.0, n)
    tsurf = (f(over["tsurf"]) if "tsurf" in over
             else np.where(obs > -100.0, obs, 1.0) + offset)
    cv = dict(sw_cof=f(1.2), lw_cof=f(0.9), sw_corr=f(0.2), lw_corr=f(-0.1),
              radcoeff=f(1.0), radc_above=f(-9999.0), radc_below=f(-9999.0),
              radc_prev=f(1.0), t_above=f(-9999.0), t_below=f(-9999.0),
              tsurf_end1=f(270.0), iterations=np.full(n, 3, np.int32),
              again=np.zeros(n, bool), failed=np.zeros(n, bool))
    for k, v in over.items():
        if k in ("t_above", "t_below"):
            cv[k] = obs + v + tcoupling.K0
        elif k in cv:
            cv[k] = np.full(n, v, cv[k].dtype)
    do = np.array([True] * (n - 1) + [False])
    return tsurf, obs, cv, do


@pytest.mark.parametrize("case", list(CONTROL_CASES))
def test_coupling_control_matches_jax(case):
    tsurf, obs, cv, do = _control_inputs(case)
    jcv = jcoupling.CouplingVars(**{k: jnp.asarray(v) for k, v in cv.items()})
    want = jcoupling.coupling_control(jnp.asarray(tsurf), jnp.asarray(obs),
                                      jcv, jnp.asarray(do))
    got = tcoupling.coupling_control(
        _t(tsurf), _t(obs), interop.coupling_vars(jcv, device="cpu"),
        _t(do))
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=name, **TOL12)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the branch was taken where `do`, and nothing moved elsewhere
    done = tcoupling.CouplingVars(*(x[:-1] for x in got))
    assert CONTROL_CASES[case][2](done), case
    for name, g in zip(got._fields, got):
        np.testing.assert_array_equal(g.numpy()[-1], cv[name][-1],
                                      err_msg=name)


def _coupled_case(scenario, seed, sim_len=241, obs_shift=0.0,
                  coupling_minutes=60, use_relaxation=False, sky_view=None):
    """tests/test_parity_coupled.py:17-35 with the 721-step synthetic
    forcing cut to its first ``sim_len`` steps (its hourly obs stop at step
    240, so a shorter synthetic run would have no coupling window)."""
    settings = ModelSettings(sim_len=sim_len, dt=30.0, use_coupling=True,
                             use_relaxation=use_relaxation,
                             coupling_minutes=coupling_minutes)
    raw, cal = synthetic_raw(4, 721, dt=30.0, seed=seed, scenario=scenario)
    raw = RawForcing(*(np.asarray(x)[:, :sim_len] for x in raw))
    cal = Calendar(*(np.asarray(x)[:sim_len] for x in cal))
    if obs_shift:
        obs = np.asarray(raw.tsurf_obs).copy()
        obs[obs > -100.0] += obs_shift
        raw = raw._replace(tsurf_obs=obs)
    obs_tair = np.where(np.asarray(raw.tsurf_obs) > -100.0,
                        np.asarray(raw.tair), -9999.9)
    pts, blanked = derive_point_params(raw, settings, obs_tair=obs_tair)
    raw = raw._replace(tsurf_obs=blanked)
    if sky_view is not None:
        pts = pts._replace(sky_view=np.full(4, sky_view))
    assert (pts.coupling_end >= 1).all(), "coupling must be active"
    return settings, raw, pts, cal


@pytest.mark.parametrize("scenario,seed,obs_shift", [
    ("winter_mix", 11, 0.0), ("winter_mix", 13, 4.0)])
def test_run_coupled_matches_jax(scenario, seed, obs_shift):
    settings, raw, pts, cal = _coupled_case(scenario, seed,
                                            obs_shift=obs_shift)
    jfinal, jout = Model(settings).run_coupled(raw, pts, cal)
    tfinal, tout = tmodel.Model(interop.settings(settings), device="cpu").run_coupled(
        raw, pts, cal)
    assert tout.dtype == torch.float64
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL9)
    for name in ("tmp", "tsurf_ave", "wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(getattr(tfinal, name).numpy(),
                                   np.asarray(getattr(jfinal, name)),
                                   err_msg=name, **TOL9)
    assert np.array_equal(tfinal.failed.numpy(), np.asarray(jfinal.failed))


def test_run_coupled_matches_golden():
    """The coupled golden: 241 steps, window ending at 120, obs 1.2 K below
    the air (tests/test_golden.py:84-105)."""
    golden = np.load(GOLDEN)
    sc = "winter_mix"
    keys = ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw", "sw_dir",
            "lw_net", "tsurf_obs", "prec_phase")
    raw = RawForcing(*(np.asarray(golden[f"{sc}/{k}"]) for k in keys))
    T, n = 241, 2
    settings = ModelSettings(sim_len=T, dt=30.0, use_coupling=True)
    clen = settings.coupling_len_steps
    start = 1 if 120 <= clen else 120 - clen   # initCouplingTimes
    pts = default_point_params(n, init_len=12)._replace(
        lat=np.array([61.0, 62.0]), lon=np.array([24.0, 25.0]),
        coupling_start=np.full(n, start, np.int32),
        coupling_end=np.full(n, 120, np.int32),
        coupling_tsurf=np.asarray(raw.tair)[:, 119] - 1.2)
    _, out = tmodel.Model(interop.settings(settings), device="cpu").run_coupled(
        raw, pts, Calendar.from_epochs(golden["epochs"]))
    for pnt in range(n):
        np.testing.assert_allclose(out[:, pnt].numpy(),
                                   golden[f"{sc}/coupled/p{pnt}"],
                                   err_msg=f"p{pnt}", **TOL9)


@pytest.mark.parametrize("kw", [
    dict(scenario="winter_mix", seed=13, obs_shift=4.0),
    dict(scenario="warm_rain", seed=14, obs_shift=-4.0, out_stride=3,
         wchunk=7),
    dict(scenario="winter_mix", seed=15, use_relaxation=True,
         sky_view=0.6, obs_shift=2.0),
    # the window ends at the last simulated step (T - 1 = 120): no rewind
    # there, and the lastValues step reuses the undecayed coefficient
    dict(scenario="winter_mix", seed=16, sim_len=121, coupling_minutes=30),
    # one window chunk larger than the window
    dict(scenario="cold_snow", seed=12, wchunk=4096),
], ids=["rewinds", "stride3-wchunk7", "relax-skyview", "window-to-end",
        "single-chunk"])
def test_segmented_matches_pc_bitwise(kw):
    out_stride = kw.pop("out_stride", 1)
    wchunk = kw.pop("wchunk", 16)
    settings, raw, pts, cal = _coupled_case(**kw)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    final_pc, out_pc = tm.run_coupled(raw, pts, cal, out_stride=out_stride)
    prep = tm.prepare(raw, pts, cal)
    state = tm.init(raw, cal, dtype=prep.tair.dtype, pts=pts)
    final_seg, out_seg = tcoupling.run_coupled_segmented(
        state, prep, tm.point_tensors(pts), tm.settings, tm.cfg, tm.grid,
        tm.params, out_stride=out_stride, wchunk=wchunk)
    assert out_seg.dtype == torch.float64
    assert torch.equal(out_seg, out_pc)
    for name in final_pc._fields:
        assert torch.equal(getattr(final_seg, name),
                           getattr(final_pc, name)), name
