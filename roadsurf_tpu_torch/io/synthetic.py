"""Deterministic synthetic forcing generator (numpy; a copy of
``roadsurf_tpu/io/synthetic.py``).

Used by tests and benchmarks (the reference repo's example forcing JSONs are
stripped from the mirror -- see .MISSING_LARGE_BLOBS -- so parity testing is
done oracle-vs-vectorized on synthetic weather that exercises every physics
regime: freeze/thaw crossings, rain, snow, sleet, night frost, windy/calm).
"""
from __future__ import annotations

import numpy as np

from ..config import ModelSettings
from ..forcing import Calendar, RawForcing
from ..physics.moisture import tdew_from_rh


def synthetic_raw(npoints: int, sim_len: int, dt: float = 30.0,
                  seed: int = 0, start_epoch: int = 1575244800,
                  scenario: str = "winter_mix", dtype=np.float64):
    """Returns (RawForcing [P, T], Calendar [T]).

    start_epoch default = 2019-12-02T00:00Z (the reference example's -t).
    Scenarios:
      winter_mix  -- temperatures oscillating through 0 C, mixed precip
      cold_snow   -- steadily below freezing with snowfall
      warm_rain   -- above freezing with rain
    """
    rng = np.random.default_rng(seed)
    t_hours = (np.arange(sim_len) * dt) / 3600.0   # [T]
    cal = Calendar.from_start(start_epoch, dt, sim_len)

    # per-point phase/amplitude variation
    phase = rng.uniform(0, 2 * np.pi, size=(npoints, 1))
    amp = rng.uniform(2.0, 6.0, size=(npoints, 1))
    base = {"winter_mix": -1.0, "cold_snow": -8.0, "warm_rain": 6.0}[scenario]
    base = base + rng.uniform(-1.5, 1.5, size=(npoints, 1))

    hour_of_day = (cal.hour + cal.minute / 60.0)[None, :]
    diurnal = np.cos((hour_of_day - 14.0) / 24.0 * 2 * np.pi)
    tair = base + amp * diurnal + 0.5 * np.sin(t_hours[None, :] / 7.0 + phase)

    rhz = np.clip(80.0 + 15.0 * np.sin(t_hours[None, :] / 5.0 + phase) +
                  rng.normal(0, 2.0, size=(npoints, sim_len)), 40.0, 100.0)
    vz = np.clip(3.0 + 2.0 * np.sin(t_hours[None, :] / 9.0 + 2 * phase) +
                 rng.normal(0, 0.3, size=(npoints, sim_len)), 0.0, 20.0)

    # radiation: day-time SW bell, winter-ish LW
    sun_up = np.clip(np.cos((hour_of_day - 12.0) / 24.0 * 2 * np.pi), 0.0, None)
    sw = 250.0 * sun_up ** 1.5 * (1.0 + 0.1 * np.sin(phase))
    sw = np.broadcast_to(sw, (npoints, sim_len)).copy()
    sw_dir = 0.7 * sw
    lw = (280.0 + 30.0 * np.sin(t_hours[None, :] / 11.0 + phase)
          + 2.0 * tair)
    lw = np.clip(lw, 150.0, 420.0)
    lw_net = lw - (300.0 + 10.0 * np.sin(t_hours[None, :] / 6.0))

    # precipitation episodes: a few hours of precip per day
    episode = (np.sin(t_hours[None, :] / 4.0 + 3 * phase) > 0.75)
    prec = np.where(episode, rng.gamma(2.0, 0.5, size=(npoints, sim_len)), 0.0)
    prec = np.clip(prec, 0.0, 8.0)  # mm/h
    if scenario == "cold_snow":
        prec = prec * 1.5
    prec_phase = np.full((npoints, sim_len), -9999, dtype=np.int64)
    # half the points get explicit phase codes, the rest use Koistinen
    coded = rng.random(npoints) < 0.5
    codes = np.where(tair < -0.5, 3, np.where(tair > 1.0, 1, 2))
    prec_phase[coded] = codes[coded]

    tdew = np.asarray(tdew_from_rh(tair, rhz))

    # sparse surface temperature observations: first third of the window,
    # hourly, equal to a plausible surface temp
    tsurf_obs = np.full((npoints, sim_len), -9999.9)
    obs_until = sim_len // 3
    hourly = (np.arange(sim_len) % max(1, int(3600 / dt))) == 0
    obs_mask = hourly & (np.arange(sim_len) < obs_until)
    tsurf_sim = tair - 1.5 + 2.0 * sun_up
    tsurf_obs[:, obs_mask] = np.broadcast_to(
        tsurf_sim, (npoints, sim_len))[:, obs_mask]

    as_t = lambda x: np.ascontiguousarray(np.broadcast_to(x, (npoints, sim_len)), dtype=dtype)
    raw = RawForcing(
        tair=as_t(tair), tdew=as_t(tdew), vz=as_t(vz), rhz=as_t(rhz),
        prec=as_t(prec), sw=as_t(sw), lw=as_t(lw), sw_dir=as_t(sw_dir),
        lw_net=as_t(lw_net), tsurf_obs=as_t(tsurf_obs),
        prec_phase=prec_phase)
    return raw, cal


def settings_for(sim_len: int, dt: float = 30.0, **kw) -> ModelSettings:
    return ModelSettings(sim_len=sim_len, dt=dt, **kw)
