"""Generate the example1 input data set.

Frozen copy of ``examples/example1/make_data.py`` (commit 56b3c41), the
benchmark's traffic generator for the station deployment.  Its changes:
``--seed`` seeds the stations' positions and weather phases (the original
fixes it at 7), and ``--bbox LAT0,LON0,LAT1,LON1`` places the stations
on a jittered 2-D lattice inside that box, where the original stepped
each station 0.35 deg north and 0.55 deg east of the last, a layout made
for its 8 stations that leaves the globe's latitudes past its 86th.

The reference repository ships ``example_forecast.json`` and
``example_observations.json`` for its example1 driver (stripped from this
mirror); this script regenerates an equivalent deterministic data set in
the same station-JSON schema
(examples/example1/src/JsonSource.cpp:191-199: ``statId``/``lat``/``lon``/
``time`` plus named variable arrays) so the example is runnable end to end.

Usage:
    python example1.py [--stations 8] [--analysis 24] [--forecast 48]
                       [--now 201912020000] [--seed 7] [--outdir DIR]
                       --bbox LAT0,LON0,LAT1,LON1

Writes example_observations.json (10-min road-station observations over the
analysis window), example_forecast.json (hourly NWP forecast over the whole
window), skyview.txt and horizons.txt (examples/example1/src/SkyView.cpp
formats).
"""
from __future__ import annotations

import argparse
import calendar
import json
import os
import time as timelib

import numpy as np


def fmt(epochs):
    return [timelib.strftime("%Y-%m-%d %H:%M", timelib.gmtime(int(e)))
            for e in epochs]


def lattice_shape(n, bbox):
    """(rows, cols) of ``n`` stations over ``bbox``: the divisor pair of
    ``n`` whose cells come closest to square in kilometres."""
    lat0, lon0, lat1, lon1 = bbox
    h = lat1 - lat0
    w = (lon1 - lon0) * np.cos(np.radians(0.5 * (lat0 + lat1)))
    rows = min((r for r in range(1, n + 1) if n % r == 0),
               key=lambda r: abs(np.log(r * r * w / (n * h))))
    return rows, n // rows


def position(k, n, rng, bbox):
    """Station ``k``'s (lat, lon): the cell centre of a ``lattice_shape``
    lattice over ``bbox``, moved by up to a quarter of a cell each way."""
    du, dv = float(rng.uniform(-0.05, 0.05)), float(rng.uniform(-0.05, 0.05))
    lat0, lon0, lat1, lon1 = bbox
    rows, cols = lattice_shape(n, bbox)
    i, j = divmod(k, cols)
    return (lat0 + (i + 0.5 + 5.0 * du) * (lat1 - lat0) / rows,
            lon0 + (j + 0.5 + 5.0 * dv) * (lon1 - lon0) / cols)


def weather(rng, epochs, lat, lon, seed_phase):
    """Deterministic wintry weather: diurnal temperature through 0 C,
    mixed precipitation, clear/cloudy spells."""
    t = np.asarray(epochs, np.float64)
    hours = (t % 86400) / 3600.0
    days = (t - t[0]) / 86400.0
    diurnal = np.cos((hours - 14.0) / 24.0 * 2 * np.pi)
    tair = -1.5 + 4.0 * diurnal + 1.2 * np.sin(days * 2.1 + seed_phase)
    rh = np.clip(86.0 - 10.0 * diurnal + 4.0 * np.sin(days * 3.3), 55., 100.)
    vz = np.clip(3.0 + 1.5 * np.sin(days * 5.0 + seed_phase), 0.4, None)
    # precipitation: two frontal passages
    prec = np.zeros_like(t)
    for c, w, r in ((0.25, 0.08, 0.8), (0.9, 0.12, 1.6)):
        x = (days / max(days[-1], 1e-9) - c) / w
        prec += r * np.exp(-x * x)
    prec[prec < 0.05] = 0.0
    # shortwave from a crude solar elevation proxy (December, ~60N)
    elev = (np.sin(np.radians(lat)) * -0.404
            + np.cos(np.radians(lat)) * 0.915
            * np.cos(np.radians(15.0 * (hours - 12.0) + lon - 25.0)))
    sw = np.clip(1000.0 * elev, 0.0, None) * (1.0 - 0.6 * (prec > 0.1))
    cloud = np.clip(0.3 + 0.6 * (prec > 0.05), 0.0, 1.0)
    lw = 5.67e-8 * (tair + 273.15) ** 4 * (0.72 + 0.22 * cloud)
    return tair, rh, vz, prec, sw, lw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=8)
    ap.add_argument("--analysis", type=int, default=24, help="hours")
    ap.add_argument("--forecast", type=int, default=48, help="hours")
    ap.add_argument("--now", default="201912020000")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--outdir", default=os.path.dirname(__file__) or ".")
    ap.add_argument("--bbox", required=True,
                    help="LAT0,LON0,LAT1,LON1, the stations' box")
    args = ap.parse_args(argv)
    bbox = tuple(float(x) for x in args.bbox.split(","))

    now = calendar.timegm(timelib.strptime(args.now, "%Y%m%d%H%M"))
    start = now - args.analysis * 3600
    end = now + args.forecast * 3600
    rng = np.random.default_rng(abs(args.seed))

    obs_doc, fc_doc, sky_rows, hor_rows = [], [], [], []
    for k in range(args.stations):
        sid = 1001 + k
        lat, lon = position(k, args.stations, rng, bbox)
        phase = float(rng.uniform(0, 2 * np.pi))

        # observations: 10-min cadence, analysis window only
        obs_t = np.arange(start, now + 1, 600)
        tair, rh, vz, prec, sw, lw = weather(rng, obs_t, lat, lon, phase)
        tsurf = tair - 0.8 + 1.5 * np.clip(sw / 400.0, 0, 1)
        obs_doc.append({
            "statId": sid, "lat": round(lat, 4), "lon": round(lon, 4),
            "time": fmt(obs_t),
            "Temperature 2m": np.round(tair, 2).tolist(),
            "Humidity": np.round(rh, 1).tolist(),
            "WindSpeed": np.round(vz, 2).tolist(),
            "Precipitation": np.round(prec * 600 / 3600, 3).tolist(),
            "RoadTemperature": np.round(tsurf, 2).tolist(),
        })

        # forecast: hourly over the full window, radiation included
        fc_t = np.arange(start, end + 1, 3600)
        tair, rh, vz, prec, sw, lw = weather(rng, fc_t, lat, lon, phase)
        fc_doc.append({
            "statId": sid, "lat": round(lat, 4), "lon": round(lon, 4),
            "time": fmt(fc_t),
            "Temperature 2m": np.round(tair + 0.3, 2).tolist(),
            "Humidity": np.round(rh, 1).tolist(),
            "WindSpeed": np.round(vz, 2).tolist(),
            "Precipitation": np.round(prec, 3).tolist(),
            "RadiationGlobal": np.round(sw, 1).tolist(),
            "RadiationLW": np.round(lw, 1).tolist(),
            # direct SW + net surface LW: required by CheckValues when a
            # sky view < 1 is active (src/InputOutput.f90:55-82)
            "RadiationDirectSW": np.round(
                sw * np.where(prec > 0.1, 0.15, 0.8), 1).tolist(),
            "RadiationNetSurfaceLW": np.round(
                lw - 5.67e-8 * (tair + 272.0) ** 4, 1).tolist(),
        })

        # half the stations get urban-canyon sky-view restriction
        if k % 2 == 0:
            svf = 0.85 - 0.05 * (k // 2)
            sky_rows.append(f"{sid} station{sid} {lat:.4f} {lon:.4f} "
                            f"{svf:.2f}")
            horizon = np.zeros(360)
            horizon[60:120] = 12.0 + 2.0 * (k // 2)   # obstacle to the ENE
            hor_rows.append(f"{sid} station{sid} {lat:.4f} {lon:.4f} "
                            + " ".join(f"{h:.1f}" for h in horizon))

    od = args.outdir
    with open(os.path.join(od, "example_observations.json"), "w") as f:
        json.dump(obs_doc, f)
    with open(os.path.join(od, "example_forecast.json"), "w") as f:
        json.dump(fc_doc, f)
    with open(os.path.join(od, "skyview.txt"), "w") as f:
        f.write("\n".join(sky_rows) + "\n")
    with open(os.path.join(od, "horizons.txt"), "w") as f:
        f.write("\n".join(hor_rows) + "\n")
    print(f"Wrote {args.stations} stations: observations "
          f"({args.analysis} h @ 10 min), forecast "
          f"({args.analysis + args.forecast} h @ 1 h), skyview, horizons")


if __name__ == "__main__":
    main()
