"""Generate the example2 input data set: a gridded NWP forecast (npz, the
querydata-file equivalent -- roadsurf_tpu/io/gridsource.py), an ASCII road
observation file (examples/example2/src/AsciiSource.cpp column format), an
ASCII character mask, and an expression-mask static grid.

Frozen copy of ``examples/example2/make_data.py`` (commit 56b3c41), the
benchmark's traffic generator for the NWP-grid deployment; its one change
is ``--seed``, which draws the phases of the synoptic and wind cycles and
the time of the precipitation front (the original fixes them), so every
seed gives the same sizes and a different weather.

Usage:  python example2.py [--now 201912020000] [--analysis 12]
                           [--forecast 24] [--ny 12 --nx 16] [--seed 0]
                           [--outdir DIR]
"""
from __future__ import annotations

import argparse
import calendar
import os
import time as timelib

import numpy as np


def weather_grid(epochs, lats, lons, phase=(0.0, 0.0, 0.5)):
    t = np.asarray(epochs, np.float64)[:, None, None]
    la = np.asarray(lats)[None, :, None]
    lo = np.asarray(lons)[None, None, :]
    hours = (t % 86400) / 3600.0
    days = (t - t.flat[0]) / 86400.0
    diurnal = np.cos((hours - 14.0) / 24.0 * 2 * np.pi)
    p_syn, p_wind, front = phase
    tair = -2.0 + 4.0 * diurnal + 1.5 * np.sin(days * 2.0 + p_syn) \
        + 0.8 * (la - la.mean()) - 0.3 * (lo - lo.mean())
    rh = np.clip(85.0 - 8.0 * diurnal, 55.0, 100.0) + 0.0 * lo
    vz = np.clip(3.5 + 1.2 * np.sin(days * 4.0 + lo / 3.0 + p_wind), 0.4,
                 None)
    x = (days / max(days.max(), 1e-9) - front) / 0.15
    prec = np.clip(1.2 * np.exp(-x * x) + 0.0 * la, 0, None)
    prec[prec < 0.05] = 0.0
    elev = (np.sin(np.radians(la)) * -0.404
            + np.cos(np.radians(la)) * 0.915
            * np.cos(np.radians(15.0 * (hours - 12.0) + lo - 25.0)))
    sw = np.clip(1000.0 * elev, 0.0, None) * (1.0 - 0.5 * (prec > 0.1))
    lw = 5.67e-8 * (tair + 273.15) ** 4 * (0.74 + 0.2 * (prec > 0.05))
    shape = np.broadcast_shapes(tair.shape, rh.shape, vz.shape, prec.shape,
                                sw.shape, lw.shape)
    return {k: np.broadcast_to(v, shape).copy() for k, v in
            dict(tair=tair, rhz=rh, vz=vz, prec=prec, sw=sw, lw=lw).items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--now", default="201912020000")
    ap.add_argument("--analysis", type=int, default=12, help="hours")
    ap.add_argument("--forecast", type=int, default=24, help="hours")
    ap.add_argument("--ny", type=int, default=12)
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--seed", type=int, default=None,
                    help="None: the original's fixed weather")
    ap.add_argument("--outdir", default=os.path.dirname(__file__) or ".")
    args = ap.parse_args(argv)
    od = args.outdir

    now = calendar.timegm(timelib.strptime(args.now, "%Y%m%d%H%M"))
    start = now - args.analysis * 3600
    end = now + args.forecast * 3600
    if args.seed is None:
        phase = (0.0, 0.0, 0.5)
    else:
        rng = np.random.default_rng(abs(args.seed))
        phase = (float(rng.uniform(0, 2 * np.pi)),
                 float(rng.uniform(0, 2 * np.pi)),
                 float(rng.uniform(0.35, 0.65)))
    lats = np.linspace(59.8, 61.0, args.ny)
    lons = np.linspace(24.0, 26.5, args.nx)

    # gridded forecast, hourly (the querydata 'file' source)
    fc_t = np.arange(start, end + 1, 3600)
    fields = weather_grid(fc_t, lats, lons, phase)
    np.savez_compressed(os.path.join(od, "forecast_grid.npz"),
                        times=fc_t, lats=lats, lons=lons,
                        **{k: v.astype(np.float32) for k, v in
                           fields.items()})

    # one road station's ASCII observations over the analysis window
    # (AsciiSource row: yy mm dd hh tair rh vz rr1h rform srad lrad tsurf)
    obs_t = np.arange(start, now + 1, 3600)
    iy, ix = len(lats) // 2, len(lons) // 2
    w = weather_grid(obs_t, lats[iy:iy + 1], lons[ix:ix + 1], phase)
    rows = []
    for i, e in enumerate(obs_t):
        g = timelib.gmtime(int(e))
        tair = float(w["tair"][i, 0, 0])
        rows.append(
            f"{g.tm_year % 100:02d} {g.tm_mon:02d} {g.tm_mday:02d} "
            f"{g.tm_hour:02d} {tair - 0.4:6.1f} "
            f"{float(w['rhz'][i, 0, 0]):5.1f} "
            f"{float(w['vz'][i, 0, 0]):4.1f} "
            f"{float(w['prec'][i, 0, 0]):5.2f} 0 "
            f"{float(w['sw'][i, 0, 0]):6.1f} "
            f"{float(w['lw'][i, 0, 0]):6.1f} {tair - 1.1:6.1f}")
    with open(os.path.join(od, "road_station.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")

    # ASCII character mask (roadrunner.cpp:331-408): keep a road corridor
    ny, nx = args.ny, args.nx
    mask = np.full((ny, nx), "0")
    for j in range(nx):
        i = int(round(ny * 0.3 + ny * 0.4 * j / max(nx - 1, 1)))
        mask[max(i - 1, 0):i + 2, j] = "1"
    with open(os.path.join(od, "road_mask.txt"), "w") as f:
        f.write("\n".join("".join(r) for r in mask) + "\n")

    # static-field grid for the expression mask (querydata expression masks,
    # roadrunner.cpp:272-323): keep low-elevation cells near the coast
    glat, glon = np.meshgrid(lats, lons, indexing="ij")
    elevation = 20.0 + 180.0 * (glat - lats[0]) / (lats[-1] - lats[0])
    np.savez_compressed(os.path.join(od, "static_grid.npz"),
                        times=np.array([start]), lats=lats, lons=lons,
                        elevation=elevation[None],
                        landcover=np.ones((1, ny, nx)))
    print(f"Wrote forecast_grid.npz ({len(fc_t)}x{ny}x{nx}), "
          f"road_station.txt ({len(rows)} rows), road_mask.txt, "
          f"static_grid.npz")


if __name__ == "__main__":
    main()
