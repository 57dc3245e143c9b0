"""Frozen copy of ``roadsurf_tpu_torch/physics/sun.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Solar position (Meeus astronomical algorithms), fully vectorized.

Re-derivation of src/SunPosition.f90 (JulianEphemerisDay :196-260,
calcElevationAzimuth :20-194); the counterpart of
``roadsurf_tpu/physics/sun.py``.  The Julian day stays numpy on the host; the
elevation/azimuth pass runs as torch ops over a [T?, P?] broadcast during
forcing preparation -- the astronomy never lives inside the sequential scan.

Elevation <= 0 yields the reference's -9999.9 sentinels.  The reference
``stop``s on |cos| > 1.001; we clamp instead (a failure mask is the framework's
error-signalling mechanism, not process aborts).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MISSING = -9999.9


def julian_ephemeris_day(year, month, day, hour, minute, second):
    """Julian Ephemeris Day (Meeus ch. 7; src/SunPosition.f90:196-260).

    Accepts numpy integer arrays; returns float64 numpy (host-side prep).
    """
    year = np.asarray(year, dtype=np.int64)
    month = np.asarray(month, dtype=np.int64)
    early = month <= 2
    yr = np.where(early, year - 1, year).astype(np.float64)
    mo = np.where(early, month + 12, month).astype(np.float64)
    day_f = (np.asarray(day, np.float64) + np.asarray(hour, np.float64) / 24.0
             + np.asarray(minute, np.float64) / 1440.0
             + np.asarray(second, np.float64) / 86400.0)
    a = np.trunc(yr / 100.0)
    b = 2.0 - a + np.trunc(a / 4.0)
    return (np.trunc(365.25 * (yr + 4716.0)) + np.trunc(30.6001 * (mo + 1.0))
            + day_f + b - 1524.5)


def _wrap_to(x, period):
    """Reference-style wrapping: if x<0: x -= period*(AINT(x/period)-1);
    if x>period: x -= period*AINT(x/period)  (SunPosition.f90:78-79 etc)."""
    x = torch.where(x < 0.0, x - period * (torch.trunc(x / period) - 1.0), x)
    x = torch.where(x > period, x - period * torch.trunc(x / period), x)
    return x


def sun_time_terms(jde):
    """The time-only part of the sun position (SunPosition.f90:20-120):
    ``(sin_decl, cos_decl, stg, ra)`` of the declination, the Greenwich
    mean sidereal time and the right ascension (radians), each the shape and
    dtype of ``jde``.  Pass the float64 day: at 2.46e6 a float32 day steps
    by 0.25 day, and ``stg`` is about 2.6e6 degrees before its wrap, so
    these terms are formed in float64 and only the per-point part
    (:func:`sun_at_points`) runs in the run dtype."""
    pi = math.pi

    t = (jde - 2451545.0) / 36525.0
    # geometric mean longitude
    ml = 280.46645 + 36000.76983 * t + 0.0003032 * t * t
    ml = _wrap_to(ml, 360.0)
    # mean anomaly
    ma = 357.52910 + 35999.05030 * t - 0.0001559 * t * t - 0.00000048 * t ** 3
    ma = _wrap_to(ma, 360.0)
    # equation of center
    mar = ma * pi / 180.0
    sunc = ((1.913600 - 0.004817 * t - 0.000014 * t * t) * torch.sin(mar)
            + (0.019993 - 0.000101 * t) * torch.sin(2.0 * mar)
            + 0.000290 * torch.sin(3.0 * mar))
    # apparent longitude
    al = (ml + sunc - 0.00569
          - 0.00478 * torch.sin((125.04 - 1934.136 * t) * pi / 180.0))
    al = al * pi / 180.0
    # obliquity
    tilt = (23.43929111 - 0.013004166 * t - 0.001638888 * t * t
            + 0.005036111 * t ** 3)
    eps = (tilt + 0.00256 * torch.cos((125.04 - 1934.136 * t) * pi / 180.0)
           ) * pi / 180.0
    # right ascension
    ra = torch.atan2(torch.cos(eps) * torch.sin(al), torch.cos(al))
    ra = _wrap_to(ra, 2.0 * pi)
    # declination
    decl = torch.asin(torch.sin(eps) * torch.sin(al))
    # Greenwich mean sidereal time
    stg = (280.46061837 + 360.98564736629 * (jde - 2451545.0)
           + 0.000387933 * t * t - t ** 3 / 38710000.0)
    stg = _wrap_to(stg, 360.0) * pi / 180.0
    return torch.sin(decl), torch.cos(decl), stg, ra


def sun_at_points(sin_decl, cos_decl, stg, ra, lat, lon):
    """Solar elevation and azimuth (degrees) from :func:`sun_time_terms`,
    broadcast against the ``lat``/``lon`` tensors, in their dtype
    (SunPosition.f90:121-194).  Returns (elevation_deg, azimuth_deg) with
    -9999.9 where the sun is below the horizon."""
    pi = math.pi
    latr = pi * lat / 180.0
    sin_lat = torch.sin(latr)
    cos_lat = torch.cos(latr)

    ha = stg + lon * pi / 180.0 - ra
    # the reference wraps the hour angle conditioned on ra (a quirk of
    # SunPosition.f90:134-135); left unwrapped here and wrapped below
    # exactly as :157-161 (sun.py:95-98 of the JAX package)
    cosah = torch.cos(ha)
    cos_elev = sin_decl * sin_lat + cos_decl * cos_lat * cosah
    cos_elev = torch.clamp(cos_elev, -1.0, 1.0)
    chi = torch.acos(cos_elev)
    elevation = 90.0 - chi * 180.0 / pi

    ha = torch.where(ha < 0.0, 2.0 * pi + ha, ha)
    ha = torch.where(ha > 2.0 * pi, ha - 2.0 * pi, ha)

    cosele = torch.cos(pi / 2.0 - chi)
    small = torch.abs(cosele) < 1e-4
    safe_cosele = torch.where(small, torch.ones_like(cosele), cosele)
    precos = (sin_decl * cos_lat - cos_decl * sin_lat * cosah) / safe_cosele
    precos = torch.clamp(precos, -1.0, 1.0)
    azim = torch.acos(precos)
    azim = torch.where(ha < pi, 2.0 * pi - azim, azim)
    azim_deg = azim * 180.0 / pi
    azim_deg = torch.where(small, torch.full_like(azim_deg, MISSING),
                           azim_deg)

    up = elevation > 0.0
    miss = torch.full_like(elevation, MISSING)
    return (torch.where(up, elevation, miss),
            torch.where(up, azim_deg, miss))

