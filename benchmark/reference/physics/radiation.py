"""Frozen copy of ``roadsurf_tpu_torch/physics/radiation.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Net radiation and sky-view / local-horizon radiation modification.

Re-derivation of CalcRNet (src/BalanceModel.f90:282-307) and
ModRadiationBySurroundings (src/ModRadiation.f90:7-73, after Senkova et al.
2007); the counterpart of ``roadsurf_tpu/physics/radiation.py``.  The sky-view
modification is a pure function of (time, location, forcing), so it runs as
one vectorized [T, P] pass during forcing prep.
"""
from __future__ import annotations

import torch

from ..config import PhysicsParams


def net_radiation(tsurf, albedo, sw, lw, sw_cof, lw_cof, p: PhysicsParams):
    """RNet = (1-albedo)*SW*SwCof + emiss*LW*LwCof - emiss*sigma*T_K^4
    (src/BalanceModel.f90:282-307)."""
    tk = tsurf + 273.15
    tk2 = tk * tk
    rbb = p.emiss * p.sb_const * (tk2 * tk2)
    return (1.0 - albedo) * sw * sw_cof + p.emiss * lw * lw_cof - rbb


def modify_radiation(sw, sw_dir, lw, lw_net, elev, azim, sky_view,
                     horizons, p: PhysicsParams, flat_horizons: bool = False,
                     time_axis: int = 0):
    """Sky-view/horizon correction of the radiation forcing
    (src/ModRadiation.f90:7-73).

    sw/sw_dir/lw/lw_net/elev/azim: one layout with time on ``time_axis``
    and the point axes on the others ([T, P], or the kernel's tile layout
    [n_tiles, T, TP] with ``time_axis=1``; elev/azim from
    sun.sun_at_points); sky_view broadcastable against them;
    horizons: [*point_shape, 360] local horizon angles (degrees per azimuth
    degree), or one shared [360] table; flat_horizons: all-zero horizons,
    known ahead, so the table is not read.

    Returns (sw_mod, lw_mod).  The caller applies this only where
    0 <= sky_view < 1, matching the reference's guard
    (examples/example1/src/Simulation.f90:152-155).
    """
    dif_sw = sw - sw_dir
    lw_surroundings = lw_net - lw

    # nearest-degree horizon lookup (ModRadiation.f90:40-45): round half to
    # even, floor-mod 360 (the -9999.9 below-horizon sentinel included),
    # clamp -- the index rule of radiation.py:55.  The reference reads out
    # of bounds when the sun is below the horizon but the result is unused
    # then.
    if flat_horizons:
        horizon = torch.zeros_like(elev)
    else:
        azim_idx = torch.clamp(torch.round(azim).to(torch.int64) % 360, 0,
                               359)
        if horizons.dim() > 1:
            # per-point tables: one gather on the 360 axis, with the time
            # axis moved last ([*point_shape, T] indices)
            idx = azim_idx.movedim(time_axis, -1)
            horizon = torch.gather(horizons, -1, idx).movedim(-1, time_axis)
        else:
            horizon = horizons[azim_idx]

    shadow = torch.where(horizon > elev, 0.0, 1.0).to(elev.dtype)
    sun_up = elev > 0.0

    sw_dir_m = torch.where(sun_up, sw_dir * shadow, sw_dir)
    sw_ref = p.albedo_surroundings * sw_dir_m + p.albedo_surroundings * dif_sw
    dif_m = sky_view * dif_sw + (1.0 - sky_view) * sw_ref
    sw_m = torch.where(sun_up, dif_m + sw_dir_m, sw)

    lw_m = sky_view * lw + (1.0 - sky_view) * (-lw_surroundings)
    return sw_m, lw_m
