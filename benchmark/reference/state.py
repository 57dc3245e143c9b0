"""Frozen copy of ``roadsurf_tpu_torch/state.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Model state and per-point parameters as NamedTuples of tensors.

The counterpart of ``roadsurf_tpu/state.py``.  The reference scatters
per-point state across 16 Fortran derived types
(src/RoadSurfVariables.f90); the prognostic subset -- exactly what the
coupling snapshot saves/restores (src/Coupling.f90:172-255) plus the
boundary-layer warm start -- becomes one struct of [P] tensors.  Everything
else in the reference's types is either static configuration (config.py /
grid.py) or per-step temporaries.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams, MISSING
from .grid import LayerGrid, day_of_year
from .physics.boundary_layer import bl_cond_and_le
from .physics.soil import surface_average


class State(NamedTuple):
    """Prognostic per-point state; all leaves shaped [...] (batch) except
    ``tmp``: [..., nlayers+2] with node 0 = air, node N+1 = climatology."""
    tmp: torch.Tensor
    tsurf_ave: torch.Tensor
    wat: torch.Tensor        #: SrfWatmms
    snow: torch.Tensor       #: SrfSnowmms
    ice: torch.Tensor        #: SrfIcemms
    ice2: torch.Tensor       #: SrfIce2mms
    dep: torch.Tensor        #: SrfDepmms
    q2melt: torch.Tensor
    t4melt: torch.Tensor
    very_cold: torch.Tensor  #: bool
    evap: torch.Tensor       #: EvapmmTS
    blcond: torch.Tensor     #: boundary-layer conductance warm start
    albedo: torch.Tensor
    failed: torch.Tensor     #: bool, per-point failure containment


class PointParams(NamedTuple):
    """Per-point static inputs (the reference's LocalParameters,
    src/LocalParameters.f90.inc).  Leaves are numpy arrays on the host or
    tensors on a device."""
    lat: torch.Tensor
    lon: torch.Tensor
    sky_view: torch.Tensor          #: 1.0 disables modification
    horizons: torch.Tensor          #: [..., 360]
    init_len: torch.Tensor          #: InitLenI, 1-based step count, int32
    tair_relax: torch.Tensor
    vz_relax: torch.Tensor
    rh_relax: torch.Tensor
    coupling_start: torch.Tensor    #: 1-based window start step, int32
    coupling_end: torch.Tensor      #: 1-based window end step (obs index), int32
    coupling_tsurf: torch.Tensor    #: observed Tsurf for coupling / melting guard
    out_depth: torch.Tensor         #: per-point output depth m (ex2
                                    #: modelInput%%depth); -9999.9 = use
                                    #: (T1+T2)/2 unless a global depth is set


def default_point_params(nposts: int, lat=60.2, lon=24.9,
                         init_len: int = 1) -> PointParams:
    """Host (numpy) defaults, as state.py:61-72."""
    f = lambda v: np.full((nposts,), v, dtype=np.float64)
    i = lambda v: np.full((nposts,), v, dtype=np.int32)
    return PointParams(
        lat=f(lat), lon=f(lon), sky_view=f(1.0),
        horizons=np.zeros((nposts, 360), dtype=np.float64),
        init_len=i(init_len),
        tair_relax=f(MISSING), vz_relax=f(MISSING), rh_relax=f(MISSING),
        coupling_start=i(-99), coupling_end=i(-99), coupling_tsurf=f(MISSING),
        out_depth=f(MISSING),
    )


def init_profile(tair0, tsurf_obs0, julday, grid: LayerGrid,
                 p: PhysicsParams):
    """Initial temperature profile (initTemp, src/Initialization.f90:238-287).

    tair0/tsurf_obs0: [...] batch tensors; returns [..., N+2].
    """
    n = grid.nlayers
    z = torch.as_tensor(grid.zdepth, dtype=tair0.dtype, device=tair0.device)

    top = torch.where(tsurf_obs0 > -100.0, tsurf_obs0, tair0)
    # bottom node: climatological sinusoid (:266-268)
    t_bot = p.t_clim_g + p.az * torch.sin(
        p.omega * julday + p.omega * (-170.0) - z[n] / p.damp_depth)
    t_bot = torch.broadcast_to(t_bot, top.shape)

    # layers 5..N: linear blend in depth between layer 4 and the bottom node
    # (:272-276).  z index k (0-based) = ZDpth(k+1) (1-based).
    layers = [top, top, top, top]                       # layers 1..4
    z4 = z[3]
    zbot = z[n]
    for k in range(5, n + 1):
        frac = (z[k - 1] - z4) / (zbot - z4)
        layers.append(top + (t_bot - top) * frac)
    return torch.stack([tair0] + layers + [t_bot], dim=-1)


def init_state(settings: ModelSettings, p: PhysicsParams, grid: LayerGrid,
               tair0, vz0, rhz0, tsurf_obs0, date0, depth_idx=1,
               depth_w=0.0, use_depth: bool = False) -> State:
    """Build the initial state (Initialization.f90 semantics).

    date0: (year, month, day) ints of the first simulation step.
    tair0/vz0/rhz0/tsurf_obs0: [...] first-step forcing tensors, all of the
    run's dtype and device.
    """
    julday = day_of_year(*date0)
    tmp = init_profile(tair0, tsurf_obs0, julday, grid, p)
    tsurf_ave = surface_average(tmp, depth_idx, depth_w, use_depth)
    zeros = torch.zeros_like(tsurf_ave)

    # first boundary-layer evaluation (Initialization.f90:119-139): wind
    # floored at 0.4, conductance cold-started from the sentinel.
    vz0c = torch.clamp(vz0, min=0.4)
    bl = bl_cond_and_le(
        torch.full_like(tsurf_ave, -99.9), tsurf_ave, zeros, settings.dt,
        zeros, tair0, vz0c, rhz0, p)

    return State(
        tmp=tmp,
        tsurf_ave=tsurf_ave,
        wat=zeros, snow=zeros, ice=zeros, ice2=zeros, dep=zeros,
        q2melt=zeros,
        t4melt=torch.full_like(zeros, p.t4melt_normal),
        very_cold=torch.zeros_like(zeros, dtype=torch.bool),
        evap=bl.evap,
        blcond=bl.blcond,
        albedo=torch.full_like(zeros, p.albedo),
        failed=torch.zeros_like(zeros, dtype=torch.bool),
    )
