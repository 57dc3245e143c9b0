"""Frozen copy of ``roadsurf_tpu_torch/grid.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Vertical layer geometry and static ground properties (numpy; a copy of
``roadsurf_tpu/grid.py``).

The reference builds, per point, a geometric depth grid plus constant layer
properties at initialization (src/Initialization.f90: initDepth :217-235,
ground_prop_init :181-214, CalcCC via BalanceModel.f90:254-279).  Water content
never changes during a run, so heat conductivity CC and the conductivity
derivative condDZ are **constants**; only heat capacity (temperature-dependent
water properties) is recomputed per step.  We precompute everything static here
once, as numpy, shared by all points (the reference uses identical soil
properties for every point).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .config import PhysicsParams


@dataclasses.dataclass(frozen=True)
class LayerGrid:
    """Static per-layer arrays.  All arrays are length ``nlayers + 1`` and
    0-indexed such that entry ``j`` corresponds to the reference's 1-based
    ground layer ``j+1``; temperature vectors elsewhere use length
    ``nlayers + 2`` with node 0 = air and node ``nlayers + 1`` = climatology.
    """

    nlayers: int
    zdepth: np.ndarray   #: layer top depths, ZDpth(1..N+1) (m)
    dyc: np.ndarray      #: midpoint-to-midpoint spacing, DyC(1..N)
    dyk: np.ndarray      #: layer thickness, DyK(1..N)
    wcont: np.ndarray    #: water content per layer (1..N)
    cc: np.ndarray       #: heat conductivity per layer (W/mK), CC(1..N)
    cond_dz: np.ndarray  #: -CC/DyK (constant; BalanceModel.f90:145-153)


def depth_grid(nlayers: int) -> np.ndarray:
    """Geometric depth grid Z(i+1) = Z(i) + 0.0103*1.4^(i-1) + 0.02
    (src/Initialization.f90:217-235)."""
    z = np.zeros(nlayers + 1, dtype=np.float64)
    for i in range(1, nlayers + 1):
        z[i] = z[i - 1] + 0.0103 * 1.4 ** (i - 1) + 0.02
    return z


def water_content(nlayers: int) -> np.ndarray:
    """WCont = 0.01 for layers 1-2, 0.3 below (src/Initialization.f90:206-213)."""
    w = np.full(nlayers, 0.3, dtype=np.float64)
    w[:2] = 0.01
    return w


def campbell_conductivity(params: PhysicsParams, nlayers: int,
                          wcont: np.ndarray) -> np.ndarray:
    """Heat conductivity from water content:
    lambda = A + B*theta - (A - D) * exp(-(C*theta)^E)
    (Campbell 1985; src/BalanceModel.f90:254-279)."""
    cc = np.zeros(nlayers, dtype=np.float64)
    for j in range(nlayers):
        cls = 1 if j < 2 else 2
        a, b, c, d, e = params.campbell_coeffs(cls)
        w = wcont[j]
        cc[j] = a + b * w - (a - d) * math.exp(-((c * w) ** e))
    return cc


def make_grid(params: PhysicsParams, nlayers: int) -> LayerGrid:
    z = depth_grid(nlayers)
    # DyC(1) = (Z(2)-Z(1))/2 ; DyC(j) = (Z(j+1)-Z(j-1))/2  (Initialization.f90:193-196)
    dyc = np.zeros(nlayers, dtype=np.float64)
    dyc[0] = (z[1] - z[0]) / 2.0
    for j in range(1, nlayers):
        dyc[j] = (z[j + 1] - z[j - 1]) / 2.0
    # DyK(j) = Z(j+1) - Z(j)  (Initialization.f90:201-205)
    dyk = z[1:] - z[:-1]
    w = water_content(nlayers)
    cc = campbell_conductivity(params, nlayers, w)
    cond_dz = -(cc / dyk[:nlayers])
    return LayerGrid(nlayers=nlayers, zdepth=z, dyc=dyc, dyk=dyk,
                     wcont=w, cc=cc, cond_dz=cond_dz)


def day_of_year(year: int, month: int, day: int) -> int:
    """Julian day-of-year with leap handling (src/BalanceModel.f90:325-351)."""
    mon_end = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]
    mon_end_leap = [0, 31, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335]
    leap = (year % 4 == 0 and year % 100 != 0) or year % 400 == 0
    return (mon_end_leap if leap else mon_end)[month - 1] + day


def depth_interp_coeffs_vec(grid: LayerGrid, depths):
    """Vectorized depth_interp_coeffs for per-point output depths
    (ex2's modelInput%depth): returns (idx [P] int32, w [P], use [P] bool);
    missing depths (< 0) get use=False."""
    z = grid.zdepth
    n = grid.nlayers
    depths = np.asarray(depths, np.float64)
    use = depths >= 0.0
    d = np.where(use, depths, 0.0)
    near_zero = np.abs(d) < 1e-5
    beyond = d > z[n]
    # find k with z[k] < d <= z[k+1]
    k = np.clip(np.searchsorted(z, d, side="left") - 1, 0, n - 1)
    w = (d - z[k]) / (z[k + 1] - z[k])
    idx = k + 1
    idx = np.where(near_zero, 1, np.where(beyond, n + 1, idx))
    w = np.where(near_zero | beyond, 0.0, w)
    return idx.astype(np.int32), w, use


def depth_interp_coeffs(grid: LayerGrid, depth: float):
    """Static interpolation (node index, weight) for output temperature at a
    given depth (src/BalanceModel.f90:390-417).  Returns (idx, w) such that
    T(depth) = (1-w)*Tmp[idx] + w*Tmp[idx+1] with idx indexing the full
    temperature vector (0 = air node).  For depth <= ~0 returns (1, 0.0);
    beyond the grid returns (nlayers+1, 0.0)."""
    z = grid.zdepth
    n = grid.nlayers
    if abs(depth) < 1e-5:
        return 1, 0.0
    if depth > z[n]:
        return n + 1, 0.0
    idx = 0
    for k in range(n):
        if z[k] < depth <= z[k + 1]:
            idx = k
            break
    w = (depth - z[idx]) / (z[idx + 1] - z[idx])
    return idx + 1, w  # +1: temperature vector has the air node at 0
