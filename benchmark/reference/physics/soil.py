"""Frozen copy of ``roadsurf_tpu_torch/physics/soil.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Ground heat capacity and the vertical heat-conduction stencil.

Re-derivation of src/BalanceModel.f90 (CalcHCapHCond :189-251,
calcCapDZCondDZ :132-155, calcProfile :90-129, calcHStor :311-322) as batched
torch ops over a [..., L+2] temperature vector (node 0 = air, node L+1 =
climatology); the counterpart of ``roadsurf_tpu/physics/soil.py``.  Heat
conductivity is constant in time (water content never changes; see
``grid.py``), so only the capacity side is recomputed each step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PhysicsParams


class SoilStep(NamedTuple):
    tmp_new: torch.Tensor    #: [..., L+2] updated temperatures
    hs1: torch.Tensor        #: surface-layer heat capacity in W/m2K (HS(1))
    hstor: torch.Tensor      #: stored-heat diagnostic (calcHStor)
    sensible: torch.Tensor   #: sensible heat flux (W/m2)


def volumetric_heat_capacity(tmp_layers, wcont, p: PhysicsParams):
    """VSH per layer: weighted dry ground + water/ice heat capacity with
    temperature-dependent water properties (BalanceModel.f90:205-236).

    tmp_layers: [..., L] ground-layer temperatures; wcont: [L] tensor.
    """
    t = tmp_layers
    t2 = t * t
    # liquid water density / specific heat polynomials (:218-224)
    roo_wat = -0.0050 * t2 + 0.0079 * t + 1000.0028
    c_wat = (0.0000102 * t2 * t2 - 0.0017169 * t2 * t + 0.11516 * t2
             - 3.4739 * t + 4217.2)
    frozen = t < 0.0
    roo = torch.where(frozen, 920.0, roo_wat)   # ice, Oke p.44 (:225-228)
    c = torch.where(frozen, 2100.0, c_wat)
    chwt = roo * c
    nlayers = tmp_layers.shape[-1]
    is_surface = torch.arange(nlayers, device=t.device) < 2
    dry = torch.where(is_surface,
                      torch.full((nlayers,), (1.0 - p.poro1) * p.vsh1,
                                 dtype=t.dtype, device=t.device),
                      torch.full((nlayers,), (1.0 - p.poro2) * p.vsh2,
                                 dtype=t.dtype, device=t.device))
    return dry + wcont * chwt


def soil_step(tmp, wcont, dyc, cond_dz, blcond, rnet, le_flux, trf_fric,
              dt, p: PhysicsParams) -> SoilStep:
    """One explicit-Euler step of the heat equation (calcProfile) plus the
    capacity recompute and stored-heat diagnostic.

    tmp: [..., L+2]; wcont/dyc/cond_dz: [L] static layer tensors.
    """
    nlayers = dyc.shape[-1]
    layers = tmp[..., 1:nlayers + 1]

    vsh = volumetric_heat_capacity(layers, wcont, p)
    # HS(I) = VSH * DyC / dt for every layer (BalanceModel.f90:238-246 --
    # the I==1 half-thickness case equals DyC(1) by construction)
    hs = vsh * dyc / dt
    cap_dz = -1.0 / (dyc * vsh)              # calcCapDZCondDZ :145-151

    sensible = blcond * (tmp[..., 0] - tmp[..., 1])
    g0 = rnet - le_flux + trf_fric + sensible              # GFlux(0) :115
    # GFlux(j) = condDZ(j) * (Tmp(j+1) - Tmp(j)), j = 1..L  (:119-121)
    gflux = cond_dz * (tmp[..., 2:nlayers + 2] - tmp[..., 1:nlayers + 1])
    g_prev = torch.cat([g0[..., None], gflux[..., :-1]], dim=-1)
    new_layers = layers + dt * cap_dz * (gflux - g_prev)   # :125-128

    tmp_new = torch.cat(
        [tmp[..., :1], new_layers, tmp[..., nlayers + 1:]], dim=-1)

    # calcHStor :311-322 (quarter-weighted two-layer average)
    t1_ave = (tmp[..., 1] + 3.0 * tmp[..., 2]) / 4.0
    tn_ave = (tmp_new[..., 1] + 3.0 * tmp_new[..., 2]) / 4.0
    hs1 = hs[..., 0]
    hstor = hs1 * (tn_ave - t1_ave)

    return SoilStep(tmp_new, hs1, hstor, sensible)


def temp_at_depth(tmp, idx: int, w: float):
    """Interpolated output temperature (getTempAtDepth,
    BalanceModel.f90:390-417) using static coefficients from
    grid.depth_interp_coeffs.  tmp: [..., L+2]."""
    if w == 0.0:
        return tmp[..., idx]
    return tmp[..., idx] + w * (tmp[..., idx + 1] - tmp[..., idx])


def surface_average(tmp, idx, w, use_depth):
    """TsurfAve: depth-interpolated when an output depth is configured,
    else (T1+T2)/2 (BalanceModel.f90:78-84).

    idx/w/use_depth may be python scalars (one global depth) or per-point
    tensors (ex2's per-point ``modelInput%depth``,
    src/InputArrays.f90.inc:27); tensors take a per-point gather."""
    plain = (tmp[..., 1] + tmp[..., 2]) / 2.0
    if isinstance(use_depth, bool) and not use_depth:
        return plain
    if isinstance(idx, int):
        val = temp_at_depth(tmp, idx, w)
        return val if use_depth is True else torch.where(use_depth, val,
                                                         plain)
    idx = idx.to(torch.int64)
    ti = torch.gather(tmp, -1, idx[..., None])[..., 0]
    jdx = torch.clamp(idx + 1, max=tmp.shape[-1] - 1)  # w==0 at the last node
    tj = torch.gather(tmp, -1, jdx[..., None])[..., 0]
    val = ti + w * (tj - ti)
    return torch.where(use_depth, val, plain)
