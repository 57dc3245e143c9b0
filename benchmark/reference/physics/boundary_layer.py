"""Frozen copy of ``roadsurf_tpu_torch/physics/boundary_layer.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Boundary-layer conductance, aerodynamic resistance and latent heat flux.

Re-derivation of src/BoundaryLayer.f90 as batched torch ops; the counterpart
of ``roadsurf_tpu/physics/boundary_layer.py``.  The reference's per-point
early-exit iteration is kept through masked updates inside an eager loop
that stops at ``max_iter`` or once every point of the batch has converged;
converged points freeze, exactly matching the Fortran EXIT, so the result
equals the JAX ``while_loop`` (boundary_layer.py:73-94) element for element.

The fixed point is warm-started from the previous step's conductance, as in
the reference (atm%BLCond persists across steps).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PhysicsParams
from .moisture import esat

CONV_LIM = 1e-3    # BoundaryLayer.f90:18
MAX_ITER = 40      # BoundaryLayer.f90:20
MIN_ITER = 5       # BoundaryLayer.f90:92


class BLCount:
    """Counts the boundary-layer iterations run while it is active
    (``with BLCount() as c``): ``iters``, the iterations of every element
    summed, and ``evals``, the elements evaluated, so ``iters / evals`` is
    the mean a point-step.  Only this copy counts; the physics is as in the
    program."""
    active = None

    def __enter__(self):
        self.iters, self.evals = 0, 0
        BLCount.active = self
        return self

    def __exit__(self, *exc):
        BLCount.active = None
        return False


class BLResult(NamedTuple):
    blcond: torch.Tensor    #: boundary-layer conductance (W/m2K)
    psim: torch.Tensor      #: momentum stability correction
    psih: torch.Tensor      #: heat stability correction
    le_flux: torch.Tensor   #: latent heat flux (W/m2)
    evap: torch.Tensor      #: evaporation (mm / timestep)


def air_properties(tair, p: PhysicsParams):
    """Temperature-dependent air properties (BoundaryLayer.f90:50-56)."""
    tak = tair + 273.15
    air_dens = 100000.0 / (287.05 * tak)
    air_hcap = 1005.0 + (tak - 250.0) ** 2 / 3364.0
    air_vcap = air_hcap * air_dens
    psych_c = 0.1 * (0.00063 * tak + 0.47496)
    return air_dens, air_hcap, air_vcap, psych_c


def water_density(tsurf):
    """Liquid water density polynomial (BoundaryLayer.f90:57)."""
    return -0.0050 * tsurf * tsurf + 0.0079 * tsurf + 1000.0028


def _stability_psi(stab):
    """PSIH/PSIM from the stability parameter (BoundaryLayer.f90:83-89)."""
    psih_stable = 4.7 * stab
    psih_unstable = -2.0 * torch.log(
        (1.0 + torch.sqrt(torch.clamp(1.0 - 16.0 * stab, min=0.0))) / 2.0)
    stable = stab > 0.0
    psih = torch.where(stable, psih_stable, psih_unstable)
    psim = torch.where(stable, psih, 0.6 * psih)
    return psim, psih


def bl_conductance(blcond0, tsurf, tair, vz, air_vcap, p: PhysicsParams,
                   max_iter: int = MAX_ITER):
    """Monin-Obukhov-style fixed point for boundary-layer conductance
    (BoundaryLayer.f90:60-101).  Batched over any shape; per-element early
    exit emulated with a done-mask so converged points freeze at exactly the
    reference's exit state (PSIM/PSIH updated once more after the final
    conductance, as in the Fortran loop ordering).
    """
    tak = tair + 273.15
    dt_ts = tsurf - tair
    bl = blcond0
    psim = torch.zeros_like(blcond0)
    psih = torch.zeros_like(blcond0)
    done = torch.zeros_like(blcond0, dtype=torch.bool)
    count = BLCount.active
    iters = torch.zeros_like(blcond0, dtype=torch.int64) if count else None
    for j in range(max_iter):
        if count:
            iters += ~done
        ustar = p.vk_const * vz / (p.log_ustar + psim)
        bl_new = air_vcap * p.vk_const * ustar / (p.log_cond + psih)
        stab = (-p.vk_const * p.zref_t * p.grav * bl_new * dt_ts
                / (air_vcap * tak * ustar * ustar * ustar))
        stab = torch.clamp(stab, max=1.0)
        psim_new, psih_new = _stability_psi(stab)
        newly_done = (torch.abs(bl_new - bl) < CONV_LIM) & (j + 1 >= MIN_ITER)
        bl = torch.where(done, bl, bl_new)
        psim = torch.where(done, psim, psim_new)
        psih = torch.where(done, psih, psih_new)
        done = done | newly_done
        if bool(done.all()):
            break
    if count:
        count.iters += int(iters.sum())
        count.evals += iters.numel()
    return bl, psim, psih


def aerodynamic_resistance(psim, psih, vz, p: PhysicsParams):
    """RAero capped at 30 s/m (BoundaryLayer.f90:112-131)."""
    raero = ((p.log_mom + psim) * (p.log_heat + psih)
             / (p.vk_const * p.vk_const * vz))
    return torch.clamp(raero, max=30.0)


def latent_heat(tsurf, tair, rhz, raero, srf_wat, dt, p: PhysicsParams):
    """Latent heat flux and evaporation per step (BoundaryLayer.f90:134-190)."""
    air_dens, air_hcap, _, psych_c = air_properties(tair, p)
    wat_den = water_density(tsurf)
    esurf = esat(tsurf)
    eair = torch.clamp(0.01 * rhz, max=1.0) * esat(tair)
    le = air_dens * air_hcap * (esurf - eair) / (psych_c * raero)
    lheat = torch.where(tsurf >= 0.0, torch.full_like(tsurf, p.lvap),
                        torch.full_like(tsurf, p.lfus))
    evap = (le / (lheat * wat_den)) * 1000.0 * dt
    # no water to evaporate
    dry = (le > 0.0) & (srf_wat <= 0.0)
    zero = torch.zeros_like(le)
    return torch.where(dry, zero, le), torch.where(dry, zero, evap)


def bl_cond_and_le(blcond0, tsurf, evap0, dt, srf_wat, tair, vz, rhz,
                   p: PhysicsParams, max_iter: int = MAX_ITER) -> BLResult:
    """Full CalcBLCondAndLE (BoundaryLayer.f90:3-109)."""
    _, _, air_vcap, _ = air_properties(tair, p)
    bl, psim, psih = bl_conductance(blcond0, tsurf, tair, vz, air_vcap, p,
                                    max_iter=max_iter)
    raero = aerodynamic_resistance(psim, psih, vz, p)
    le, evap = latent_heat(tsurf, tair, rhz, raero, srf_wat, dt, p)
    del evap0  # reference overwrites EvapmmTS unconditionally
    return BLResult(bl, psim, psih, le, evap)
