"""Frozen copy of ``roadsurf_tpu_torch/physics/moisture.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Moisture utilities: Magnus saturation pressure, Tdew <-> RH.

Re-derivation of src/InputOutput.f90:202-268 and
examples/example1/src/MeteorologyTools.cpp (Magnus formula over water / ice);
the counterpart of ``roadsurf_tpu/physics/moisture.py``.

Array-namespace generic: torch tensors compute with torch, plain
numpy/python inputs with numpy (``io/synthetic.py`` calls ``tdew_from_rh``
on host arrays).
"""
from __future__ import annotations

import numpy as np
import torch

AFACT = 0.61078   # kPa
ALPHA_ICE = 21.875
BETA_ICE = 265.5
ALPHA_WAT = 17.269
BETA_WAT = 237.3


def _is_torch(*xs) -> bool:
    """torch for tensors, numpy for host arrays (moisture.py:26-28)."""
    return any(isinstance(x, torch.Tensor) for x in xs)


def _where(cond, a, b, like):
    """Select between two python scalars in ``like``'s float dtype."""
    if isinstance(like, torch.Tensor):
        return torch.where(cond, torch.tensor(a, dtype=like.dtype,
                                              device=like.device),
                           torch.tensor(b, dtype=like.dtype,
                                        device=like.device))
    return np.where(cond, a, b)


def esat(t):
    """Saturation vapor pressure (kPa), over ice below 0 C, water above
    (src/BoundaryLayer.f90:159-171)."""
    xp = torch if _is_torch(t) else np
    if xp is np:
        t = np.asarray(t)
    e_ice = AFACT * xp.exp(ALPHA_ICE * t / (t + BETA_ICE))
    e_wat = AFACT * xp.exp(ALPHA_WAT * t / (t + BETA_WAT))
    return xp.where(t < 0.0, e_ice, e_wat)


def esat_air_convention(t):
    """Same as :func:`esat` but with the >= 0 branch on water, matching
    CalcRh/CalcTDew (src/InputOutput.f90:223-229: T >= 0 -> water)."""
    xp = torch if _is_torch(t) else np
    if xp is np:
        t = np.asarray(t)
    e_ice = AFACT * xp.exp(ALPHA_ICE * t / (t + BETA_ICE))
    e_wat = AFACT * xp.exp(ALPHA_WAT * t / (t + BETA_WAT))
    return xp.where(t >= 0.0, e_wat, e_ice)


def rh_from_tdew(t2m, tdew):
    """RH (%) from air and dew point temperature (src/InputOutput.f90:202-236)."""
    rh = (esat_air_convention(tdew) / esat_air_convention(t2m)) * 100.0
    if isinstance(rh, torch.Tensor):
        return torch.clamp(rh, max=100.0)
    return np.minimum(rh, 100.0)


def tdew_from_rh(t2m, rhz):
    """Dew point (C) from air temperature and RH (src/InputOutput.f90:239-268).

    Note the reference chooses the alpha/beta pair from T2m (not from the
    resulting dew point) -- replicated here.
    """
    torch_in = _is_torch(t2m, rhz)
    xp = torch if torch_in else np
    if not torch_in:
        t2m = np.asarray(t2m)
        rhz = np.asarray(rhz)
    alpha = _where(t2m >= 0.0, ALPHA_WAT, ALPHA_ICE, t2m)
    beta = _where(t2m >= 0.0, BETA_WAT, BETA_ICE, t2m)
    epr_sat = AFACT * xp.exp(alpha * t2m / (t2m + beta))
    epr = 0.01 * rhz * epr_sat
    with np.errstate(divide="ignore", invalid="ignore"):
        xx = xp.log(epr / AFACT)
        return beta * xx / (alpha - xx)
