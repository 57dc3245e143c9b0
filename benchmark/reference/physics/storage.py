"""Frozen copy of ``roadsurf_tpu_torch/physics/storage.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Surface storage physics: precipitation typing, the four storage terms,
traffic wear, the melt energy limiter and albedo.

Branch-free batched re-derivation of src/Storage.f90, src/Cond.f90; the
counterpart of ``roadsurf_tpu/physics/storage.py``.  The reference applies
these as an ordered sequence of scalar guard/clamp rules per point; every
``If`` here becomes a ``torch.where`` applied in **exactly the reference
order** (ordering is load-bearing for parity: e.g. water overflow is clamped
both before snow handling and again at the end of RoadCond).

All functions operate on tensors of arbitrary (broadcastable) batch shape.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import (PhysicsParams, PRECIPITATION_RAIN, PRECIPITATION_SLEET,
                      PRECIPITATION_SNOW, PRECIPITATION_NONE,
                      PRECIPITATION_FREEZING_DRIZZLE,
                      PRECIPITATION_FREEZING_RAIN, PRECIPITATION_HAIL)

# WearFactors overwrites the configured Snow2IceFac unconditionally
# (src/Cond.f90:86); the effective constant is 0.25/0.45.
SNOW2ICE_FAC = 0.25 / (0.2 + 0.25)


class Storages(NamedTuple):
    wat: torch.Tensor
    snow: torch.Tensor
    ice: torch.Tensor
    ice2: torch.Tensor
    dep: torch.Tensor


class WearF(NamedTuple):
    snow_tran: torch.Tensor
    ice_wear: torch.Tensor
    ice_wear2: torch.Tensor
    dep_wear: torch.Tensor
    wat_wear: torch.Tensor


def _const(x, value):
    """``value`` broadcast to ``x`` in its dtype (a select between two
    python scalars must not round through the default float32)."""
    return torch.full_like(x, value)


def calc_prec_type(prec_phase, prec_in_step, tair, rhz, p: PhysicsParams):
    """Precipitation typing (CalcPrecType, src/Cond.f90:143-249).

    Pure function of forcing (post-relaxation tair/rhz), so it is evaluated
    during vectorized forcing prep, not in the sequential scan.

    Returns (rain_ts, snow_ts, wets_snow) where wets_snow marks steps whose
    precipitation flips the snow type to wet (rain or sleet).
    """
    phase = prec_phase
    prec = prec_in_step
    zero = torch.zeros_like(prec)
    has_phase = phase > p.miss_val_i
    known_phase = ((phase == PRECIPITATION_NONE) | (phase == PRECIPITATION_RAIN)
                   | (phase == PRECIPITATION_SLEET) | (phase == PRECIPITATION_SNOW)
                   | (phase == PRECIPITATION_FREEZING_DRIZZLE)
                   | (phase == PRECIPITATION_FREEZING_RAIN)
                   | (phase == PRECIPITATION_HAIL))
    enough = prec > p.min_prec_mm

    # phase-code path (:193-213)
    is_rain_code = ((phase == PRECIPITATION_NONE) | (phase == PRECIPITATION_RAIN)
                    | (phase == PRECIPITATION_FREEZING_DRIZZLE)
                    | (phase == PRECIPITATION_FREEZING_RAIN))
    is_sleet_code = phase == PRECIPITATION_SLEET
    is_snow_code = (phase == PRECIPITATION_SNOW) | (phase == PRECIPITATION_HAIL)
    rain_code = torch.where(is_rain_code, prec,
                            torch.where(is_sleet_code, prec / 2.0, zero))
    snow_code = torch.where(is_snow_code, prec,
                            torch.where(is_sleet_code, prec / 2.0, zero))
    wets_code = is_rain_code | is_sleet_code

    # in-built Koistinen interpretation (:221-245)
    pexp = 22.0 - 2.7 * tair - 0.20 * rhz
    prain = 1.0 / (1.0 + torch.exp(pexp))
    interp_snowy = prain < p.p_lim_snow
    interp_rainy = prain > p.p_lim_rain
    rain_interp = torch.where(interp_snowy, zero,
                              torch.where(interp_rainy, prec, prec / 2.0))
    snow_interp = torch.where(interp_snowy, prec,
                              torch.where(interp_rainy, zero, prec / 2.0))
    wets_interp = ~interp_snowy

    use_phase = has_phase & known_phase
    rain = torch.where(use_phase, rain_code, rain_interp)
    snow = torch.where(use_phase, snow_code, snow_interp)
    wets = torch.where(use_phase, wets_code, wets_interp)

    rain = torch.where(enough, rain, zero)
    snow = torch.where(enough, snow, zero)
    wets = wets & enough
    return rain, snow, wets


def wear_factors(s: Storages, tph, p: PhysicsParams) -> WearF:
    """Traffic wear rates in mm per timestep (WearFactors, src/Cond.f90:69-103)."""
    snow_tran = torch.clamp((0.2 + 0.25) * s.snow, min=0.01)
    snow_tran = torch.where(s.snow < 0.2, snow_tran * 3.0, snow_tran) * tph
    ice_wear = torch.clamp(1.1 * 2.0 * 0.145 * s.ice, min=0.01) * tph
    ice_wear2 = torch.clamp(1.1 * 2.0 * (4.0 * 0.290) * s.ice2, min=0.01) * tph
    dep_wear = torch.clamp(0.5 * 2.0 * (4.0 * 0.290) * s.dep, min=0.01) * tph
    wat_wear = 10.0 * torch.clamp(0.145 * s.wat, min=0.06) * tph
    return WearF(snow_tran, ice_wear, ice_wear2, dep_wear, wat_wear)


def _water_limits(wat, p: PhysicsParams):
    wat = torch.where(wat < p.min_wat_mms, torch.zeros_like(wat), wat)
    wat = torch.clamp(wat, max=p.max_wat_mms)
    return wat


def water_storage(s: Storages, tsurf, evap, wat_wear, wear_surf,
                  p: PhysicsParams):
    """WaterStorage (src/Storage.f90:33-84).  Returns (storages, srf_ext)."""
    wat = s.wat
    # evaporation/condensation: bare warm surface only (:52-62);
    # note ice2 is deliberately absent from the guard, as in the reference
    bare = ((s.snow <= 0.0) & (s.ice <= 0.0) & (s.dep <= 0.0)
            & (tsurf > p.t_lim_dew))
    surface_evap = wat > p.max_por_mms
    loss = torch.where(surface_evap, evap, p.por_eva_f * evap)
    wat = torch.where(bare, wat - loss, wat)

    # traffic wear (:65-75)
    wearing = wear_surf & (wat > 0.0)
    ww = torch.where(wat < p.w_wear_lim, torch.zeros_like(wat_wear), wat_wear)
    wear_amt = torch.where(wat > p.w_wet_lim, ww, p.damp_wear_f * ww)
    wat = torch.where(wearing, wat - wear_amt, wat)

    wat = _water_limits(wat, p)                     # :79-80
    srf_ext = torch.clamp(wat - p.max_por_mms, min=0.0)  # :82
    return s._replace(wat=wat), srf_ext


def snow_storage(s: Storages, srf_ext, tsurf, q2melt, snow_wet, wearf: WearF,
                 dt, force_snow_melting: bool, p: PhysicsParams):
    """SnowStorage (src/Storage.f90:88-196).

    Returns (storages, snow_wet, srf_ext).  ``snow_wet`` is the boolean
    SnowType state (True == SURFACE_SNOW_WET).
    """
    wat, snow, ice, ice2, dep = s
    zero = torch.zeros_like(snow)
    # water/(water+snow) ratio from the *entry* values (:115-120)
    rd = srf_ext + snow
    wat_snow_rat = torch.where(rd > 0.001, srf_ext / rd, zero)

    # snow-type transitions (:129-134)
    snow_wet = torch.where(snow > 0.0,
                           snow_wet | (wat_snow_rat > p.wet_snow_form_r),
                           torch.zeros_like(snow_wet))

    # deposit under snow converts to ice (:136-141)
    under = snow > 0.0
    ice = torch.where(under, ice + dep, ice)
    dep = torch.where(under, zero, dep)

    # melting (:143-155)
    has_snow = snow > 0.0
    melt_forced = has_snow & force_snow_melting
    melts = (has_snow & (~melt_forced) & (q2melt > 0.0)
             & (tsurf >= p.t_lim_melt_snow))
    melted_mm = 1000.0 * (q2melt * dt) / (p.wat_m_heat * p.wat_dens)
    wat = torch.where(melt_forced, wat + snow,
                      torch.where(melts, wat + melted_mm, wat))
    snow = torch.where(melt_forced, zero,
                       torch.where(melts, snow - melted_mm, snow))

    # wear: snow grinds into ice (:156-162); the surface always wears
    # (storage.py:243-252)
    wearing = snow > 0.0
    snow = torch.where(wearing, snow - wearf.snow_tran, snow)
    ice = torch.where(wearing, ice + SNOW2ICE_FAC * wearf.snow_tran, ice)
    ice2 = torch.where(wearing, ice2 + SNOW2ICE_FAC * wearf.snow_tran, ice2)

    # wet snow block: outer guard on entry values of this block (:164-184)
    wet_block = (snow > 0.0) & snow_wet
    melting_wet = wet_block & (wat_snow_rat > p.wet_snow_melt_r)
    wat = torch.where(melting_wet, wat + snow, wat)
    snow = torch.where(melting_wet, zero, snow)
    snow_wet = snow_wet & ~melting_wet
    freezing = wet_block & (tsurf < p.t_lim_freeze)
    frozen_amt = snow + wat
    ice = torch.where(freezing, ice + frozen_amt, ice)
    ice2 = torch.where(freezing, ice2 + frozen_amt, ice2)
    snow_wet = snow_wet & ~freezing
    snow = torch.where(freezing, zero, snow)
    wat = torch.where(freezing, zero, wat)

    srf_ext = torch.clamp(wat - p.max_por_mms, min=0.0)  # :186

    snow = torch.where(snow < p.min_snow_mms, zero, snow)            # :189
    snow = torch.where(snow > p.max_snow_mms, snow - p.max_snow_mms / 2.0,
                       snow)                                          # :191-194
    return Storages(wat, snow, ice, ice2, dep), snow_wet, srf_ext


def ice_storage(s: Storages, tsurf, q2melt, wearf: WearF, dt,
                force_ice_melting: bool, p: PhysicsParams):
    """IceStorage (src/Storage.f90:199-267)."""
    wat, snow, ice, ice2, dep = s
    zero = torch.zeros_like(ice)
    freezing = (tsurf < p.t_lim_freeze) & (wat > 0.0)       # :220-225
    ice = torch.where(freezing, ice + wat, ice)
    ice2 = torch.where(freezing, ice2 + wat, ice2)
    wat = torch.where(freezing, zero, wat)

    meltable = (snow <= 0.0) & (ice > 0.0)                  # :226-240
    melt_forced = meltable & force_ice_melting
    melts = (meltable & (~melt_forced) & (q2melt > 0.0)
             & (tsurf >= p.t_lim_melt_ice))
    melted_mm = 1000.0 * (q2melt * dt) / (p.wat_m_heat * p.wat_dens)
    wat = torch.where(melt_forced, wat + ice,
                      torch.where(melts, wat + melted_mm, wat))
    ice = torch.where(melt_forced, zero,
                      torch.where(melts, ice - melted_mm, ice))
    ice2 = torch.where(melt_forced, zero,
                       torch.where(melts, ice2 - melted_mm, ice2))

    ice = torch.where(ice > 0.0, ice - wearf.ice_wear, ice)      # :241-244
    ice2 = torch.where(ice2 > 0.0, ice2 - wearf.ice_wear2, ice2)

    ice = torch.where(ice < p.min_ice_mms, zero, ice)        # :255-259
    ice = torch.clamp(ice, max=p.max_ice_mms)
    ice2 = torch.where(ice2 < p.min_ice_mms, zero, ice2)     # :261-265
    ice2 = torch.clamp(ice2, max=p.max_ice_mms)
    return Storages(wat, snow, ice, ice2, dep)


def deposit_storage(s: Storages, tsurf, evap, dep_wear, p: PhysicsParams):
    """DepositStorage (src/Storage.f90:271-314)."""
    wat, snow, ice, ice2, dep = s
    zero = torch.zeros_like(dep)
    dep = torch.where(evap < 0.0, dep - evap, dep)          # condensation :289-291
    melting = tsurf > p.t_lim_melt_dep                      # :293-296
    wat = torch.where(melting, wat + dep, wat)
    dep = torch.where(melting, zero, dep)
    wearing = (snow <= 0.0) & (dep > 0.0)
    dep = torch.where(wearing, dep - dep_wear, dep)         # :298-302
    dep = torch.where(dep < p.min_dep_mms, zero, dep)       # :306
    overflow = dep > p.max_dep_mms                          # :308-312
    wat = torch.where(overflow, wat + dep - p.max_dep_mms, wat)
    dep = torch.clamp(dep, max=p.max_dep_mms)
    return Storages(wat, snow, ice, ice2, dep)


def new_melt_freeze_heat(s: Storages, t4melt, dt, p: PhysicsParams):
    """Q2Melt / T4Melt for the next step (NewMeltFreezeHeat,
    src/Storage.f90:409-432).  T4Melt keeps its old value when no snow/ice."""
    q2 = torch.zeros_like(s.wat)
    snowy = s.snow > 0.0
    q2 = torch.where(snowy,
                     p.wat_m_heat * p.wat_dens * (s.snow / 1000.0) / dt, q2)
    t4 = torch.where(snowy, _const(t4melt, p.t_lim_melt_snow), t4melt)
    icy = (~snowy) & (s.ice > 0.0)
    q2 = torch.where(icy, p.wat_m_heat * p.wat_dens * (s.ice / 1000.0) / dt,
                     q2)
    t4 = torch.where(icy, _const(t4, p.t_lim_melt_ice), t4)
    q2 = torch.clamp(q2, min=0.0)
    return q2, t4


def melting_limiter(s: Storages, tmp_new, tsurf, q2melt, t4melt, hstor, hs1,
                    in_coupling, last_tsurf_obs, depth_idx, depth_w,
                    use_depth, can_change_temp: bool, p: PhysicsParams):
    """The storage<->temperature energy limiter (melting,
    src/Storage.f90:319-402).

    Compares the heat demanded by melting (Q2Melt, from the previous step's
    RoadCond) against the heat available in the surface layer and either pins
    the top two layer temperatures at T4Melt or returns the leftover as
    warming.  Returns (tmp_new, tsurf_ave, q2melt).
    """
    from .soil import surface_average  # local import to avoid cycle

    zero = torch.zeros_like(q2melt)
    has_frozen = (s.snow > 0.0) | (s.ice > 0.0) | (s.ice2 > 0.0)
    q2_out = torch.where(has_frozen, q2melt, zero)            # :397-399
    if not can_change_temp:                                  # :355-357
        return tmp_new, tsurf, q2_out

    guard = ((hstor <= 0.00001) | (tsurf <= t4melt) | (q2melt <= 0.0)
             | (in_coupling & (last_tsurf_obs < t4melt)))   # :358-360
    cold_exit = guard & (tsurf < 0.5)                        # :363-366
    hot_exit = guard & (tsurf > 2.0)                         # :368-373
    # guard true with 0.5 <= tsurf <= 2.0 falls through to the pinning block
    qavail = hs1 * (tmp_new[..., 1] - t4melt)                # :376

    pin = has_frozen & (~cold_exit) & (~hot_exit)
    all_used = q2melt >= qavail                              # :377-386
    t1_pinned = torch.where(all_used, t4melt + 0.01,
                            t4melt + (qavail - q2melt) / hs1)
    t2_pinned = t4melt + 0.01

    t1 = torch.where(pin, t1_pinned, tmp_new[..., 1])
    t2 = torch.where(pin, t2_pinned, tmp_new[..., 2])
    tmp_out = torch.cat([tmp_new[..., :1], t1[..., None], t2[..., None],
                         tmp_new[..., 3:]], dim=-1)

    q2_out = torch.where(has_frozen & cold_exit, zero, q2_out)
    q2_out = torch.where(has_frozen & hot_exit,
                         torch.minimum(q2_out, qavail), q2_out)
    q2_out = torch.where(pin & all_used, qavail, q2_out)

    # TsurfAve recomputed only when the pinning block ran (:389-394)
    new_ave = surface_average(tmp_out, depth_idx, depth_w, use_depth)
    tsurf_out = torch.where(pin, new_ave, tsurf)
    return tmp_out, tsurf_out, q2_out


def albedo_update(albedo, s: Storages, p: PhysicsParams):
    """CalcAlbedo (src/Cond.f90:105-139); wearing surface assumed."""
    ice_sum = torch.clamp(0.5 * (s.ice + s.ice2) + s.dep, min=0.0)
    ice_max = 1.5
    snowy = (s.snow > 0.01) & (s.snow > s.ice)
    icy = (s.ice > 0.01) | (s.dep > 0.01)
    icy_alb = torch.where(
        ice_sum < ice_max,
        p.alb_dry + (ice_sum / ice_max) * (p.alb_snow - p.alb_dry),
        _const(ice_sum, p.alb_snow))
    out = _const(albedo, p.alb_dry)
    out = torch.where(snowy, _const(out, p.alb_snow),
                      torch.where(icy & ~snowy, icy_alb, out))
    return out


def very_cold_update(very_cold, tsurf, p: PhysicsParams):
    """VeryCold hysteresis (src/Cond.f90:33-39)."""
    vc = very_cold & ~(very_cold & (tsurf > p.t_lim_cold_h))
    vc = vc | ((~vc) & (tsurf < p.t_lim_cold_l))
    return vc


def snow_ice_check(s: Storages, last_tsurf_obs, p: PhysicsParams):
    """Coupling anti-stuck forced melt (snowIceCheck, src/Coupling.f90:259-289).
    Note ice2 is zeroed without adding to water, as in the reference."""
    wat, snow, ice, ice2, dep = s
    zero = lambda x: torch.zeros_like(x)
    warm_snow = (last_tsurf_obs > p.t_lim_melt_snow) & (snow > 0.0)
    wat = torch.where(warm_snow, wat + snow, wat)
    snow = torch.where(warm_snow, zero(snow), snow)
    warm_ice = (last_tsurf_obs > p.t_lim_melt_ice) & (ice > 0.0)
    wat = torch.where(warm_ice, wat + ice, wat)
    ice = torch.where(warm_ice, zero(ice), ice)
    warm_ice2 = (last_tsurf_obs > p.t_lim_melt_ice) & (ice2 > 0.0)
    ice2 = torch.where(warm_ice2, zero(ice2), ice2)
    warm_dep = (last_tsurf_obs > p.t_lim_melt_dep) & (dep > 0.0)
    wat = torch.where(warm_dep, wat + dep, wat)
    dep = torch.where(warm_dep, zero(dep), dep)
    return Storages(wat, snow, ice, ice2, dep)


def road_cond(s: Storages, tsurf, evap, q2melt, t4melt, very_cold,
              tph, dt, settings_force_snow: bool, settings_force_ice: bool,
              p: PhysicsParams):
    """RoadCond orchestration (src/Cond.f90:9-65): VeryCold hysteresis, the
    four storages in fixed order, final water clamp, next-step melt heat.

    SnowType is reset to DRY at RoadCond entry every step (Cond.f90:32) and no
    other consumer reads it, so the wet-snow flag is local to SnowStorage --
    it is NOT carried model state (CalcPrecType's wetting is dead state in the
    reference).

    Returns (storages, very_cold, q2melt, t4melt).
    """
    very_cold = very_cold_update(very_cold, tsurf, p)
    snow_wet = torch.zeros_like(s.snow, dtype=torch.bool)   # :32
    wearf = wear_factors(s, tph, p)
    s, srf_ext = water_storage(s, tsurf, evap, wearf.wat_wear, True, p)
    s, snow_wet, srf_ext = snow_storage(
        s, srf_ext, tsurf, q2melt, snow_wet, wearf, dt, settings_force_snow, p)
    s = ice_storage(s, tsurf, q2melt, wearf, dt, settings_force_ice, p)
    s = deposit_storage(s, tsurf, evap, wearf.dep_wear, p)
    s = s._replace(wat=_water_limits(s.wat, p))             # :61-62
    q2, t4 = new_melt_freeze_heat(s, t4melt, dt, p)
    return s, very_cold, q2, t4
