"""Frozen copy of ``roadsurf_tpu_torch/step.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

The fused per-timestep update: state x forcing-row -> state.

The counterpart of ``roadsurf_tpu/step.py``.  Composes the physics in
exactly the reference's per-step order
(examples/example1/src/Simulation.f90:58-95 and :120-172):

  CheckValues -> [coupling flags] -> SetCurrentValues (obs forcing)
  -> [relaxation: precomputed in forcing prep]
  -> PrecipitationToStorage -> [ModRadiation: precomputed]
  -> BalanceModelOneStep (BLCond fixed point, RNet, stencil, HStor, melting)
  -> WearFactors -> RoadCond -> CalcAlbedo

Branch-free, batched over points; per-point failure containment freezes the
state and poisons outputs with -9999 (the reference aborts the point's loop;
src/InputOutput.f90:66-82, Simulation.f90:58).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelSettings, PhysicsParams
from .physics import storage
from .physics.boundary_layer import bl_cond_and_le
from .physics.radiation import net_radiation
from .physics.soil import soil_step, surface_average
from .state import State

OUT_MISSING = -9999.0


class StepForcing(NamedTuple):
    """One timestep's prepared forcing row (see forcing.Prepared)."""
    tair: torch.Tensor
    vz: torch.Tensor
    rhz: torch.Tensor
    rain: torch.Tensor
    snow: torch.Tensor
    sw: torch.Tensor
    lw: torch.Tensor
    tsurf_obs: torch.Tensor
    valid: torch.Tensor
    in_coupling: torch.Tensor
    trf_fric: torch.Tensor
    sw_cof: torch.Tensor
    lw_cof: torch.Tensor


class StepConfig(NamedTuple):
    """Static step configuration."""
    dt: float
    tph: float
    depth_idx: int
    depth_w: float
    use_depth: bool
    force_snow_melting: bool
    force_ice_melting: bool
    melting_can_change_temperature: bool
    bl_max_iter: int = 40

    @classmethod
    def from_settings(cls, settings: ModelSettings, depth_idx=1, depth_w=0.0,
                      use_depth=False, bl_max_iter: int = 40) -> "StepConfig":
        return cls(dt=settings.dt, tph=settings.tph, depth_idx=depth_idx,
                   depth_w=depth_w, use_depth=use_depth,
                   force_snow_melting=settings.force_snow_melting,
                   force_ice_melting=settings.force_ice_melting,
                   melting_can_change_temperature=settings.melting_can_change_temperature,
                   bl_max_iter=bl_max_iter)


def step(state: State, f: StepForcing, coupling_tsurf, cfg: StepConfig,
         grid_dyc, grid_cond_dz, grid_wcont, p: PhysicsParams,
         depth=None) -> State:
    """Advance one timestep.  grid_* are the static [L] layer tensors.

    ``depth``: optional per-point (idx, w, use) tensors overriding the static
    StepConfig output-depth (ex2's per-point modelInput%%depth)."""
    didx, dw, duse = depth if depth is not None else (
        cfg.depth_idx, cfg.depth_w, cfg.use_depth)
    # --- failure containment (CheckValues; Simulation.f90:58) -----------
    # The reference has no early exit inside the loop body: the step that
    # FAILS CheckValues still runs and writes output; only subsequent steps
    # are skipped.  So `active` gates on failures from PRIOR steps, while the
    # new flag carries this step's failure forward.
    abnormal = (state.tsurf_ave < -100.0) | (state.tsurf_ave > 100.0)
    failed = state.failed | (~f.valid) | abnormal
    active = ~state.failed

    # --- SetCurrentValues: air node + obs forcing (InputOutput.f90:107-148)
    force_obs = f.tsurf_obs > -100.0
    t1 = torch.where(force_obs, f.tsurf_obs, state.tmp[..., 1])
    t2 = torch.where(force_obs, f.tsurf_obs, state.tmp[..., 2])
    tmp = torch.cat([f.tair[..., None], t1[..., None], t2[..., None],
                     state.tmp[..., 3:]], dim=-1)
    tsurf_ave = torch.where(
        force_obs, surface_average(tmp, didx, dw, duse), state.tsurf_ave)

    # --- PrecipitationToStorage (Storage.f90:9-29) ----------------------
    wat = state.wat + f.rain
    snow = state.snow + f.snow

    # --- BalanceModelOneStep (BalanceModel.f90:7-86) --------------------
    bl = bl_cond_and_le(state.blcond, tsurf_ave, state.evap, cfg.dt, wat,
                        f.tair, f.vz, f.rhz, p, max_iter=cfg.bl_max_iter)
    rnet = net_radiation(tsurf_ave, state.albedo, f.sw, f.lw,
                         f.sw_cof, f.lw_cof, p)
    soil = soil_step(tmp, grid_wcont, grid_dyc, grid_cond_dz, bl.blcond,
                     rnet, bl.le_flux, f.trf_fric, cfg.dt, p)

    storages = storage.Storages(wat, snow, state.ice, state.ice2, state.dep)
    tmp_new, _, q2melt = storage.melting_limiter(
        storages, soil.tmp_new, tsurf_ave, state.q2melt, state.t4melt,
        soil.hstor, soil.hs1, f.in_coupling, coupling_tsurf,
        didx, dw, duse, cfg.melting_can_change_temperature, p)

    # commit + output temperature (BalanceModel.f90:75-84)
    tsurf_after = surface_average(tmp_new, didx, dw, duse)

    # --- WearFactors + RoadCond + CalcAlbedo (Simulation.f90:159-171) ---
    storages, very_cold, q2melt, t4melt = storage.road_cond(
        storages, tsurf_after, bl.evap, q2melt, state.t4melt,
        state.very_cold, cfg.tph, cfg.dt,
        cfg.force_snow_melting, cfg.force_ice_melting, p)
    albedo = storage.albedo_update(state.albedo, storages, p)

    new = State(
        tmp=tmp_new, tsurf_ave=tsurf_after,
        wat=storages.wat, snow=storages.snow, ice=storages.ice,
        ice2=storages.ice2, dep=storages.dep,
        q2melt=q2melt, t4melt=t4melt, very_cold=very_cold,
        evap=bl.evap, blcond=bl.blcond, albedo=albedo, failed=failed)

    # freeze failed points
    keep = lambda n, o: torch.where(active, n, o)
    return State(
        tmp=torch.where(active[..., None], new.tmp, state.tmp),
        tsurf_ave=keep(new.tsurf_ave, state.tsurf_ave),
        wat=keep(new.wat, state.wat),
        snow=keep(new.snow, state.snow),
        ice=keep(new.ice, state.ice),
        ice2=keep(new.ice2, state.ice2),
        dep=keep(new.dep, state.dep),
        q2melt=keep(new.q2melt, state.q2melt),
        t4melt=keep(new.t4melt, state.t4melt),
        very_cold=keep(new.very_cold, state.very_cold),
        evap=keep(new.evap, state.evap),
        blcond=keep(new.blcond, state.blcond),
        albedo=keep(new.albedo, state.albedo),
        failed=failed)


def step_output(state: State, failed_before):
    """The six output fields (SaveOutput, src/InputOutput.f90:151-165).

    ``failed_before`` is the failure mask at step ENTRY: the step on which a
    point first fails still writes its output (Simulation.f90 has no early
    exit in the loop body); only later steps stay -9999."""
    miss = lambda x: torch.where(failed_before, torch.full_like(x, OUT_MISSING),
                                 x)
    return (miss(state.tsurf_ave), miss(state.wat), miss(state.snow),
            miss(state.ice), miss(state.ice2), miss(state.dep))
