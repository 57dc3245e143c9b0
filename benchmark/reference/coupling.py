"""Frozen copy of ``roadsurf_tpu_torch/coupling.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Observation coupling: the radiation-coefficient fitting iteration.

The counterpart of ``roadsurf_tpu/coupling.py``.  The reference rewinds the
per-point time index up to 25 times over a coupling window, re-running the
window with adjusted SW/LW coefficients until the simulated surface
temperature matches the latest observation (src/Coupling.f90; call sites
examples/example1/src/Simulation.f90:63-71, :92-95).

Two engines, as in the JAX package:

 * ``run_coupled``, a **per-point program counter**: each point carries its
   own 1-based step index ``i``; a rewind is a per-point PC reset to the
   window start.  The JAX ``lax.while_loop`` becomes a Python ``while`` over
   a device-side ``any()`` (one host sync per step): it is the parity
   target, run at test sizes.
 * ``run_window_passes`` / ``run_coupled_segmented``, the **iteration-major
   window engine**: phases A and C are plain scans, and the window runs as
   whole passes (first / re-run / tail) over contiguous rows.  It is the
   eager counterpart of the JAX functions and the parity target of the
   window kernel K5 (``ops/window_kernel.py``), which runs phase B of the
   production run, one program counter per point, on the card.

Reference quirks replicated deliberately:
 * the snapshot never saves SrfIcemms -- saveDataForCoupling stores Ice2
   twice (src/Coupling.f90:194-195) -- so ice carries through rewinds;
 * q2melt/t4melt/evap/blcond are not in the snapshot either;
 * ``inCouplingPhase`` is computed from the PRE-rewind index
   (src/Coupling.f90:41-46 runs before uploadDataForCoupling), so the first
   re-run step executes with the flag false;
 * CheckValues runs on the PRE-rewind row;
 * the RadCoeff > 3.0 "failure" in the success branch is immediately
   overwritten by Coupling_failed = .false. (src/Coupling.f90:451-463), so
   it is effectively success-with-zero-correction.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams
from .forcing import Prepared, cof_window
from .grid import LayerGrid
from .physics import storage as storage_mod
from .physics.soil import surface_average
from .state import PointParams, State
from .step import OUT_MISSING, StepConfig, StepForcing, step

K0 = 273.16  # Coupling_control works in Kelvin (src/Coupling.f90:313)


class CouplingVars(NamedTuple):
    """Per-point coupling iteration state (cf. CouplingVariables,
    src/CouplingVariables.f90.inc)."""
    sw_cof: torch.Tensor
    lw_cof: torch.Tensor
    sw_corr: torch.Tensor
    lw_corr: torch.Tensor
    radcoeff: torch.Tensor
    radc_above: torch.Tensor
    radc_below: torch.Tensor
    radc_prev: torch.Tensor
    t_above: torch.Tensor       #: Kelvin (sentinel -9999)
    t_below: torch.Tensor       #: Kelvin
    tsurf_end1: torch.Tensor    #: Kelvin
    iterations: torch.Tensor    #: int32
    again: torch.Tensor         #: bool
    failed: torch.Tensor        #: bool (Coupling_failed)

    @classmethod
    def init(cls, np_, dtype, coupling_tsurf):
        """``coupling_tsurf``: [np_] tensor; the vars live on its device."""
        dev = coupling_tsurf.device
        f = lambda v: torch.full((np_,), v, dtype=dtype, device=dev)
        return cls(
            sw_cof=f(1.0), lw_cof=f(1.0), sw_corr=f(0.0), lw_corr=f(0.0),
            radcoeff=f(1.0), radc_above=f(-9999.0), radc_below=f(-9999.0),
            radc_prev=f(1.0), t_above=f(-9999.0), t_below=f(-9999.0),
            tsurf_end1=f(0.0),
            iterations=torch.zeros((np_,), dtype=torch.int32, device=dev),
            again=torch.zeros((np_,), dtype=torch.bool, device=dev),
            # initVariablesAndParameters :142-144 -- no obs => failed
            failed=coupling_tsurf < -100.0)


class Snapshot(NamedTuple):
    """saveDataForCoupling state subset (src/Coupling.f90:172-210)."""
    tmp: torch.Tensor
    tsurf_ave: torch.Tensor
    wat: torch.Tensor
    snow: torch.Tensor
    ice2: torch.Tensor
    dep: torch.Tensor
    albedo: torch.Tensor
    very_cold: torch.Tensor


def coupling_control(tsurf_c, obs_c, cv: CouplingVars, do) -> CouplingVars:
    """Branch-free Coupling_control (src/Coupling.f90:292-481), applied where
    ``do``; returns the updated CouplingVars (iterations already +1 per
    CouplingOperations2, src/Coupling.f90:140)."""
    w = torch.where
    t = tsurf_c + K0
    obs = obs_c + K0

    it = cv.iterations
    # branch predicates, mutually exclusive in reference order
    b_maxit = it == 25
    b_missing = (~b_maxit) & (obs < -100.0 + K0)
    b_abn = (~b_maxit) & (~b_missing) & ((t < 170.0) | (t > 400.0))
    prior = b_maxit | b_missing | b_abn
    b_above = (~prior) & (t - obs > 0.1)
    b_below = (~prior) & (~b_above) & (obs - t > 0.1)
    b_success = ~(prior | b_above | b_below)

    tsurf_end1 = w(it == 0, t, cv.tsurf_end1)

    # ---- failure branches ------------------------------------------------
    fail_any = b_maxit | b_missing | b_abn
    again_f = w(b_maxit, torch.abs(tsurf_end1 - obs) < torch.abs(t - obs),
                b_missing | b_abn)

    # ---- overshoot / undershoot (secant / halving / doubling) ------------
    # save-nearest updates (:366-375, :414-424)
    upd_above = b_above & ((cv.t_above < -100.0)
                           | (cv.t_above - obs > t - obs))
    t_above = w(upd_above, t, cv.t_above)
    radc_above = w(upd_above, cv.radcoeff, cv.radc_above)
    upd_below = b_below & ((cv.t_below < -100.0)
                           | (cv.t_below - obs < t - obs))
    t_below = w(upd_below, t, cv.t_below)
    radc_below = w(upd_below, cv.radcoeff, cv.radc_below)

    have_both = (t_above > -100.0) & (t_below > -100.0)
    d_above = t_above - obs
    d_below = obs - t_below
    denom = w(torch.abs(d_above + d_below) < 1e-300, 1.0, d_above + d_below)
    secant = radc_above - d_above / denom * (radc_above - radc_below)
    rad_above = w(have_both, secant, 0.5 * cv.radcoeff)
    rad_below = w(have_both, secant, 2.0 * cv.radcoeff)
    radcoeff = w(b_above, rad_above, w(b_below, rad_below, cv.radcoeff))

    stuck = (b_above | b_below) & (torch.abs(radcoeff - cv.radc_prev)
                                   < 0.00005)
    t_above = w(stuck, -9999.0, t_above)
    t_below = w(stuck, -9999.0, t_below)

    too_small = b_above & (radcoeff < 0.01)          # :400-408
    fail_any = fail_any | too_small
    radcoeff = w(too_small, 1.0, radcoeff)
    radc_prev = w(b_above | b_below, radcoeff, cv.radc_prev)

    # ---- success (:450-474); radcoeff>3 resets corrections but the branch
    # ends NOT failed (the reference overwrites the flag) ------------------
    big = b_success & (cv.radcoeff > 3.0)
    sw_cof_s = w(big, 1.0, cv.sw_cof)
    lw_cof_s = w(big, 1.0, cv.lw_cof)
    sw_corr_s = sw_cof_s - 1.0
    lw_corr_s = lw_cof_s - 1.0

    # ---- merge -----------------------------------------------------------
    reset_cof = fail_any
    sw_cof = w(reset_cof, 1.0, w(b_success, sw_cof_s, cv.sw_cof))
    lw_cof = w(reset_cof, 1.0, w(b_success, lw_cof_s, cv.lw_cof))
    sw_corr = w(reset_cof, 0.0, w(b_success, sw_corr_s, cv.sw_corr))
    lw_corr = w(reset_cof, 0.0, w(b_success, lw_corr_s, cv.lw_corr))
    radcoeff = w(fail_any | b_success, 1.0, radcoeff)
    t_above = w(b_success, -9999.0, t_above)
    t_below = w(b_success, -9999.0, t_below)
    radc_above = w(b_success, -9999.0, radc_above)
    radc_below = w(b_success, -9999.0, radc_below)
    radc_prev = w(b_success, 1.0, radc_prev)

    again = again_f | b_above | b_below
    failed = (fail_any | (cv.failed & ~b_success)) & ~b_success
    it_next = w(b_success, torch.zeros_like(it), it + 1)

    new = CouplingVars(
        sw_cof=sw_cof, lw_cof=lw_cof, sw_corr=sw_corr, lw_corr=lw_corr,
        radcoeff=radcoeff, radc_above=radc_above, radc_below=radc_below,
        radc_prev=radc_prev, t_above=t_above, t_below=t_below,
        tsurf_end1=tsurf_end1, iterations=it_next, again=again,
        failed=failed)
    return CouplingVars(*(w(do, n, o) for n, o in zip(new, cv)))


def _select(mask, new, old):
    """Leafwise ``where(mask, new, old)`` over a NamedTuple of [P] / [P, k]
    tensors."""
    def pick(n, o):
        m = mask.reshape(mask.shape + (1,) * (n.dim() - mask.dim()))
        return torch.where(m, n, o)
    return type(old)(*(pick(n, o) for n, o in zip(new, old)))


def _restore(state: State, snap: Snapshot, do) -> State:
    """uploadDataForCoupling (src/Coupling.f90:213-255): restore the snapshot
    subset (note: NOT ice, NOT q2melt/t4melt/evap/blcond)."""
    w = lambda n, o: torch.where(do, n, o)
    return state._replace(
        tmp=torch.where(do[..., None], snap.tmp, state.tmp),
        tsurf_ave=w(snap.tsurf_ave, state.tsurf_ave),
        wat=w(snap.wat, state.wat),
        snow=w(snap.snow, state.snow),
        ice2=w(snap.ice2, state.ice2),
        dep=w(snap.dep, state.dep),
        albedo=w(snap.albedo, state.albedo),
        very_cold=w(snap.very_cold, state.very_cold))


def _save(state: State, snap: Snapshot, do) -> Snapshot:
    w = lambda n, o: torch.where(do, n, o)
    return Snapshot(
        tmp=torch.where(do[..., None], state.tmp, snap.tmp),
        tsurf_ave=w(state.tsurf_ave, snap.tsurf_ave),
        wat=w(state.wat, snap.wat),
        snow=w(state.snow, snap.snow),
        ice2=w(state.ice2, snap.ice2),
        dep=w(state.dep, snap.dep),
        albedo=w(state.albedo, snap.albedo),
        very_cold=w(state.very_cold, snap.very_cold))


def _empty_snapshot(state: State) -> Snapshot:
    z = torch.zeros_like(state.tsurf_ave)
    return Snapshot(tmp=torch.zeros_like(state.tmp), tsurf_ave=z, wat=z,
                    snow=z, ice2=z, dep=z, albedo=z,
                    very_cold=torch.zeros_like(state.very_cold))


def _scalar(v: float, dtype, dev):
    """A 0-dim tensor on the device: a divisor given as a Python scalar is
    turned into a multiply by its reciprocal on CUDA, which can move the
    quotient by an ulp; a tensor divisor keeps IEEE division there too."""
    return torch.tensor(v, dtype=dtype, device=dev)


def _grid_tensors(grid: LayerGrid, dtype, dev):
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
    return as_t(grid.dyc), as_t(grid.cond_dz), as_t(grid.wcont)


def _snow_ice_checked(st: State, obs, sel, p: PhysicsParams) -> State:
    """snowIceCheck (src/Coupling.f90:259-289) where ``sel``."""
    checked = storage_mod.snow_ice_check(
        storage_mod.Storages(st.wat, st.snow, st.ice, st.ice2, st.dep),
        obs, p)
    w = lambda n, o: torch.where(sel, n, o)
    return st._replace(wat=w(checked.wat, st.wat),
                       snow=w(checked.snow, st.snow),
                       ice=w(checked.ice, st.ice),
                       ice2=w(checked.ice2, st.ice2),
                       dep=w(checked.dep, st.dep))


def _fields(st: State):
    return torch.stack([st.tsurf_ave, st.wat, st.snow, st.ice, st.ice2,
                        st.dep], dim=-1)


def _abnormal(st: State):
    return (st.tsurf_ave < -100.0) | (st.tsurf_ave > 100.0)


def _coupled_mask(settings: ModelSettings, end_i, obs):
    return bool(settings.use_coupling) & (end_i >= 1) & (obs > -100.0)


def _sky_active(pts: PointParams):
    sky = torch.as_tensor(pts.sky_view)
    return (sky < 1.0) & (sky > -0.01)


def run_coupled(state: State, prep: Prepared, pts: PointParams,
                settings: ModelSettings, cfg: StepConfig, grid: LayerGrid,
                p: PhysicsParams, out_stride: int = 1, depth=None):
    """Full simulation with coupling via the per-point PC (coupling.py:226).

    ``pts``: PointParams of tensors on the state's device.  Returns
    (final_state, out [n_out, P, 6]) where n_out = ceil(sim_len /
    out_stride); out[k] is the output of 1-based step k*out_stride + 1
    (stride 1 == every step, matching SaveOutput).
    """
    T = settings.sim_len
    P = state.tsurf_ave.shape[0]
    dtype, dev = state.tmp.dtype, state.tmp.device
    n_out = -(-T // out_stride)
    dyc, cond_dz, wcont = _grid_tensors(grid, dtype, dev)

    start_i = torch.as_tensor(pts.coupling_start).to(torch.int32)
    end_i = torch.as_tensor(pts.coupling_end).to(torch.int32)
    obs = torch.as_tensor(pts.coupling_tsurf).to(dtype)
    coupling_on = _coupled_mask(settings, end_i, obs)
    sky_active = _sky_active(pts)

    # cof-choice at restore (src/Coupling.f90:66-77): SW if SW(i)>LW(i) at
    # the window start and sky view unused.  sw/lw prep channels equal the
    # pristine inputs when sky view is inactive, which is the only case the
    # SW branch can take.
    pr = torch.arange(P, device=dev)
    sp = torch.clamp(start_i - 1, 0, T - 1).long()
    choice_sw = (prep.sw[sp, pr] > prep.lw[sp, pr]) & (~sky_active)

    cv = CouplingVars.init(P, dtype, obs)
    # setInputParam / initCouplingTimes disable: treat disabled points as
    # never-coupled (coupling_on False); their cv stays inert.
    snap = _empty_snapshot(state)
    # one spare slot takes the writes of inactive or off-stride steps
    out = torch.full((P, n_out + 1, 6), OUT_MISSING, dtype=dtype, device=dev)
    st = state
    i = torch.ones((P,), dtype=torch.int32, device=dev)
    in_coupling = torch.zeros((P,), dtype=torch.bool, device=dev)
    dts = settings.dt
    red = _scalar(settings.coupling_effect_reduction, dtype, dev)
    w = torch.where

    while bool(((i < T) & (~st.failed)).any()):
        active = (i < T) & (~st.failed)
        ip_pre = torch.clamp(i - 1, 0, T - 1).long()

        # CheckValues on the PRE-rewind row; include the abnormal-tsurf
        # check on the PRE-restore state (src/InputOutput.f90:45-84)
        valid = prep.valid[ip_pre, pr] & ~_abnormal(st)

        # ---- CouplingOperations1 (src/Coupling.f90:10-96) --------------
        cpl_act = coupling_on & active
        in_cpl = cpl_act & (i >= start_i) & (i <= end_i)   # pre-rewind flag
        in_coupling = w(active, in_cpl, in_coupling)

        do_save = cpl_act & (i == start_i) & (cv.iterations == 0)
        snap = _save(st, snap, do_save)
        cv = cv._replace(sw_cof=w(do_save, 1.0, cv.sw_cof),
                         lw_cof=w(do_save, 1.0, cv.lw_cof),
                         sw_corr=w(do_save, 0.0, cv.sw_corr),
                         lw_corr=w(do_save, 0.0, cv.lw_corr))

        do_restore = cpl_act & cv.again
        st = _restore(st, snap, do_restore)
        i = w(do_restore, start_i, i)
        cv = cv._replace(
            again=cv.again & ~do_restore,
            sw_cof=w(do_restore, w(choice_sw, cv.radcoeff, 1.0), cv.sw_cof),
            lw_cof=w(do_restore, w(choice_sw, 1.0, cv.radcoeff), cv.lw_cof))

        # decay after the window (:82-88), with the post-rewind index
        past = cpl_act & (i > end_i)
        dec = torch.exp(-((dts * i.to(dtype)) - (dts * end_i.to(dtype)))
                        / red)
        cv = cv._replace(sw_cof=w(past, 1.0 + cv.sw_corr * dec, cv.sw_cof),
                         lw_cof=w(past, 1.0 + cv.lw_corr * dec, cv.lw_cof))

        # snowIceCheck inside the window (pre-rewind flag, post-restore state)
        st = _snow_ice_checked(st, obs, in_cpl, p)

        # ---- the step at the (possibly rewound) index ------------------
        ip = torch.clamp(i - 1, 0, T - 1).long()
        g = lambda ch: ch[ip, pr]
        f = StepForcing(
            tair=g(prep.tair), vz=g(prep.vz), rhz=g(prep.rhz),
            rain=g(prep.rain), snow=g(prep.snow), sw=g(prep.sw),
            lw=g(prep.lw), tsurf_obs=g(prep.tsurf_obs), valid=valid,
            in_coupling=in_cpl, trf_fric=prep.trf_fric[ip],
            sw_cof=cv.sw_cof, lw_cof=cv.lw_cof)
        stepped = step(st, f, obs, cfg, dyc, cond_dz, wcont, p, depth=depth)
        st_new = _select(active, stepped, st)

        # ---- SaveOutput scatter (out[i-1] when on stride) ---------------
        fields = w(st.failed[..., None], OUT_MISSING, _fields(st_new))
        on_stride = (ip % out_stride) == 0
        slot = w(active & on_stride, ip // out_stride, n_out).long()
        out[pr, slot] = fields

        # ---- CheckEndCoupling (src/Coupling.f90:98-118) -----------------
        do_control = cpl_act & (i == end_i) & (~cv.failed) & (~st_new.failed)
        cv = coupling_control(st_new.tsurf_ave, obs, cv, do_control)

        i = w(active, i + 1, i)
        st = st_new

    return _last_values(st, cv, in_coupling, prep, pts, cfg, grid, p, T,
                        n_out, out_stride, out[:, :n_out], depth=depth)


def _last_values(st, cv, in_coupling, prep, pts, cfg, grid, p, T, n_out,
                 out_stride, out, depth=None):
    """The final step (lastValues; Simulation.f90:100-113) shared by the
    per-point-PC and segmented coupled engines (coupling.py:375-416).
    ``out``: [P, n_out, 6]; returns (final_state, out [n_out, P, 6])."""
    dtype, dev = st.tmp.dtype, st.tmp.device
    P = st.tsurf_ave.shape[0]
    obs = torch.as_tensor(pts.coupling_tsurf).to(dtype)
    dyc, cond_dz, wcont = _grid_tensors(grid, dtype, dev)
    ip = T - 1
    ok = ~st.failed
    f = StepForcing(
        tair=prep.tair[ip], vz=prep.vz[ip], rhz=prep.rhz[ip],
        rain=prep.rain[ip], snow=prep.snow[ip], sw=prep.sw[ip],
        lw=prep.lw[ip],
        tsurf_obs=torch.full((P,), -9999.9, dtype=dtype, device=dev),
        valid=torch.ones((P,), dtype=torch.bool, device=dev),
        in_coupling=in_coupling, trf_fric=prep.trf_fric[ip],
        sw_cof=cv.sw_cof, lw_cof=cv.lw_cof)
    # lastValues recomputes TsurfAve from the committed profile first
    didx, dw, duse = depth if depth is not None else (
        cfg.depth_idx, cfg.depth_w, cfg.use_depth)
    tmp0 = st.tmp.clone()
    tmp0[..., 0] = torch.where(ok, f.tair, st.tmp[..., 0])
    st = st._replace(
        tmp=tmp0,
        tsurf_ave=torch.where(ok, surface_average(tmp0, didx, dw, duse),
                              st.tsurf_ave))
    stepped = step(st, f, obs, cfg, dyc, cond_dz, wcont, p, depth=depth)
    st_final = _select(ok, stepped, st)
    fields = torch.where((~ok)[..., None], OUT_MISSING, _fields(st_final))
    # failed points keep their poison row for the final slot too
    if ip % out_stride == 0:
        slot = ip // out_stride
        out = out.clone()
        out[:, slot] = torch.where(ok[..., None], fields, out[:, slot])
    return st_final, out.transpose(0, 1)


# ---------------------------------------------------------------------------
# Segmented coupled engine: iteration-major window re-runs
# ---------------------------------------------------------------------------
#
# The SAME per-point step sequences as the PC engine, reorganised into three
# phases so the hot path is contiguous row slices (coupling.py:419-447):
#
#   phase A  [1, ws-1]   plain scan, no coupling state touched
#   phase B  [ws, we_b]  the global coupling window (ws = min coupling_start,
#                        we_b = min(max coupling_end, T-1)):
#            pass "first":  every point steps; coupled points stop at their
#                           own end_i (snapshot at start_i, control at end_i)
#            pass "rerun":  each pass restores the snapshot for points whose
#                           control said rewind and replays ONLY their
#                           [start_i, end_i], masked
#            pass "tail":   coupled points step (end_i, we_b] with the decayed
#                           radiation coefficients
#   phase C  [we_b+1, T]  plain scan with the decay folded into per-step
#                         sw_cof/lw_cof channels (forcing.cof_window)
#
# Every executed (point, step) pair sees the PC engine's inputs (incl. the
# pre-rewind quirks), so the two engines agree bit for bit in float64
# (tests/test_torch_coupling.py).  The pass mode is a Python value here, and
# rows outside [ws, we_b] (the padded tail of the last chunk) are skipped:
# every one of their updates is masked off.


class WindowResult(NamedTuple):
    state: State              #: state after step we_b
    cv: CouplingVars          #: final coupling vars (sw_corr/lw_corr set)
    out: torch.Tensor         #: [n_out_b, P, 6] window output rows
    in_coupling: torch.Tensor  #: [P] flag after the last window step
    reruns: int               #: window re-run passes executed
    rows: int                 #: window rows stepped, over all passes
    point_reruns: torch.Tensor  #: [P] int32, the passes each point re-ran


def window_out_rows(ws: int, we_b: int, out_stride: int):
    """Global 0-based output rows the window emits: r in [ws-1, we_b-1] with
    r %% out_stride == 0."""
    first = -(-(ws - 1) // out_stride) * out_stride
    return np.arange(first, we_b, out_stride, dtype=np.int64)


def window_span(settings: ModelSettings, pts: PointParams):
    """(coupled [P] numpy mask, (ws, we_b) or None): the global window of
    the phase split, ws = min coupling_start (>= 1) and we_b = min(max
    coupling_end, T-1) over the coupled points; None when no point couples
    or the window is empty.  ``pts`` leaves may be numpy or tensors."""
    host = lambda x: np.asarray(torch.as_tensor(x).cpu())
    start, end = host(pts.coupling_start), host(pts.coupling_end)
    coupled = (bool(settings.use_coupling) & (end >= 1)
               & (host(pts.coupling_tsurf) > -100.0))
    if not coupled.any():
        return coupled, None
    ws = max(int(start[coupled].min()), 1)
    we_b = int(min(end[coupled].max(), settings.sim_len - 1))
    return coupled, ((ws, we_b) if ws <= we_b else None)


M_FIRST, M_RERUN, M_TAIL, M_DONE = 0, 1, 2, 3


def run_window_passes(state: State, provider, valid_win, ws: int, we_b: int,
                      pts: PointParams, settings: ModelSettings,
                      cfg: StepConfig, grid: LayerGrid, p: PhysicsParams,
                      out_stride: int = 1, depth=None, wchunk: int = 64,
                      cv: CouplingVars = None) -> WindowResult:
    """Execute the global coupling window [ws, we_b] (1-based steps;
    coupling.py:466-690).

    ``provider(t0)`` -> Prepared chunk with [wchunk, P] leaves covering
    global 0-based forcing rows [t0, t0+wchunk) (t0 is a multiple of wchunk
    past ws-1; rows beyond we_b-1 are skipped and may hold any finite data).
    ``valid_win``: [we_b - ws + 2, P] bool, prep.valid rows ws-1 .. we_b
    (the +1 row feeds the re-run first-step CheckValues quirk).
    ``pts``: PointParams of tensors on the state's device.
    ``state``: after step ws-1.  Returns state after step we_b.  Each pass
    reads the span of its active points on the host (one sync per pass).
    """
    T = settings.sim_len
    P = state.tsurf_ave.shape[0]
    dtype, dev = state.tmp.dtype, state.tmp.device
    W = we_b - ws + 1
    if not (W >= 1 and we_b <= T - 1):
        raise ValueError(f"bad window [{ws}, {we_b}] for T={T}")
    wchunk = min(wchunk, W)
    nchunks = -(-W // wchunk)
    dyc, cond_dz, wcont = _grid_tensors(grid, dtype, dev)

    start_i = torch.as_tensor(pts.coupling_start).to(torch.int32)
    end_i = torch.as_tensor(pts.coupling_end).to(torch.int32)
    obs = torch.as_tensor(pts.coupling_tsurf).to(dtype)
    coupled = _coupled_mask(settings, end_i, obs)
    sky_active = _sky_active(pts)

    if cv is None:
        cv = CouplingVars.init(P, dtype, obs)
    snap = _empty_snapshot(state)

    out_rows = window_out_rows(ws, we_b, out_stride)
    n_out_b = max(len(out_rows), 1)
    first_hit = int(out_rows[0]) if len(out_rows) else 0
    out = torch.full((n_out_b, P, 6), OUT_MISSING, dtype=dtype, device=dev)
    choice = torch.zeros((P,), dtype=torch.bool, device=dev)

    tau = _scalar(settings.coupling_effect_reduction, dtype, dev)
    dts = settings.dt
    w = torch.where
    pr = torch.arange(P, device=dev)
    vrow_idx = torch.clamp(end_i - (ws - 1), 0,
                           valid_win.shape[0] - 1).long()

    def rr_mask(st, cv):
        # a point whose window ends at step T-1 never rewinds: the rewind
        # fires at i = end_i + 1, and the PC loop stops at i < T
        return cv.again & coupled & (end_i + 1 < T) & (~st.failed)

    def row(st, cv, snap, choice, out, mode, rr, vf, fr, i):
        """One window row (1-based step i) of pass ``mode``; ``fr`` is the
        row's Prepared forcing ([P] leaves, trf_fric a scalar)."""
        entry_ok = ~st.failed
        in_window = (i >= start_i) & (i <= end_i)
        if mode == M_FIRST:
            mode_mask = w(coupled, i <= end_i, True)
        elif mode == M_RERUN:
            mode_mask = rr & in_window
        else:
            mode_mask = coupled & (i > end_i)
        act = mode_mask & entry_ok

        if mode == M_FIRST:
            # saveDataForCoupling + cof reset, first pass only
            # (src/Coupling.f90:55-64); the cof-choice input
            # (src/Coupling.f90:66-77) is captured at the window-start row
            at_start = act & coupled & (i == start_i)
            do_save = at_start & (cv.iterations == 0)
            snap = _save(st, snap, do_save)
            cv = cv._replace(sw_cof=w(do_save, 1.0, cv.sw_cof),
                             lw_cof=w(do_save, 1.0, cv.lw_cof),
                             sw_corr=w(do_save, 0.0, cv.sw_corr),
                             lw_corr=w(do_save, 0.0, cv.lw_corr))
            choice = w(at_start, (fr.sw > fr.lw) & (~sky_active), choice)
            in_cpl = act & coupled & in_window
        elif mode == M_RERUN:
            # pre-rewind flag: the first re-run step (i == start_i) ran with
            # i = end_i + 1 before the rewind -> flag False
            in_cpl = act & (i > start_i) & (i <= end_i)
        else:
            in_cpl = torch.zeros_like(act)

        # CheckValues (+ abnormal tsurf on the body-entry state); the first
        # re-run step uses the pre-rewind row end_i (vf, set at pass entry)
        vld_step = fr.valid & ~_abnormal(st)
        if mode == M_RERUN:
            vld_step = w(act & (i == start_i), vf, vld_step)

        # snowIceCheck inside the window (src/Coupling.f90:259-289)
        st = _snow_ice_checked(st, obs, in_cpl, p)

        swc, lwc = cv.sw_cof, cv.lw_cof
        if mode == M_TAIL:
            # post-window decay (src/Coupling.f90:82-88)
            i_f = torch.full((), i, dtype=dtype, device=dev)
            expo = -(dts * i_f - dts * end_i.to(dtype)) / tau
            dec = torch.exp(torch.clamp(expo, max=0.0))
            swc = w(act, 1.0 + cv.sw_corr * dec, cv.sw_cof)
            lwc = w(act, 1.0 + cv.lw_corr * dec, cv.lw_cof)

        f = StepForcing(tair=fr.tair, vz=fr.vz, rhz=fr.rhz, rain=fr.rain,
                        snow=fr.snow, sw=fr.sw, lw=fr.lw,
                        tsurf_obs=fr.tsurf_obs, valid=vld_step,
                        in_coupling=in_cpl, trf_fric=fr.trf_fric,
                        sw_cof=swc, lw_cof=lwc)
        stepped = step(st, f, obs, cfg, dyc, cond_dz, wcont, p, depth=depth)
        st_new = _select(act, stepped, st)

        # SaveOutput row (overwritten by later re-runs where active)
        if (i - 1) % out_stride == 0:
            slot = min(max((i - 1 - first_hit) // out_stride, 0),
                       n_out_b - 1)
            fields = w(st.failed[..., None], OUT_MISSING, _fields(st_new))
            out[slot] = w(act[..., None], fields, out[slot])

        # CheckEndCoupling (src/Coupling.f90:98-118), never in the tail
        if mode != M_TAIL:
            do_ctl = (act & coupled & (i == end_i) & (~cv.failed)
                      & (~st_new.failed))
            cv = coupling_control(st_new.tsurf_ave, obs, cv, do_ctl)
        return st_new, cv, snap, choice

    st = state
    mode = M_FIRST
    rr = torch.zeros((P,), dtype=torch.bool, device=dev)
    vf = torch.zeros((P,), dtype=torch.bool, device=dev)
    nreruns = nrows = 0
    point_reruns = torch.zeros((P,), dtype=torch.int32, device=dev)
    big = 2 * T + 2
    while mode < M_DONE:
        # pass-narrowing: a re-run pass only needs the chunks covering the
        # still-rewinding points' [min start, max end]; the tail pass only
        # the rows past the earliest coupled window end.  Masked rows are
        # exact no-ops, so skipping their chunks changes nothing.
        if mode == M_RERUN:
            lo_i = int(torch.where(rr, start_i, big).min())
            hi_i = int(torch.where(rr, end_i, -1).max())
        elif mode == M_TAIL:
            lo_i = int(torch.where(coupled, end_i, big).min()) + 1
            hi_i = we_b
        else:
            lo_i, hi_i = ws, we_b
        k_lo = min(max((lo_i - ws) // wchunk, 0), nchunks)
        k_hi = min(max((hi_i - ws) // wchunk + 1, k_lo), nchunks)
        for k in range(k_lo, k_hi):
            t0 = ws - 1 + wchunk * k
            prep_c = provider(t0)
            for r in range(wchunk):
                i = t0 + 1 + r
                if not ws <= i <= we_b:
                    continue
                fr = Prepared(*(x[r] for x in prep_c[:-1]),
                              trf_fric=prep_c.trf_fric[r].to(dtype))
                st, cv, snap, choice = row(st, cv, snap, choice, out, mode,
                                           rr, vf, fr, i)
                nrows += 1
        # transition: enter (another) re-run round while any point's control
        # asked to rewind, else run the tail exactly once, then stop
        rr2 = rr_mask(st, cv)
        enter_rerun = mode <= M_RERUN and bool(rr2.any())
        if mode == M_TAIL:
            mode = M_DONE
        elif enter_rerun:
            mode = M_RERUN
        else:
            mode = M_TAIL
        if enter_rerun:
            do_r = rr2
            # CheckValues of the pre-rewind row end_i on the PRE-restore
            # state
            vf = valid_win[vrow_idx, pr] & ~_abnormal(st)
            st = _restore(st, snap, do_r)
            cv = cv._replace(
                again=cv.again & ~do_r,
                sw_cof=w(do_r, w(choice, cv.radcoeff, 1.0), cv.sw_cof),
                lw_cof=w(do_r, w(choice, 1.0, cv.radcoeff), cv.lw_cof))
            nreruns += 1
            point_reruns = point_reruns + do_r.to(torch.int32)
        else:
            do_r = torch.zeros_like(rr2)
        rr = do_r

    in_cpl_last = coupled & (we_b >= start_i) & (we_b <= end_i)
    return WindowResult(state=st, cv=cv, out=out, in_coupling=in_cpl_last,
                        reruns=nreruns, rows=nrows, point_reruns=point_reruns)


def run_coupled_segmented(state: State, prep: Prepared, pts: PointParams,
                          settings: ModelSettings, cfg: StepConfig,
                          grid: LayerGrid, p: PhysicsParams,
                          out_stride: int = 1, depth=None, wchunk: int = 64):
    """run_coupled via the segmented engine (scan phases A/C + the
    iteration-major window; coupling.py:693-799).  Same signature and the
    same float64 results; the production run swaps phases A/C for the
    streamed scan kernel."""
    from .model import scan_steps

    T = settings.sim_len
    P = state.tsurf_ave.shape[0]
    dtype, dev = state.tmp.dtype, state.tmp.device
    n_out = -(-T // out_stride)
    obs = torch.as_tensor(pts.coupling_tsurf).to(dtype)
    _, span = window_span(settings, pts)
    cv = CouplingVars.init(P, dtype, obs)

    out = torch.full((P, n_out, 6), OUT_MISSING, dtype=dtype, device=dev)

    def commit_rows(out, sim, t_lo):
        """Fold a collected scan segment (SimOutput, rows t_lo..) into the
        global strided buffer."""
        rows = np.arange(t_lo, t_lo + sim.tsurf.shape[0])
        hit = rows % out_stride == 0
        if not hit.any():
            return out
        rsel = torch.as_tensor(np.nonzero(hit)[0], device=dev)
        fields = torch.stack([x[rsel] for x in sim], dim=-1)   # [k, P, 6]
        slots = torch.as_tensor(rows[hit] // out_stride, device=dev)
        out[:, slots] = fields.transpose(0, 1)
        return out

    def seg(x, lo, hi):
        return type(x)(*(a[lo:hi] for a in x))

    ones = lambda n: torch.ones((n, P), dtype=dtype, device=dev)

    if span is None:
        final, sim = scan_steps(state, seg(prep, 0, T - 1), ones(T - 1),
                                ones(T - 1), obs, cfg, grid, p, depth=depth)
        out = commit_rows(out, sim, 0)
        return _last_values(final, cv, prep.in_coupling[T - 1], prep, pts,
                            cfg, grid, p, T, n_out, out_stride, out,
                            depth=depth)

    # ---- phase A ---------------------------------------------------------
    ws, we_b = span
    if ws > 1:
        state, sim = scan_steps(state, seg(prep, 0, ws - 1), ones(ws - 1),
                                ones(ws - 1), obs, cfg, grid, p, depth=depth)
        out = commit_rows(out, sim, 0)

    # ---- phase B ---------------------------------------------------------
    W = we_b - ws + 1
    wck = min(wchunk, W)
    W_pad = -(-W // wck) * wck
    over = ws - 1 + W_pad - T

    def pad_rows(a):
        body = a[ws - 1:ws - 1 + W_pad]
        if over <= 0:
            return body
        return torch.cat([body, a[we_b - 1:we_b].repeat(
            (over,) + (1,) * (a.dim() - 1))])
    wprep = Prepared(*(pad_rows(a) for a in prep))
    provider = lambda t0: Prepared(
        *(a[t0 - (ws - 1):t0 - (ws - 1) + wck] for a in wprep))
    valid_win = prep.valid[ws - 1: we_b + 1]

    res = run_window_passes(state, provider, valid_win, ws, we_b, pts,
                            settings, cfg, grid, p, out_stride=out_stride,
                            depth=depth, wchunk=wck)
    rows_b = window_out_rows(ws, we_b, out_stride)
    if len(rows_b):
        out[:, torch.as_tensor(rows_b // out_stride, device=dev)] = \
            res.out[:len(rows_b)].transpose(0, 1)
    state, cv = res.state, res.cv

    # ---- phase C ---------------------------------------------------------
    end_t = torch.as_tensor(pts.coupling_end)
    if we_b < T - 1:
        swc, lwc = cof_window(cv.sw_corr, cv.lw_corr, end_t, we_b,
                              T - 1 - we_b, T, settings, dtype)
        state, sim = scan_steps(state, seg(prep, we_b, T - 1), swc, lwc,
                                obs, cfg, grid, p, depth=depth)
        out = commit_rows(out, sim, we_b)

    # ---- final step ------------------------------------------------------
    fin_sw, fin_lw = cof_window(cv.sw_corr, cv.lw_corr, end_t, T - 1, 1, T,
                                settings, dtype)
    cv = cv._replace(sw_cof=fin_sw[0], lw_cof=fin_lw[0])
    # the PC engine's final-step flag is the analytic flag at step T-1,
    # which prepare() already encodes in the last in_coupling row
    return _last_values(state, cv, prep.in_coupling[T - 1], prep, pts, cfg,
                        grid, p, T, n_out, out_stride, out, depth=depth)
