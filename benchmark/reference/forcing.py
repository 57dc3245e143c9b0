"""Frozen copy of ``roadsurf_tpu_torch/forcing.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Forcing preparation: one vectorized [T, P] pass over the weather inputs.

The counterpart of ``roadsurf_tpu/forcing.py``.  The reference evaluates
input validation, relaxation smoothing, precipitation typing, solar position
and sky-view radiation correction scalar-per-step inside the time loop
(examples/example1/src/Simulation.f90:58-95).  All of those are pure
functions of (forcing, time, location) -- none touch prognostic state -- so
they are hoisted out of the sequential scan into a single batched pass here.
The scan step then only consumes the channels in :class:`Prepared`.

Index conventions: step t (0-based) corresponds to the reference's 1-based
loop index i = t + 1 and consumes forcing row t.  The final step t = T-1
replicates the reference's ``lastValues`` quirks (no CheckValues, no
relaxation, no obs forcing, frozen coupling flags;
examples/example1/src/Simulation.f90:100-113, src/InputOutput.f90:169-198).

Dtypes follow the JAX package under 64-bit mode: the relaxation decay is
float64 and promotes what it touches; every channel is cast to the run dtype
at the end (forcing.py:278-283).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams, MISSING
from .physics import storage
from .physics.radiation import modify_radiation
from .physics.sun import julian_ephemeris_day, sun_at_points, sun_time_terms
from .state import PointParams


class Calendar(NamedTuple):
    """Per-step UTC calendar of the simulation grid, [T] int numpy arrays."""
    year: np.ndarray
    month: np.ndarray
    day: np.ndarray
    hour: np.ndarray
    minute: np.ndarray
    second: np.ndarray

    @classmethod
    def from_epochs(cls, epochs: np.ndarray) -> "Calendar":
        dt64 = np.asarray(epochs, dtype="datetime64[s]")
        y = dt64.astype("datetime64[Y]").astype(int) + 1970
        mo = dt64.astype("datetime64[M]").astype(int) % 12 + 1
        d = (dt64.astype("datetime64[D]") - dt64.astype("datetime64[M]")).astype(int) + 1
        h = (dt64.astype("datetime64[h]") - dt64.astype("datetime64[D]")).astype(int)
        mi = (dt64.astype("datetime64[m]") - dt64.astype("datetime64[h]")).astype(int)
        s = (dt64.astype("datetime64[s]") - dt64.astype("datetime64[m]")).astype(int)
        return cls(y, mo, d, h, mi, s)

    @classmethod
    def from_start(cls, start_epoch: int, dt: float, sim_len: int) -> "Calendar":
        epochs = start_epoch + (np.arange(sim_len) * dt).astype(np.int64)
        return cls.from_epochs(epochs)

    @property
    def jde(self) -> np.ndarray:
        return julian_ephemeris_day(self.year, self.month, self.day,
                                    self.hour, self.minute, self.second)


def valid_threshold(name: str) -> float:
    """Per-variable overlay validity threshold (DataHandler per-value merge,
    examples/example1/src/DataHandler.cpp:73-82; forcing.py:62-67): values
    above it are present.  lw_net is a NET flux and legitimately negative."""
    return -1000.0 if name == "lw_net" else -100.0


class RawForcing(NamedTuple):
    """Interpolated-to-grid weather inputs, [P, T] float (missing = -9999.9
    except lw_net whose missing threshold is -1000; src/InputArrays.f90.inc)."""
    tair: torch.Tensor
    tdew: torch.Tensor
    vz: torch.Tensor
    rhz: torch.Tensor
    prec: torch.Tensor       #: mm/h
    sw: torch.Tensor
    lw: torch.Tensor
    sw_dir: torch.Tensor
    lw_net: torch.Tensor
    tsurf_obs: torch.Tensor
    prec_phase: torch.Tensor  #: int codes, missing = -9999


class Prepared(NamedTuple):
    """Scan-ready forcing, time-major [T, P] (plus [T] shared channels)."""
    tair: torch.Tensor
    vz: torch.Tensor          #: relaxed + calm-limit floored
    rhz: torch.Tensor
    rain: torch.Tensor        #: mm added to water storage this step
    snow: torch.Tensor        #: mm added to snow storage this step
    sw: torch.Tensor          #: effective SW (sky-view modified)
    lw: torch.Tensor          #: effective LW
    tsurf_obs: torch.Tensor   #: obs to force into the profile, else -9999.9
    valid: torch.Tensor       #: bool, CheckValues outcome
    in_coupling: torch.Tensor  #: bool, melting-guard coupling phase flag
    trf_fric: torch.Tensor    #: [T] traffic friction heat


def relax_anchors(raw: RawForcing, pts: PointParams):
    """Relaxation anchor values (X_initEnd, src/Relaxation.f90:10-47): the
    forcing at the 0-based anchor step init_len-1, with the first-step wind
    floor applied first (Initialization.f90:121-123).  raw: [P, T];
    returns ([P] tair, vz, rhz).

    numpy in -> numpy out (host data plane); tensors in -> tensors out."""
    if not isinstance(raw.tair, torch.Tensor):
        tair = np.asarray(raw.tair)
        vz = np.array(raw.vz)
        rhz = np.asarray(raw.rhz)
        vz[..., 0] = np.maximum(vz[..., 0], 0.4)
        t0 = np.maximum(np.asarray(pts.init_len, np.int64) - 1, 0)[..., None]
        anchor = lambda x: np.take_along_axis(x, t0, axis=-1)[..., 0]
        return anchor(tair), anchor(vz), anchor(rhz)
    vz = raw.vz.clone()
    vz[..., 0] = torch.clamp(vz[..., 0], min=0.4)
    t0 = torch.clamp(torch.as_tensor(pts.init_len, device=vz.device)
                     .to(torch.int64) - 1, min=0)[..., None]
    anchor = lambda x: torch.gather(x, -1, t0)[..., 0]
    return anchor(raw.tair), anchor(vz), anchor(raw.rhz)


def prepare_window(rawT: RawForcing, pts: PointParams, hour, settings, p,
                   t_offset=0, t_total: int = None, anchors=None, jde=None,
                   enable_skyview: bool = False, flat_horizons: bool = False,
                   time_axis: int = 0) -> Prepared:
    """Window-parameterized forcing preparation (forcing.py:127-283).

    The production engine streams forcing in time chunks; every
    step-dependent rule here is written analytically in the GLOBAL step
    index, so chunked calls compose to exactly ``prepare``'s output.

    rawT: RawForcing with tensor leaves covering global steps
    [t_offset, t_offset + Tc), time on axis ``time_axis`` and point axes of
    any shape on the others: time-major [Tc, P] (``time_axis=0``), or the
    kernel's tile layout [n_tiles, Tc, TP] (``time_axis=1``); pts and
    anchors: leaves of the point shape on the same device (horizons:
    [*point_shape, 360], the 360 axis last); hour: [Tc] UTC hours tensor;
    t_total: full simulation length T (for the first/last-step quirks);
    anchors: the ``relax_anchors`` triple (required when
    settings.use_relaxation); jde: [Tc] julian ephemeris day tensor
    (required when ``enable_skyview``), float64: the sun's time terms are
    formed from it in float64 and cast to the run dtype, since a float32 day
    steps by 0.25 day (``physics.sun.sun_time_terms``); flat_horizons: the horizons are all
    zero, so the lookup is skipped and ``pts.horizons`` is not read.  Every
    rule is elementwise over points, so the tile layout gives the values of
    the [Tc, P] layout, bit for bit, sky view included.
    """
    ta = time_axis
    dtype = rawT.tair.dtype
    dev = rawT.tair.device
    nd = rawT.tair.dim()
    Tc = rawT.tair.shape[ta]
    t_idx = t_offset + torch.arange(Tc, device=dev)   # [Tc] global step index

    def tb(x):                                    # [Tc] -> time-axis column
        return x.reshape((1,) * ta + (Tc,) + (1,) * (nd - ta - 1))

    def pvec(x):                                  # point-shaped -> + time
        return x.unsqueeze(ta)

    last = tb(t_idx == t_total - 1)               # the lastValues step

    skyview_active = (pts.sky_view < 1.0) & (pts.sky_view > -0.01)

    # --- CheckValues (src/InputOutput.f90:45-84); the final step skips it
    # (Simulation.f90:100-113) --------------------------------------------
    ok = ((rawT.tair >= -90.0) & (rawT.tair <= 100.0)
          & (rawT.tdew >= -90.0) & (rawT.tdew <= 100.0)
          & (rawT.rhz >= -0.1) & (rawT.rhz <= 120.0)
          & (rawT.vz >= -1.0) & (rawT.vz <= 100.0)
          & (rawT.sw >= -0.1) & (rawT.sw <= 4000.0)
          & (rawT.lw >= -0.1) & (rawT.lw <= 1000.0)
          & (rawT.prec >= -0.1) & (rawT.prec <= 500.0))
    sky_ok = ((rawT.sw_dir >= -0.1) & (rawT.sw_dir <= 4000.0)
              & (rawT.lw_net >= -1000.0) & (rawT.lw_net <= 1000.0))
    ok = ok & (sky_ok | ~pvec(skyview_active))
    valid = ok | last

    # Initialization.f90:121-123 -- first wind value floored before anything
    vz = torch.where(tb(t_idx == 0), torch.clamp(rawT.vz, min=0.4), rawT.vz)

    # CheckValues SW_dir <= SW clamp (InputOutput.f90:75-77); the last step
    # skips CheckValues, so the clamp is masked off there.
    sw_dir = torch.where(last, rawT.sw_dir,
                         torch.minimum(rawT.sw_dir, rawT.sw))

    # --- sky view / local horizons (ModRadiation, applied per point where
    # 0 <= sky_view < 1; Simulation.f90:152-155) -------------------------
    sw, lw = rawT.sw, rawT.lw
    if enable_skyview:
        terms = sun_time_terms(jde.to(torch.float64))
        elev, azim = sun_at_points(*(tb(x.to(dtype)) for x in terms),
                                   pvec(pts.lat), pvec(pts.lon))
        sw_m, lw_m = modify_radiation(sw, sw_dir, lw, rawT.lw_net,
                                      elev, azim, pvec(pts.sky_view),
                                      pts.horizons, p,
                                      flat_horizons=flat_horizons,
                                      time_axis=ta)
        sw = torch.where(pvec(skyview_active), sw_m, sw)
        lw = torch.where(pvec(skyview_active), lw_m, lw)

    # --- relaxation (RelaxationOperations, src/Relaxation.f90:10-47) ----
    # atm%TDew's recompute in the reference is a dead store (forcing.py:
    # 213-218), so the boundary layer consumes rhz directly.
    tair, rhz = rawT.tair, rawT.rhz
    relax_valid = ((pts.tair_relax >= -100.0) & (pts.tair_relax <= 100.0)
                   & (pts.vz_relax >= 0.0) & (pts.vz_relax <= 100.0)
                   & (pts.rh_relax >= 0.0) & (pts.rh_relax <= 110.0))
    relax_on = relax_valid & bool(settings.use_relaxation)
    if settings.use_relaxation:
        if anchors is None:
            raise ValueError("relaxation requires relax_anchors()")
        tair_a, vz_a, rhz_a = anchors
        t0 = pvec(pts.init_len.to(torch.int64) - 1)  # 0-based anchor step
        tcol = tb(t_idx)
        # adjustment applies for 1-based i > InitLenI, i.e. t >= init_len,
        # and never to the final step (lastValues)
        adj_mask = (tcol >= t0 + 1) & (~last) & pvec(relax_on)
        decay = torch.exp(-(settings.dt * (tcol - t0).to(torch.float64))
                          / (4.0 * 3600.0))
        tair = torch.where(adj_mask,
                           tair - (pvec(pts.tair_relax) - pvec(tair_a)) * decay,
                           tair)
        vz = torch.where(adj_mask,
                         vz - (pvec(pts.vz_relax) - pvec(vz_a)) * decay, vz)
        rhz_adj = rhz - (pvec(pts.rh_relax) - pvec(rhz_a)) * decay
        rhz = torch.where(adj_mask, torch.clamp(rhz_adj, max=100.0), rhz)

    # --- day/night traffic + wind floor (SetDayDependendVariables,
    # src/BalanceModel.f90:354-387) --------------------------------------
    is_night = (hour >= p.night_on) | (hour <= p.night_off)
    pick = lambda a, b: torch.where(
        is_night, torch.tensor(a, dtype=dtype, device=dev),
        torch.tensor(b, dtype=dtype, device=dev))
    calm_lim = pick(p.calm_lim_ngt, p.calm_lim_day)
    trf_fric = pick(p.trf_fric_ngt, p.trf_fric_day)
    vz = torch.maximum(vz, tb(calm_lim))

    # --- precipitation typing (pure in forcing after relaxation) --------
    prec_step = rawT.prec / 3600.0 * settings.dt  # SetCurrentValues :111
    rain, snow, _ = storage.calc_prec_type(rawT.prec_phase, prec_step,
                                           tair, rhz, p)

    # --- obs forcing of the surface temperature (SetCurrentValues,
    # src/InputOutput.f90:116-148) ---------------------------------------
    tcol = tb(t_idx)
    in_init = (tcol + 1) <= pvec(pts.init_len)
    force_phase = in_init | bool(settings.force_tsurf)
    coupling_on = ((pts.coupling_end >= 1)
                   & (pts.coupling_tsurf > -100.0)
                   & bool(settings.use_coupling))
    before_window = (~pvec(coupling_on)) | ((tcol + 1) < pvec(pts.coupling_start))
    obs_ok = rawT.tsurf_obs > -100.0
    forced = force_phase & obs_ok & before_window & (~last)
    tsurf_obs = torch.where(forced, rawT.tsurf_obs,
                            torch.full_like(rawT.tsurf_obs, MISSING))

    # --- coupling-phase flag for the melting guard ----------------------
    # the final step keeps the previous flag (no CouplingOperations1 there):
    # the flag is analytic in t, so the last step evaluates it at t-1.
    te = torch.where((t_idx == t_total - 1) & (t_total >= 2), t_idx - 1,
                     t_idx)
    tecol = tb(te)
    in_coupling = (pvec(coupling_on)
                   & ((tecol + 1) >= pvec(pts.coupling_start))
                   & ((tecol + 1) <= pvec(pts.coupling_end)))

    f = lambda x: x.to(dtype)
    return Prepared(
        tair=f(tair), vz=f(vz), rhz=f(rhz), rain=f(rain), snow=f(snow),
        sw=f(sw), lw=f(lw), tsurf_obs=f(tsurf_obs),
        valid=valid, in_coupling=in_coupling, trf_fric=trf_fric,
    )


def prepare(raw: RawForcing, pts: PointParams, cal: Calendar,
            settings: ModelSettings, p: PhysicsParams) -> Prepared:
    """Build the prepared forcing tensors.  raw/pts: [P, T] / [P] tensors on
    one device; output [T, P].

    Thin wrapper over :func:`prepare_window` with the full [0, T) window."""
    T = raw.tair.shape[-1]
    dev = raw.tair.device

    skyview_active = (pts.sky_view < 1.0) & (pts.sky_view > -0.01)
    enable_skyview = bool(skyview_active.any())
    anchors = relax_anchors(raw, pts) if settings.use_relaxation else None
    # the Julian day stays float64 whatever the run dtype (the JAX package
    # rounds it to the run dtype, forcing.py:301: 0.25 day in float32)
    jde = (torch.as_tensor(cal.jde, dtype=torch.float64, device=dev)
           if enable_skyview else None)
    rawT = RawForcing(*(x.transpose(-1, 0) for x in raw))
    return prepare_window(rawT, pts,
                          torch.as_tensor(np.asarray(cal.hour), device=dev),
                          settings, p, t_offset=0, t_total=T,
                          anchors=anchors, jde=jde,
                          enable_skyview=enable_skyview)


def cof_window(sw_corr, lw_corr, coupling_end, t_offset: int, tc: int,
               T: int, settings: ModelSettings, dtype=torch.float64):
    """Post-window radiation-coefficient rows [t_offset, t_offset+tc)
    (0-based rows; row t = 1-based step t+1), valid only for rows at/after
    every point's coupling_end (forcing.py:309-330).

    Replicates the per-point-PC carry exactly (src/Coupling.f90:82-88 plus
    the final-step freeze): the final step reuses the step-(T-1) value, which
    for a window ending at T-1 is the *undecayed* trial coefficient
    (dec(end)=1), not 1.0.  Each product and the quotient round on their own
    in ``dtype``, as the kernel's in-kernel decay does."""
    end = torch.as_tensor(coupling_end)
    rows = t_offset + torch.arange(tc, device=end.device)
    i = rows + 1
    i_eff = torch.where((rows == T - 1) & (T >= 2), i - 1, i)   # lastValues
    end = end[None, :]
    dts = settings.dt
    # a tensor divisor: CUDA turns a Python-scalar divisor into a multiply
    # by its reciprocal, which the kernel's IEEE division would not match;
    # filled on the device (a tensor copied from the host would wait for
    # the stream in every chunk of a pipelined run)
    red = torch.full((), settings.coupling_effect_reduction, dtype=dtype,
                     device=end.device)
    expo = -((dts * i_eff.to(dtype))[:, None] - dts * end.to(dtype)) / red
    dec = torch.exp(torch.clamp(expo, max=0.0))
    on = (i_eff[:, None] >= end) & (end >= 1)
    sw = torch.where(on, 1.0 + sw_corr[None, :] * dec, 1.0)
    lw = torch.where(on, 1.0 + lw_corr[None, :] * dec, 1.0)
    return sw.to(dtype), lw.to(dtype)


def cof_schedule(sw_correction, lw_correction, coupling_end, T: int,
                 settings: ModelSettings, dtype=torch.float64):
    """Post-coupling radiation coefficient decay schedule
    (CouplingOperations1, src/Coupling.f90:82-88; forcing.py:333-351): per
    (T, P) tensors of SwRadCof/LwRadCof.  Before/at the window end the
    coefficients are 1 (the in-window values are handled by the coupling
    engine).  The final step repeats the previous step's value (no
    CouplingOperations1 there).  The decay is formed in float64, as the
    JAX package's weakly typed step index is, and cast to ``dtype``."""
    end = torch.as_tensor(coupling_end)
    t_idx = torch.arange(T, device=end.device)[:, None]
    end = end[None, :]
    dts = settings.dt
    decay = torch.exp(-((dts * (t_idx + 1).to(torch.float64))
                        - (dts * end.to(torch.float64)))
                      / settings.coupling_effect_reduction)
    after = (t_idx + 1) > end
    sw = torch.where(after & (end >= 1),
                     1.0 + sw_correction[None, :] * decay, 1.0)
    lw = torch.where(after & (end >= 1),
                     1.0 + lw_correction[None, :] * decay, 1.0)
    if T >= 2:
        sw[-1, :] = sw[-2, :]
        lw[-1, :] = lw[-2, :]
    return sw.to(dtype), lw.to(dtype)
