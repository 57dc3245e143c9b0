"""Production-scale streamed execution: the operational nationwide run, on
one GPU.

The counterpart of the station path of ``roadsurf_tpu/production.py``
(``StationExpander``, ``_Engine``, ``run_production``,
``run_production_coupled``).  The reference's operational path is an async
thread-pool runner over the full data plane
(examples/example2/src/roadrunner.cpp:595-719).  Here:

 * the station-keyed series ([S, T], a few thousand stations) ship to the
   device once; per-point forcing is expanded chunk by chunk ON DEVICE by a
   gather from the nearest-station index, so the full [T, P] forcing tensor
   (hundreds of GB at 1M points) never exists anywhere;
 * with a ``prep_ctx`` the forcing preparation runs once at station rank
   (the fast path) and each chunk is one row gather: into the slim
   [Tc, NCH_SLIM, P] layout of K2 (``slim=True``, the counterpart of the
   JAX package's fused route) or the packed [Tc, NCH, P] layout of K1
   (``slim=False``, its gather route); without it, each chunk runs the
   per-point ``forcing.prepare_window`` + ``pack_forcing`` into K1's layout
   (the generic path);
 * each chunk is one launch of the hand-written CUDA whole-scan kernel
   (``ops/scan_kernel.py``); the prognostic state stays on the device in the
   kernel's packed layout between chunks;
 * the kernel writes only the run-level output-stride rows of each chunk,
   which are drained to the host chunk by chunk;
 * the coupled run streams phases A and C through the kernel and runs the
   coupling window (phase B) with the iteration-major engine of
   ``coupling.py`` in plain torch on the device.

``stream`` is a plain loop on the current CUDA stream that synchronises per
chunk (the drain's device-to-host copy); the JAX engine's two-deep pipelined
dispatch is not ported yet.
"""
from __future__ import annotations

import time as timelib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import MISSING
from .forcing import Calendar, Prepared, RawForcing, cof_window, \
    prepare_window
from .model import Model
from .observability import Progress, RunMetrics
from .ops import scan_kernel as sk
from .state import PointParams, State

OUT_FIELD_ROWS = {"tsurf": sk.R_TSURF, "wat": sk.R_WAT, "snow": sk.R_SNOW,
                  "ice": sk.R_ICE, "ice2": sk.R_ICE2, "dep": sk.R_DEP}

#: point-count multiple (the JAX engine's mesh x lane rule,
#: production.py:90-93, on one device)
LANE = 128


def padded_points(n_points: int) -> int:
    """Points padded to whole 128-point lanes (one device)."""
    return -(-n_points // LANE) * LANE


def _pad_tail(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """Edge-pad ``axis`` to length n."""
    x = np.asarray(x)
    rem = n - x.shape[axis]
    if rem <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, mode="edge")


class StationExpander:
    """On-device station->point forcing expansion (production.py:166-630;
    the TPU's one-hot plan becomes a row gather).

    The data plane's station-keyed series ([S, T]) go to the device once;
    the nearest-station index map (the NearTree radius pattern,
    examples/example2/src/RoadSurfSource.cpp:516-616) selects each point's
    station, ``-1`` for a point with no station in radius.

    ``prep_ctx`` (optional, the fast path): a dict with ``settings``,
    ``params``, ``st_pts`` (PointParams of rank S+1: row S is the virtual
    all-missing station of the out-of-radius points), ``anchors`` (the
    relaxation anchor triple at rank S+1, or None), ``hour`` ([T]) and
    ``t_total``.  Its channels are valid for every point whose prep
    parameters equal its station's (checked by the engine).  Float
    channels are float32, the kernel's only dtype.

    ``slim`` (the counterpart of the JAX package's ``fused=True``): on the
    fast path the engine runs the kernel's slim mode K2 on the 11-channel
    ``slim_window``; ``slim=False`` keeps K1 on the 16-channel
    ``packed_window``.  It has no effect without ``prep_ctx``.
    """

    def __init__(self, raw_st: RawForcing, st_idx, device, chunk_t: int,
                 prep_ctx: Optional[dict] = None, slim: bool = True):
        st_idx = np.asarray(st_idx)
        self.slim = bool(slim)
        self.device = torch.device(device)
        self.num_points = len(st_idx)
        S, T = np.asarray(raw_st.tair).shape
        # one extra chunk of tail padding: a window may overhang T by up to
        # chunk_t - 1 rows (masked off by the kernel's nsteps)
        self.t_pad = (-(-T // chunk_t) + 1) * chunk_t

        def put(x, dt):
            # stations-major [S, T_pad]; NaN raws (an accepted missing
            # marker elsewhere in the data plane) become the sentinel here
            # (production.py:215-229)
            x = np.asarray(_pad_tail(np.asarray(x), self.t_pad, axis=1), dt)
            if x.dtype.kind == "f":
                x = np.where(np.isnan(x), np.asarray(MISSING, dt), x)
            return torch.tensor(x, device=self.device)

        self.channels = RawForcing(
            *(put(getattr(raw_st, n),
                  np.int32 if n == "prec_phase" else np.float32)
              for n in RawForcing._fields))
        ok = st_idx >= 0
        self._raw_host = raw_st            # station-keyed [S, T] (no copy)
        self._ok_host = ok
        self._ie_host = np.where(ok, st_idx, 0)
        # first-step values per point (host), for init_state
        self.first_host = {
            n: np.where(ok, np.asarray(getattr(raw_st, n))[self._ie_host, 0],
                        -9999 if n == "prec_phase" else -9999.9)
            for n in RawForcing._fields}
        self.ok = torch.tensor(ok, device=self.device)
        self.st_idx = torch.tensor(np.where(ok, st_idx, 0).astype(np.int64),
                                   device=self.device)

        self.prep_data = None
        if prep_ctx is not None:
            self._build_prepared(prep_ctx, st_idx, ok)

    def _build_prepared(self, ctx, st_idx, ok):
        """Station-level forcing preparation (production.py:348-416):
        every rule of prepare_window and the pack_forcing thermodynamics is
        a pure function of (series value, global step, per-SERIES params)
        when the relaxation/coupling parameters are station-derived and sky
        view is off, so it runs once at station rank [T_pad, S+1] instead of
        per point per chunk.  The result is the kernel's packed channel
        stack at station rank, [T_pad, NCH, S+1]."""
        settings, params = ctx["settings"], ctx["params"]
        st_pts = ctx["st_pts"]                    # PointParams, rank S+1
        anchors = ctx.get("anchors")              # triple [S+1] or None
        t_total = int(ctx["t_total"])
        dev = self.device
        S = np.asarray(self._raw_host.tair).shape[0]
        hour = torch.tensor(
            _pad_tail(np.asarray(ctx["hour"], np.int32), self.t_pad)
            .astype(np.int64), device=dev)

        # row S: the virtual all-MISSING station of out-of-radius points;
        # gathering its PREPARED values reproduces what the generic path
        # computes from MISSING raws
        def app(x, name):
            miss = -9999 if name == "prec_phase" else MISSING
            return torch.cat([x, torch.full((1, x.shape[1]), miss,
                                            dtype=x.dtype, device=dev)])
        rawT = RawForcing(*(app(getattr(self.channels, n), n).T
                            for n in RawForcing._fields))    # [T_pad, S+1]
        # float32 params and int32 indices, exactly like the engine's
        # per-point placement, so both paths round alike
        ints = {"init_len", "coupling_start", "coupling_end"}
        pts_dev = PointParams(*(
            torch.tensor(np.asarray(getattr(st_pts, n),
                                    np.int32 if n in ints else np.float32),
                         device=dev)
            for n in PointParams._fields))
        anch = (tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                      for a in anchors) if anchors is not None else None)
        prep = prepare_window(rawT, pts_dev, hour, settings, params,
                              t_offset=0, t_total=t_total, anchors=anch,
                              enable_skyview=False)

        # non-finite garbage (MISSING-raw thermodynamics can overflow, e.g.
        # esat(-9999.9) = inf) becomes the missing sentinel: such (station,
        # step) entries are invalid anyway (C_VALID = 0 fails the point)
        def fin(x):
            x = x.to(torch.float32)
            return torch.where(torch.isfinite(x), x,
                               torch.full_like(x, MISSING))
        tair = prep.tair.to(torch.float32)
        eair, airvcap = sk.forcing_thermo(tair, prep.rhz.to(torch.float32))
        stf = torch.zeros((self.t_pad, sk.NCH, S + 1), dtype=torch.float32,
                          device=dev)
        for c, x in ((sk.C_TAIR, prep.tair), (sk.C_VZ, prep.vz),
                     (sk.C_EAIR, eair), (sk.C_AIRVCAP, airvcap),
                     (sk.C_RAIN, prep.rain), (sk.C_SNOW, prep.snow),
                     (sk.C_SW, prep.sw), (sk.C_LW, prep.lw),
                     (sk.C_TSURF_OBS, prep.tsurf_obs),
                     (sk.C_VALID, prep.valid),
                     (sk.C_INCPL, prep.in_coupling)):
            stf[:, c] = fin(x)
        # time-only traffic friction (SetDayDependendVariables)
        trf = prep.trf_fric.to(torch.float32)
        stf[:, sk.C_TRF] = trf[:, None]
        self._prep_st_pts = st_pts         # host, rank S+1 (contract check)
        self.prep_data = {
            "stf": stf, "rhz": fin(prep.rhz), "trf": trf.contiguous(),
            "sidx": torch.tensor(np.where(ok, st_idx, S).astype(np.int64),
                                 device=dev)}

    def window(self, t0: int, tc: int) -> RawForcing:
        """[tc, P] raw forcing for global steps [t0, t0+tc) (the generic
        path)."""
        return self.window_from(self.channels, self.ok, self.st_idx, t0, tc)

    @staticmethod
    def window_from(channels: RawForcing, ok, st_idx, t0: int, tc: int
                    ) -> RawForcing:
        """[tc, P] raw forcing from explicit station channels [S, T_pad],
        the ``ok`` mask and the station index (production.py:609-624)."""
        def expand(ch, name):
            v = ch[:, t0:t0 + tc].index_select(0, st_idx)        # [P, tc]
            miss = torch.full_like(v, -9999 if name == "prec_phase"
                                   else MISSING)
            return torch.where(ok[:, None], v, miss).T          # [tc, P]
        return RawForcing(*(expand(getattr(channels, n), n)
                            for n in RawForcing._fields))

    def packed_window(self, t0: int, tc: int, sw_cof, lw_cof, obs):
        """[tc, NCH, P] kernel-ready packed forcing from the station-level
        PREPARED channels (production.py:582-607): per chunk only the row
        gather and the per-point channels (radiation cofs, coupling obs)
        remain.  ``sw_cof``/``lw_cof``: [tc, P] or scalars."""
        pd = self.prep_data
        out = pd["stf"][t0:t0 + tc].index_select(2, pd["sidx"])
        out[:, sk.C_SWCOF] = sw_cof
        out[:, sk.C_LWCOF] = lw_cof
        out[:, sk.C_CPLOBS] = obs.to(torch.float32)[None, :]
        return out

    def slim_window(self, t0: int, tc: int):
        """[tc, NCH_SLIM, P] slim kernel forcing (K2) from the station-level
        prepared channels: the 11 (station, step)-varying channels, one row
        gather; the kernel reads TRF from ``prep_data["trf"]`` and the
        coupling obs from its aux rows (production.py:537-557, whose
        one-hot expansion this gather replaces)."""
        pd = self.prep_data
        sl = pd["stf"][t0:t0 + tc][:, list(sk.SLIM_CHANNELS)]
        return sl.index_select(2, pd["sidx"])

    def prepared_window(self, t0: int, tc: int) -> Prepared:
        """[tc, P] Prepared rows from the station-level prepared channels,
        for the coupling window (production.py:2044-2067): equal, bit for
        bit, to prepare_window on the expanded raws."""
        pd = self.prep_data
        rows = lambda x: x[t0:t0 + tc].index_select(1, pd["sidx"])
        ch = lambda c: rows(pd["stf"][:, c])
        return Prepared(
            tair=ch(sk.C_TAIR), vz=ch(sk.C_VZ), rhz=rows(pd["rhz"]),
            rain=ch(sk.C_RAIN), snow=ch(sk.C_SNOW), sw=ch(sk.C_SW),
            lw=ch(sk.C_LW), tsurf_obs=ch(sk.C_TSURF_OBS),
            valid=ch(sk.C_VALID) != 0.0,
            in_coupling=ch(sk.C_INCPL) != 0.0,
            trf_fric=pd["trf"][t0:t0 + tc])


class ProductionResult(NamedTuple):
    state: State                 #: final prognostic state (unpadded, host)
    out_steps: np.ndarray        #: [n_out] global 0-based step indices
    fields: dict                 #: name -> [n_out, P] numpy
    point_steps_per_s: float     #: sustained streaming rate (real points)


class _Engine:
    """Device placement + chunk functions + range streaming shared by the
    uncoupled and coupled runs (production.py:1340-1930, the
    single-device parts)."""

    def __init__(self, model: Model, expander: StationExpander,
                 pts: PointParams, cal: Calendar, state: State, *,
                 anchors=None, chunk_t: int = 64,
                 out_stride: Optional[int] = None,
                 metrics: Optional[RunMetrics] = None):
        settings, params, cfg, grid = (model.settings, model.params,
                                       model.cfg, model.grid)
        self.expander = expander
        self.settings, self.params, self.cfg, self.grid = (settings, params,
                                                           cfg, grid)
        self.T = settings.sim_len
        self.device = expander.device
        self.os_ = int(out_stride or settings.output_stride)
        self.metrics = metrics or RunMetrics()
        self.chunk_t = chunk_t

        if cfg.use_depth is False and np.any(np.asarray(pts.out_depth) >= 0.0):
            raise ValueError(
                "per-point out_depth is not supported by the scan kernel; "
                "use Model.run or set the global model.tsurfOutputDepth")
        sky = np.asarray(pts.sky_view)
        if np.any((sky < 1.0) & (sky > -0.01)):
            raise NotImplementedError(
                "sky view in the production engine is not ported yet; "
                "use Model.run")

        self.n_real = int(np.asarray(pts.lat).shape[0])
        self.P_pad = padded_points(self.n_real)
        if expander.num_points != self.P_pad:
            raise ValueError(f"expander built for {expander.num_points} "
                             f"points, need {self.P_pad}")

        with self.metrics.phase("setup"):
            dev = self.device
            f32 = np.float32

            def put_pts(x, dt):
                x = _pad_tail(np.asarray(x), self.P_pad, axis=0)
                return torch.tensor(x.astype(dt), device=dev)

            # horizons stay a 1-wide placeholder: sky view is off here, and
            # a real [P, 360] table is 1.5 GB at 1M points
            self.pts_dev = PointParams(
                lat=put_pts(pts.lat, f32), lon=put_pts(pts.lon, f32),
                sky_view=put_pts(pts.sky_view, f32),
                horizons=torch.zeros((self.P_pad, 1), dtype=torch.float32,
                                     device=dev),
                init_len=put_pts(pts.init_len, np.int32),
                tair_relax=put_pts(pts.tair_relax, f32),
                vz_relax=put_pts(pts.vz_relax, f32),
                rh_relax=put_pts(pts.rh_relax, f32),
                coupling_start=put_pts(pts.coupling_start, np.int32),
                coupling_end=put_pts(pts.coupling_end, np.int32),
                coupling_tsurf=put_pts(pts.coupling_tsurf, f32),
                out_depth=put_pts(pts.out_depth, f32))
            self.obs_dev = self.pts_dev.coupling_tsurf

            self.anchors_dev = None
            if settings.use_relaxation:
                # anchor series values (X_initEnd, src/Relaxation.f90:10-47)
                if anchors is None:
                    raise ValueError(
                        "settings.use_relaxation requires anchors; pass "
                        "anchors=forcing.relax_anchors(...)")
                self.anchors_dev = tuple(
                    put_pts(a, f32) for a in anchors)

            self.hour_dev = torch.tensor(
                _pad_tail(np.asarray(cal.hour, np.int64), expander.t_pad),
                device=dev)

            # packed state; padded points marked failed -> frozen at step 0
            # (production.py:1478-1498)
            def padleaf(x):
                x = torch.as_tensor(x).to(dev)
                n = self.P_pad - x.shape[0]
                if n <= 0:
                    return x
                return torch.cat([x, x[-1:].expand(n, *x.shape[1:])])
            st = State(*(padleaf(x) for x in state))
            self.tmp0, self.scal0 = sk.pack_state(st)
            self.scal0[sk.R_FAILED, self.n_real:] = 1.0
            self.template = state

        # station-level prepared channels bypass per-point forcing prep
        self.fast = expander.prep_data is not None
        self.slim = self.fast and expander.slim
        if self.fast:
            self._check_fast_contract(expander, pts)
            self.metrics.note(
                "station-level prepared channels active ("
                + ("slim kernel mode K2" if self.slim
                   else "packed row gather, kernel mode K1") + ")")
        else:
            self.metrics.note("station expander built without prep_ctx: "
                              "generic per-point forcing prep")
        # fixed output-row allocation: the most stride hits any chunk holds
        self.k_alloc = (chunk_t - 1) // self.os_ + 1
        if self.device.type == "cuda":
            from .ops import build
            with self.metrics.phase("build"):
                build.load()

    def _check_fast_contract(self, expander, pts):
        """The station-level fast path is only valid when every per-point
        prep parameter equals its station's (param i == st_pts[st_idx[i]],
        virtual row S for out-of-radius points); fail loudly otherwise
        (production.py:1611-1664)."""
        st_pts = expander._prep_st_pts
        S = np.asarray(expander._raw_host.tair).shape[0]
        ok = np.asarray(expander._ok_host)[:self.n_real]
        sidx = np.where(ok, np.asarray(expander._ie_host)[:self.n_real], S)
        gat = lambda n: np.asarray(getattr(st_pts, n), np.float64)[sidx]
        got = lambda n: np.asarray(getattr(pts, n), np.float64)

        def fail(name, mask):
            bad = int(np.argmax(mask))
            raise ValueError(
                f"station-level fast path contract violated at point {bad} "
                f"({name}: per-point {got(name)[bad]!r} vs st_pts"
                f"[{sidx[bad]}] {gat(name)[bad]!r}); the prep_ctx expander "
                f"requires param i == st_pts[st_idx[i]] for every "
                f"prep-relevant field (build pts by gathering st_pts, or "
                f"drop prep_ctx to use the generic path)")

        if not np.array_equal(gat("init_len"), got("init_len")):
            fail("init_len", gat("init_len") != got("init_len"))
        # relaxation validity is joint over the three fields; where OFF on
        # both sides the raw sentinels may differ
        def relax_on(t, v, r):
            return ((t >= -100.0) & (t <= 100.0) & (v >= 0.0) & (v <= 100.0)
                    & (r >= 0.0) & (r <= 110.0))
        names = ("tair_relax", "vz_relax", "rh_relax")
        on_w = relax_on(*(gat(n) for n in names))
        on_g = relax_on(*(got(n) for n in names))
        if not np.array_equal(on_w, on_g):
            fail("relax validity", on_w != on_g)
        for n in names:
            bad = on_w & (gat(n).astype(got(n).dtype) != got(n))
            if bad.any():
                fail(n, bad)
        # coupling activity (prepare_window's coupling flags)
        def cpl_on(end, obs):
            return (end >= 1) & (obs > -100.0)
        cw = cpl_on(gat("coupling_end"), gat("coupling_tsurf"))
        cg = cpl_on(got("coupling_end"), got("coupling_tsurf"))
        if not np.array_equal(cw, cg):
            fail("coupling activity", cw != cg)
        for n in ("coupling_start", "coupling_end", "coupling_tsurf"):
            bad = cw & (gat(n).astype(got(n).dtype) != got(n))
            if bad.any():
                fail(n, bad)

    # -- chunk functions ----------------------------------------------------

    def chunk_forcing(self, t0: int, cofs=None):
        """[chunk_t, NCH, P] packed K1 forcing for global steps
        [t0, t0 + chunk_t): the station-level row gather (fast) or the
        per-point prep + pack (generic), production.py:1767-1797.  ``cofs``:
        optional (sw_corr, lw_corr) [P] tensors, the post-window decay."""
        tc = self.chunk_t
        swc = lwc = 1.0
        if cofs is not None:
            swc, lwc = cof_window(cofs[0], cofs[1], self.pts_dev.coupling_end,
                                  t0, tc, self.T, self.settings,
                                  torch.float32)
        if self.fast:
            return self.expander.packed_window(t0, tc, swc, lwc,
                                               self.obs_dev)
        rawT = self.expander.window(t0, tc)
        prep = prepare_window(
            rawT, self.pts_dev, self.hour_dev[t0:t0 + tc], self.settings,
            self.params, t_offset=t0, t_total=self.T,
            anchors=self.anchors_dev, enable_skyview=False)
        if cofs is None:
            swc = lwc = torch.ones(prep.tair.shape, dtype=torch.float32,
                                   device=self.device)
        return sk.pack_forcing(prep, swc, lwc, self.obs_dev)

    def kernel_inputs(self, t0: int, cofs=None):
        """(forcing, slim keyword arguments of ``scan``) for the chunk at
        t0: K2's slim window with the time-only TRF and the aux rows (the
        coupling obs, and with ``cofs`` the corrections and window ends of
        the in-kernel decay, production.py:1755-1766) when the engine runs
        slim, else K1's packed forcing."""
        if not self.slim:
            return self.chunk_forcing(t0, cofs), {}
        kw = dict(slim_trf=self.expander.prep_data["trf"],
                  aux_rows=sk.pack_aux(self.obs_dev))
        if cofs is not None:
            kw.update(aux_rows=sk.pack_aux(self.obs_dev, cofs[0], cofs[1],
                                           self.pts_dev.coupling_end),
                      aux_cofs=True, t_total=self.T,
                      cof_red=self.settings.coupling_effect_reduction)
        return self.expander.slim_window(t0, self.chunk_t), kw

    def run_chunk(self, tmp, scal, t0: int, nsteps: int, cofs=None):
        """One chunk: forcing -> one whole-scan kernel launch; returns
        (tmp, scal, out rows [k_alloc, 6, P])."""
        forc, kw = self.kernel_inputs(t0, cofs)
        tmp2, scal2, out = sk.scan(
            tmp, scal, forc, self.cfg, self.params, self.grid,
            out_stride=self.os_, nsteps=nsteps, out_offset=t0,
            n_out=self.k_alloc, **kw)
        return tmp2, scal2, out[:, :6]

    def _chunk_grid(self, t_lo: int, t_hi: int):
        """[(t0, nsteps)] covering the steps [t_lo, t_hi)."""
        return [(t0, min(self.chunk_t, t_hi - t0))
                for t0 in range(t_lo, t_hi, self.chunk_t)]

    def stream(self, tmp, scal, t_lo: int, t_hi: int, cofs=None,
               progress: Optional[Progress] = None, collected=None):
        """Stream global forcing rows [t_lo, t_hi) through the kernel, chunk
        by chunk, draining each chunk's output rows to the host
        (production.py:1826-1856, without the two-deep pipelining).
        ``cofs``: optional (sw_corr, lw_corr) [P] tensors enabling the
        post-window coefficient decay.  Returns (tmp, scal, collected) with
        collected = [(steps, [k, 6, P] numpy)], appended to ``collected``
        when given."""
        collected = collected if collected is not None else []
        for t0, nsteps_c in self._chunk_grid(t_lo, t_hi):
            # the global-offset output cadence (production.py:1844-1846)
            first_hit = -(-t0 // self.os_) * self.os_
            steps = list(range(first_hit, t0 + nsteps_c, self.os_))
            tmp, scal, rows = self.run_chunk(tmp, scal, t0, nsteps_c, cofs)
            if steps:
                collected.append((steps, rows[:len(steps)].cpu().numpy()))
            elif self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if progress:
                progress.update(nsteps_c)
        return tmp, scal, collected

    def run_uncoupled(self, progress: Optional[Progress] = None):
        """Stream every step [0, T) and assemble the result."""
        with self.metrics.phase("stream"):
            t_start = timelib.perf_counter()
            tmp, scal, collected = self.stream(self.tmp0, self.scal0, 0,
                                              self.T, progress=progress)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = timelib.perf_counter() - t_start
        return self.assemble(collected, tmp, scal, wall)

    def assemble(self, collected, tmp, scal, wall: float) -> ProductionResult:
        with self.metrics.phase("output"):
            rate = self.n_real * self.T / wall
            self.metrics.count("point_steps_per_s", round(rate, 1))
            self.metrics.count("points", self.n_real)
            self.metrics.count("steps", self.T)

            ust = sk.unpack_state(tmp, scal, self.grid.nlayers,
                                  self.template)
            final = State(*(x[:self.n_real].cpu() for x in ust))

            all_steps = np.concatenate(
                [np.asarray(s, np.int64) for s, _ in collected]) \
                if collected else np.zeros(0, np.int64)
            stacked = (np.concatenate([a for _, a in collected], axis=0)
                       if collected else
                       np.zeros((0, 6, self.P_pad), np.float32))
            order = np.argsort(all_steps)
            all_steps = all_steps[order]
            stacked = stacked[order][:, :, :self.n_real]
            fields = {name: stacked[:, r]
                      for name, r in OUT_FIELD_ROWS.items()}
        return ProductionResult(state=final, out_steps=all_steps,
                                fields=fields, point_steps_per_s=rate)


def run_production(model: Model, expander: StationExpander,
                   pts: PointParams, cal: Calendar, state: State, *,
                   anchors=None, chunk_t: int = 64,
                   out_stride: Optional[int] = None,
                   metrics: Optional[RunMetrics] = None,
                   progress: Optional[Progress] = None) -> ProductionResult:
    """Run the full (uncoupled) forecast through the streamed whole-scan
    kernel (production.py:1933-1963).

    pts/state: [P_real] (padded internally to whole 128-point lanes; the
    expander must already be built at the padded count).  anchors: the
    per-point relaxation anchor triple (forcing.relax_anchors), required
    when settings.use_relaxation.  Returns outputs at the global
    ``out_stride`` cadence (default settings.output_stride).  The device is
    the expander's: CUDA runs the kernel, CPU its plain version.
    """
    eng = _Engine(model, expander, pts, cal, state, anchors=anchors,
                  chunk_t=chunk_t, out_stride=out_stride, metrics=metrics)
    return eng.run_uncoupled(progress)


def run_production_coupled(model: Model, expander: StationExpander,
                           pts: PointParams, cal: Calendar, state: State, *,
                           anchors=None, chunk_t: int = 64,
                           out_stride: Optional[int] = None,
                           metrics: Optional[RunMetrics] = None,
                           progress: Optional[Progress] = None,
                           wcache_bytes: float = 4e9) -> ProductionResult:
    """Coupled production run: streamed kernel phases around the
    iteration-major coupling window (production.py:1966-2129).

    Phase split (1-based steps; ws/we_b from the per-point coupling windows):
      A [1, ws-1]    streamed kernel, coefficients 1
      B [ws, we_b]   unpack -> coupling.run_window_passes (first / re-runs /
                     tail) in plain torch on the device -> repack
      C [we_b+1, T]  streamed kernel with the post-window coefficient decay
                     (in kernel on the slim path, cof_window channels on K1)

    With no coupled window the run is the uncoupled stream.
    ``wcache_bytes``: device-memory budget for caching the pass-invariant
    phase-B prepared window forcing (prepared once, read by every pass);
    0 prepares it anew in every pass (the same values either way).
    Counters: coupling_window_steps, coupling_reruns, coupling_window_rows
    (rows stepped over all passes), coupling_window_cached and the coupled /
    succeeded / failed point counts; phases phase_a/phase_b/phase_c.
    """
    from .coupling import run_window_passes, window_out_rows, window_span

    eng = _Engine(model, expander, pts, cal, state, anchors=anchors,
                  chunk_t=chunk_t, out_stride=out_stride, metrics=metrics)
    settings = eng.settings
    T, os_ = eng.T, eng.os_
    coupled_np, span = window_span(settings, pts)
    if span is None:
        return eng.run_uncoupled(progress)

    ws, we_b = span
    W = we_b - ws + 1
    wck = min(chunk_t, W)
    rows_b = window_out_rows(ws, we_b, os_)
    # The window forcing is pass-INVARIANT (only cofs/state change per
    # re-run pass; the reference snapshots its input radiation slices for
    # this reason, src/Coupling.f90:172-255): prepare it once for every
    # pass unless the cache (~38 B/step-point) would exceed the budget
    nv = -(-(W + 1) // wck)
    cache_win = 38.0 * nv * wck * eng.P_pad <= float(wcache_bytes)
    eng.metrics.note(
        "coupling window forcing cached once (pass-invariant)" if cache_win
        else f"coupling window forcing prepared per pass (cache would "
             f"need {38.0 * nv * wck * eng.P_pad / 1e9:.1f} GB)")

    def provider(t0: int) -> Prepared:
        if eng.fast:
            # station-level prepared channels: one row gather per chunk
            return expander.prepared_window(t0, wck)
        rawT = expander.window(t0, wck)
        return prepare_window(rawT, eng.pts_dev, eng.hour_dev[t0:t0 + wck],
                              settings, eng.params, t_offset=t0, t_total=T,
                              anchors=eng.anchors_dev, enable_skyview=False)

    def phase_b(tmp, scal):
        st = sk.unpack_state(tmp, scal, eng.grid.nlayers, eng.template)
        t0s = [ws - 1 + wck * k for k in range(nv)]
        if cache_win:
            cached = [provider(t0) for t0 in t0s]
            valid = [c.valid for c in cached]
            prov = lambda t0: cached[(t0 - (ws - 1)) // wck]
        else:
            valid = [provider(t0).valid for t0 in t0s]
            prov = provider
        valid_win = torch.cat(valid)[:W + 1]
        res = run_window_passes(st, prov, valid_win, ws, we_b, eng.pts_dev,
                                settings, eng.cfg, eng.grid, eng.params,
                                out_stride=os_, wchunk=wck)
        tmp2, scal2 = sk.pack_state(res.state, lpad=tmp.shape[0])
        return (tmp2, scal2, res.cv,
                res.out.permute(0, 2, 1).to(torch.float32), res.reruns,
                res.rows)

    with eng.metrics.phase("stream"):
        t_start = timelib.perf_counter()
        with eng.metrics.phase("phase_a"):
            tmp, scal, col = eng.stream(eng.tmp0, eng.scal0, 0, ws - 1,
                                        progress=progress)
        with eng.metrics.phase("phase_b"):
            tmp, scal, cv, out_b, reruns, rows = phase_b(tmp, scal)
            if len(rows_b):
                col.append((list(rows_b),
                            out_b[:len(rows_b)].cpu().numpy()))
            if progress:
                progress.update(W)
        with eng.metrics.phase("phase_c"):
            tmp, scal, col = eng.stream(tmp, scal, we_b, T,
                                        cofs=(cv.sw_corr, cv.lw_corr),
                                        progress=progress, collected=col)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
        wall = timelib.perf_counter() - t_start
    real = torch.zeros(eng.P_pad, dtype=torch.bool, device=eng.device)
    real[:eng.n_real] = True
    cpl = torch.as_tensor(np.pad(coupled_np, (0, eng.P_pad - eng.n_real)),
                          device=eng.device) & real
    n_failed = int((cpl & cv.failed).sum())
    eng.metrics.count("coupling_window_steps", W)
    eng.metrics.count("coupling_reruns", int(reruns))
    eng.metrics.count("coupling_window_rows", int(rows))
    eng.metrics.count("coupling_window_cached", int(cache_win))
    eng.metrics.count("coupling_points", int(cpl.sum()))
    eng.metrics.count("coupling_failed", n_failed)
    eng.metrics.count("coupling_succeeded", int(cpl.sum()) - n_failed)
    return eng.assemble(col, tmp, scal, wall)
