"""The coupling window (phase B of the coupled run) as one program on the
card: K5's wrapper, its plain torch version, and the window's inputs.

The JAX package compiles phase B as one jit (``roadsurf_tpu/production.py:
2041-2101``), ``coupling.run_window_passes`` as one ``lax.while_loop`` with
one instance of the step graph (``roadsurf_tpu/coupling.py:466-690``); it
has no Pallas kernel for it.  The port's counterpart of that program is K5,
``window_kernel<LM, DEPTH>`` in ``csrc/scan_kernel.cu`` (entry
``roadsurf_window``): one CUDA thread per point runs its own program counter
over the window (the per-point PC engine of ``coupling.run_coupled``), with
the scan kernel's step body, the state in registers and the snapshot in
shared memory.  :func:`window` dispatches on the tensors' device: CPU
tensors take :func:`window_reference`, CUDA tensors launch the kernel (or
raise); nothing falls back, neither to the plain version nor to the eager
``coupling.run_window_passes``, which stays the parity target.  K5 fused
(``window_kernel<LM, DEPTH, true>``, entry ``roadsurf_window_fused``) is
the same program on the routes whose phases A and C run K3 fused: each
step's forcing is prepared in the kernel from the raw series rows, as K3
fused prepares a chunk's, so no table exists.

What one point does is exactly what ``run_window_passes`` does to it:
the first pass (an uncoupled point steps ws..we_b, a coupled one
ws..end_i: the snapshot, the coefficient reset and the coefficient choice
at start_i, snowIceCheck inside its window, Coupling_control at end_i);
a rewind while the control asks and ``end_i + 1 < T`` and the point has
not failed (CheckValues of row end_i on the pre-restore state, the restore
without ice or q2melt/t4melt/evap/blcond, the coefficients from the
choice, a re-run of start_i..end_i whose first step has the coupling flag
off and takes that CheckValues); then the tail end_i+1..we_b with the
decayed coefficients.  Every step at an output row writes its slot; a
later re-run overwrites it; a point that failed before the window writes
none (its rows stay -9999).

Inputs: the packed state after phase A; the window's forcing ``forc``;
per point ``WindowPoints``.  ``forc`` is either a table triple ``(table,
fidx, trf)``: a forcing table ``[W+1, NCH, R]`` in K1's channel layout
(``ops.scan_kernel``) of the global rows ws-1 .. we_b, read at each point's
column ``fidx``, and the rows' traffic friction ``[W+1]``; only the
channels C_TAIR, C_VZ, C_EAIR, C_RAIN, C_SNOW, C_SW, C_LW, C_TSURF_OBS,
C_VALID and C_AIRVCAP are read.  Or a fused window
(``production.FusedWindow``) of the whole block: ``table()`` gives the
triple its plain version reads (the window's eager prep), ``kernel_args()``
K5 fused's raw inputs (``ops.scan_kernel.fuse_args``' fields, each window
chunk's grid rows ``wrows``, the chunk length ``wtc``, ``trf``), ``tc`` the
window chunk's rows and ``tile_geom`` the block's tile layout.  A table
call runs the points [lo, lo + len(fidx)) of the block into ``out`` (made
by :func:`new_out` when None), so a block can be run in point slices, each
exact: points are independent; a fused call runs every point of the block.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelSettings, PhysicsParams
from ..coupling import (CouplingVars, _coupled_mask, _sky_active,
                        coupling_control, window_out_rows)
from ..grid import LayerGrid
from ..physics import storage
from ..step import OUT_MISSING, StepConfig
from . import scan_kernel as sk

#: kernel launches of K5 (on a table) and of K5 fused by
#: :func:`window_cuda` in this process; the plain version does not count
LAUNCHES = 0
LAUNCHES_FUSED = 0

#: the kernel's bound on a point's rewinds (``MAX_RERUNS`` in
#: csrc/scan_kernel.cu), a guard only: the control fails a point at its
#: 25th iteration, so no point rewinds this often; the caller raises on a
#: re-run count past it
MAX_RERUNS = 64

M_FIRST, M_RERUN, M_TAIL, M_DONE = 0, 1, 2, 3

#: the snapshot's scalar rows after its profile rows (saveDataForCoupling,
#: src/Coupling.f90:172-210: Ice2 twice, so not ice)
SNAP_ROWS = (sk.R_TSURF, sk.R_WAT, sk.R_SNOW, sk.R_ICE2, sk.R_DEP,
             sk.R_ALBEDO, sk.R_VERYCOLD)


class WindowSpan(NamedTuple):
    """The global window [ws, we_b] (1-based steps) of a run of ``T``
    steps, its output stride and the coefficient decay's tau
    (settings.coupling_effect_reduction)."""
    ws: int
    we_b: int
    T: int
    out_stride: int
    cof_red: float

    @property
    def rows(self) -> int:
        """The table's rows: global rows ws-1 .. we_b."""
        return self.we_b - self.ws + 2

    @property
    def out_rows(self) -> np.ndarray:
        """The global 0-based output rows the window writes."""
        return window_out_rows(self.ws, self.we_b, self.out_stride)

    @property
    def n_out(self) -> int:
        return max(len(self.out_rows), 1)

    @property
    def first_hit(self) -> int:
        rows = self.out_rows
        return int(rows[0]) if len(rows) else 0


class WindowPoints(NamedTuple):
    """Per-point window inputs [P] on the block's device."""
    cstart: torch.Tensor    #: int32 coupling_start
    cend: torch.Tensor      #: int32 coupling_end
    obs: torch.Tensor       #: float32 coupling obs
    flags: torch.Tensor     #: uint8: 1 coupled, 2 sky view active


class WindowOut(NamedTuple):
    """The window's results for every point of a block."""
    tmp: torch.Tensor        #: [LPAD, P] profile after step we_b
    scal: torch.Tensor       #: [NROWS, P] packed state after step we_b
    rows: torch.Tensor       #: [n_out, 6, P] output rows of the window
    sw_corr: torch.Tensor    #: [P] float32
    lw_corr: torch.Tensor    #: [P] float32
    cv_failed: torch.Tensor  #: [P] bool, Coupling_failed
    reruns: torch.Tensor     #: [P] int32, each point's rewinds
    steps: torch.Tensor      #: [P] int32, the steps each point took


def window_points(pts, settings: ModelSettings) -> WindowPoints:
    """``WindowPoints`` of PointParams ``pts`` (tensors on the device): the
    coupled points and those with sky view active, as
    ``coupling.run_window_passes`` marks them."""
    end = pts.coupling_end.to(torch.int32)
    obs = pts.coupling_tsurf.to(torch.float32)
    coupled = _coupled_mask(settings, end, obs)
    flags = (coupled.to(torch.uint8)
             | (_sky_active(pts).to(torch.uint8) << 1))
    return WindowPoints(cstart=pts.coupling_start.to(torch.int32)
                        .contiguous(), cend=end.contiguous(),
                        obs=obs.contiguous(), flags=flags.contiguous())


def table_rows(prep, out):
    """Write a Prepared's rows ([m, n] leaves, ``trf_fric`` [m]) into the
    table rows ``out`` [m, NCH, n] in K1's channel layout, the channels
    the window reads (forcing_thermo's eair and air heat capacity
    included) and TRF; the coefficient and obs channels are zero, as in
    the station-rank prepared channels."""
    out.zero_()
    for c, x in sk.prep_channels(prep).items():
        out[:, c] = x
    out[:, sk.C_TRF] = prep.trf_fric.to(torch.float32)[:, None]
    return out


def new_out(tmp0, scal0, span: WindowSpan) -> WindowOut:
    """Empty results for the points of ``tmp0`` / ``scal0``: the output rows
    filled with -9999 (a point that takes no step on a row leaves it so),
    the rest written by the calls, which together cover every point."""
    P, dev = tmp0.shape[1], tmp0.device
    empty = lambda dt: torch.empty(P, dtype=dt, device=dev)
    return WindowOut(
        tmp=torch.empty_like(tmp0), scal=torch.empty_like(scal0),
        rows=torch.full((span.n_out, 6, P), OUT_MISSING, dtype=torch.float32,
                        device=dev),
        sw_corr=empty(torch.float32), lw_corr=empty(torch.float32),
        cv_failed=empty(torch.bool), reruns=empty(torch.int32),
        steps=empty(torch.int32))


def is_fused(forc) -> bool:
    """Whether ``forc`` is a fused window (K5 fused's raw inputs), not a
    table triple."""
    return not isinstance(forc, tuple)


def _check_call(tmp0, scal0, forc, pts: WindowPoints, grid: LayerGrid,
                span: WindowSpan, lo: int, out):
    """Check one call's tensors and geometry; returns (P, n)."""
    lpad, P = tmp0.shape
    dev = tmp0.device
    want = {"tmp0": (tmp0, torch.float32, (lpad, P)),
            "scal0": (scal0, torch.float32, (sk.NROWS, P)),
            "cstart": (pts.cstart, torch.int32, (P,)),
            "cend": (pts.cend, torch.int32, (P,)),
            "obs": (pts.obs, torch.float32, (P,)),
            "flags": (pts.flags, torch.uint8, (P,))}
    if is_fused(forc):
        n = P
        nt, tp = forc.tile_geom
        if lo != 0 or nt * tp != P or tp % sk.LANE:
            raise ValueError(f"a fused window runs the whole block of {P} "
                             f"points in whole {sk.LANE}-point tiles, got "
                             f"lo {lo} and tiles {forc.tile_geom}")
    else:
        table, fidx, trf = forc
        n = fidx.shape[0] if fidx.dim() == 1 else -1
        want.update(table=(table, torch.float32,
                           (span.rows, sk.NCH, table.shape[-1])),
                    fidx=(fidx, torch.int32, (n,)),
                    trf=(trf, torch.float32, (span.rows,)))
    if not (1 <= span.ws <= span.we_b <= span.T - 1):
        raise ValueError(f"bad window [{span.ws}, {span.we_b}] for "
                         f"T={span.T}")
    if span.out_stride < 1:
        raise ValueError("out_stride must be >= 1")
    if not 1 <= grid.nlayers <= sk.LMAX or lpad < grid.nlayers + 2:
        raise ValueError(f"nlayers {grid.nlayers} / {lpad} profile rows "
                         f"outside the kernel's range")
    if n < 1 or lo < 0 or lo + n > P:
        raise ValueError(f"points [{lo}, {lo + n}) outside the block of {P}")
    for name, (x, dt, shape) in want.items():
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"window input {name}: {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, contiguous "
                             f"{x.is_contiguous()}; need contiguous {dt} "
                             f"{shape} on {dev}")
    if out is not None and (out.tmp.shape != tmp0.shape
                            or out.rows.shape != (span.n_out, 6, P)):
        raise ValueError("out was made for another block or window")
    return P, n


# ---------------------------------------------------------------------------
# the plain torch version
# ---------------------------------------------------------------------------

def window_reference(tmp0, scal0, forc, pts: WindowPoints,
                     cfg: StepConfig, p: PhysicsParams, grid: LayerGrid,
                     span: WindowSpan, lo: int = 0, out: WindowOut = None,
                     stats: dict = None, stage: int = None) -> WindowOut:
    """K5's and K5 fused's semantics in plain torch ops, on any device: the
    arguments and results of :func:`window`; a fused window runs on the
    table its ``table()`` prepares eagerly.  Vectorised over the points
    with a per-point pass and step index: each trip of the loop settles
    every point's pass transitions, then runs one step
    (``ops.scan_kernel.step_rows``, the scan kernel's body) for every point
    not done, so each point takes exactly the steps its thread takes in the
    kernel.  ``stats`` (optional dict) accumulates the steps taken and their
    boundary-layer iterations as ``scan_reference``'s do; for a fused
    window also K5 fused's prepared rows (``window_preps``: each step's,
    and row end_i's once a point that rewinds), the times a point's
    prepared row enters another window chunk or, on a grid, another stage
    of its segment lines (``window_segments``: the kernel computes the
    stage's lines anew) and the lines so computed a channel
    (``window_lines``: up to ``stage`` an entry), at the stage width
    ``stage`` (``sk.stage_width``'s, or the width a launch took,
    ``sk.LAST_LAUNCH``; needed for these statistics on a grid)."""
    P, n = _check_call(tmp0, scal0, forc, pts, grid, span, lo, out)
    fused = is_fused(forc)
    if (fused and stats is not None and forc.kernel_args().get("has_grid")
            and stage is None):
        raise ValueError("the segment-line statistics of a fused grid "
                         "window need the stage width")
    table, fidx, trf = forc.table() if fused else forc
    if out is None:
        out = new_out(tmp0, scal0, span)
    dev, f32 = tmp0.device, torch.float32
    ws, we_b, T, os_ = span.ws, span.we_b, span.T, span.out_stride
    W1, first_hit = span.rows, span.first_hit
    lpad = tmp0.shape[0]
    nsnap = min(grid.nlayers + 3, lpad)
    layers = sk.grid_layers(grid)
    dt = cfg.dt
    sl = slice(lo, lo + n)
    w = torch.where

    tmp = [tmp0[k, sl].clone() for k in range(lpad)]
    sc = [scal0[r, sl].clone() for r in range(sk.NROWS)]
    si, ei = pts.cstart[sl].long(), pts.cend[sl].long()
    obs = pts.obs[sl]
    cpl = (pts.flags[sl] & 1) != 0
    sky = (pts.flags[sl] & 2) != 0
    col = fidx.long()
    pidx = torch.arange(lo, lo + n, device=dev)
    tau = torch.full((), span.cof_red, dtype=f32, device=dev)

    cv = CouplingVars.init(n, f32, obs)
    snap_tmp = [torch.zeros_like(tmp[0]) for _ in range(nsnap)]
    snap_sc = {r: torch.zeros_like(tmp[0]) for r in SNAP_ROWS}
    zeros_b = torch.zeros(n, dtype=torch.bool, device=dev)
    choice, vf = zeros_b, zeros_b
    mode = torch.full((n,), M_FIRST, dtype=torch.int64, device=dev)
    i = torch.full((n,), ws, dtype=torch.int64, device=dev)
    hi = w(cpl, torch.clamp(ei, max=we_b), torch.full_like(ei, we_b))
    nre = torch.zeros(n, dtype=torch.int32, device=dev)
    nst = torch.zeros(n, dtype=torch.int32, device=dev)
    abnormal = lambda t: (t < -100.0) | (t > 100.0)
    wc = torch.full((n,), -1, dtype=torch.int64, device=dev)
    wst = torch.zeros((n,), dtype=torch.int64, device=dev)

    def prepared(mask, row):
        """K5 fused prepares table row ``row`` at the points of ``mask``,
        on the segment lines of its window chunk's stage."""
        nonlocal wc, wst
        if not (fused and stats is not None):
            return
        k = row // forc.tc
        ka = forc.kernel_args()
        span = int(ka.get("span", 0)) if ka.get("has_grid") else 0
        s0 = torch.zeros_like(k)
        if span:
            st = (ka["pos"].to(dev)[ws - 1 + row].long()
                  - ka["wrows"].to(dev)[k, 0].long()).clamp(0, span - 1)
            s0 = st // stage * stage
        enter = mask & ((k != wc) | (s0 != wst))
        lines = torch.clamp(span - s0, max=stage or 1)
        for key, v in (("window_preps", mask.sum()),
                       ("window_segments", enter.sum()),
                       ("window_lines", torch.where(enter, lines, 0).sum())):
            stats[key] = stats.get(key, 0) + v      # on the device
        wc = torch.where(mask, k, wc)
        wst = torch.where(mask, s0, wst)

    while True:
        # the pass transitions of every point past the end of its pass
        while True:
            failed = sc[sk.R_FAILED] > 0.5
            need = (mode != M_DONE) & ((i > hi) | failed)
            if not bool(need.any()):
                break
            done = need & (failed | (mode == M_TAIL))
            rw = need & ~done & cv.again & cpl & (ei + 1 < T)
            tail = need & ~done & ~rw
            vrow = torch.clamp(ei - (ws - 1), 0, W1 - 1)
            prepared(rw & (nre == 0), vrow)
            vf = w(rw, ~(table[vrow, sk.C_VALID, col] < 0.5)
                   & ~abnormal(sc[sk.R_TSURF]), vf)
            for k in range(nsnap):
                tmp[k] = w(rw, snap_tmp[k], tmp[k])
            for r, v in snap_sc.items():
                sc[r] = w(rw, v, sc[r])
            cv = cv._replace(
                again=cv.again & ~rw,
                sw_cof=w(rw, w(choice, cv.radcoeff, 1.0), cv.sw_cof),
                lw_cof=w(rw, w(choice, 1.0, cv.radcoeff), cv.lw_cof))
            nre = nre + rw.to(torch.int32)
            mode = w(rw, M_RERUN, w(tail, M_TAIL, w(done, M_DONE, mode)))
            i = w(rw, torch.clamp(si, min=ws),
                  w(tail, torch.clamp(ei + 1, min=ws), i))
            hi = w(rw, ei, w(tail, w(cpl, we_b, -1), hi))
        act = mode != M_DONE
        if not bool(act.any()):
            break

        # one step at each point's (pass, i): table row i - ws
        row = torch.clamp(i - ws, 0, W1 - 1)
        prepared(act, row)
        first = act & (mode == M_FIRST)
        rerun = act & (mode == M_RERUN)
        in_tail = act & (mode == M_TAIL)
        ch = lambda c: table[row, c, col]
        at_start = first & cpl & (i == si)
        do_save = at_start & (cv.iterations == 0)
        snap_tmp = [w(do_save, t, s) for t, s in zip(tmp, snap_tmp)]
        snap_sc = {r: w(do_save, sc[r], v) for r, v in snap_sc.items()}
        cv = cv._replace(sw_cof=w(do_save, 1.0, cv.sw_cof),
                         lw_cof=w(do_save, 1.0, cv.lw_cof),
                         sw_corr=w(do_save, 0.0, cv.sw_corr),
                         lw_corr=w(do_save, 0.0, cv.lw_corr))
        choice = w(at_start, (ch(sk.C_SW) > ch(sk.C_LW)) & ~sky, choice)
        incpl = ((first & cpl & (i >= si) & (i <= ei))
                 | (rerun & (i > si) & (i <= ei)))
        valid = w(rerun & (i == si), vf.to(f32), ch(sk.C_VALID))
        checked = storage.snow_ice_check(storage.Storages(
            sc[sk.R_WAT], sc[sk.R_SNOW], sc[sk.R_ICE], sc[sk.R_ICE2],
            sc[sk.R_DEP]), obs, p)
        for r, v in zip((sk.R_WAT, sk.R_SNOW, sk.R_ICE, sk.R_ICE2, sk.R_DEP),
                        checked):
            sc[r] = w(incpl, v, sc[r])
        # the post-window decay, divided by a tensor tau (IEEE division)
        expo = -(dt * i.to(f32) - dt * ei.to(f32)) / tau
        dec = torch.exp(torch.clamp(expo, max=0.0))
        swc = w(in_tail, 1.0 + cv.sw_corr * dec, cv.sw_cof)
        lwc = w(in_tail, 1.0 + cv.lw_corr * dec, cv.lw_cof)
        chan = {sk.C_VALID: valid, sk.C_INCPL: incpl.to(f32)}
        sk.step_rows(tmp, sc, lambda c: chan[c] if c in chan else ch(c),
                     (swc, lwc), trf[row], obs, cfg, p, layers, act=act,
                     stats=stats)

        # SaveOutput, overwritten by a later re-run of the row
        r0 = i - 1
        on = act & (r0 % os_ == 0)
        slot = torch.clamp((r0 - first_hit) // os_, 0, span.n_out - 1)
        for k, r in enumerate((sk.R_TSURF, sk.R_WAT, sk.R_SNOW, sk.R_ICE,
                               sk.R_ICE2, sk.R_DEP)):
            out.rows[slot[on], k, pidx[on]] = sc[r][on]
        # CheckEndCoupling, never in the tail
        do_ctl = (act & (mode != M_TAIL) & cpl & (i == ei) & ~cv.failed
                  & ~(sc[sk.R_FAILED] > 0.5))
        cv = coupling_control(sc[sk.R_TSURF], obs, cv, do_ctl)
        i = i + act.to(torch.int64)
        nst = nst + act.to(torch.int32)

    out.tmp[:, sl] = torch.stack(tmp)
    out.scal[:, sl] = torch.stack(sc)
    out.sw_corr[sl] = cv.sw_corr
    out.lw_corr[sl] = cv.lw_corr
    out.cv_failed[sl] = cv.failed
    out.reruns[sl] = nre
    out.steps[sl] = nst
    sk.stats_to_host(stats)
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_WIN_PTRS = ("tmp0", "scal0", "table", "fidx", "trf", "cstart", "cend",
             "obs", "flags", "tmp_out", "scal_out", "rows", "sw_corr",
             "lw_corr", "cv_failed", "reruns", "steps", "wrows")
_WIN_INTS = ("P", "p0", "n", "R", "W1", "ws", "we_b", "T", "out_stride",
             "first_hit", "n_out", "tp", "wtc")


class WinArgs(ctypes.Structure):
    """Mirror of ``struct WinArgs`` in csrc/scan_kernel.cu."""
    _fields_ = ([(n, _VP) for n in _WIN_PTRS]
                + [(n, ctypes.c_int) for n in _WIN_INTS]
                + [("cof_red", ctypes.c_float)])


def window_cuda(tmp0, scal0, forc, pts: WindowPoints, cfg: StepConfig,
                p: PhysicsParams, grid: LayerGrid, span: WindowSpan,
                lo: int = 0, out: WindowOut = None) -> WindowOut:
    """Launch K5 (``roadsurf_window``) on a table, or K5 fused
    (``roadsurf_window_fused``) on a fused window at ``sk.stage_width``'s
    stage width (any power of two gives the same bits), on CUDA tensors:
    the arguments and results of
    :func:`window_reference`.  A table's ``fidx`` must index its columns.
    Runs on the current stream, does not synchronise, and raises if the
    launch is refused."""
    global LAUNCHES, LAUNCHES_FUSED
    from . import build

    if tmp0.device.type != "cuda":
        raise ValueError(f"the window kernel needs CUDA tensors, got "
                         f"{tmp0.device}")
    P, n = _check_call(tmp0, scal0, forc, pts, grid, span, lo, out)
    fused = is_fused(forc)
    if out is None:
        out = new_out(tmp0, scal0, span)
    lpad = tmp0.shape[0]
    consts = sk.make_consts(cfg, p, grid, lpad, span.out_stride, span.n_out)
    ptrs = dict(tmp0=tmp0, scal0=scal0, cstart=pts.cstart, cend=pts.cend,
                obs=pts.obs, flags=pts.flags, tmp_out=out.tmp,
                scal_out=out.scal, rows=out.rows, sw_corr=out.sw_corr,
                lw_corr=out.lw_corr, cv_failed=out.cv_failed,
                reruns=out.reruns, steps=out.steps)
    if fused:
        fa = sk.fuse_args(forc, tmp0.device)
        ka = forc.kernel_args()
        for name, dt in (("wrows", torch.int32), ("trf", torch.float32)):
            x = ka[name]
            if (x.device != tmp0.device or x.dtype != dt
                    or not x.is_contiguous()):
                raise ValueError(f"fused window input {name}: {x.dtype} on "
                                 f"{x.device}; need contiguous {dt} on "
                                 f"{tmp0.device}")
        if (tuple(ka["trf"].shape) != (span.rows,)
                or tuple(ka["wrows"].shape)
                != (-(-span.rows // ka["wtc"]), 2)):
            raise ValueError("fused window: trf or wrows do not cover the "
                             "window's rows")
        ptrs.update(wrows=ka["wrows"], trf=ka["trf"])
        geo = dict(R=0, tp=forc.tile_geom[1], wtc=int(ka["wtc"]))
    else:
        table, fidx, trf = forc
        ptrs.update(table=table, fidx=fidx, trf=trf)
        geo = dict(R=table.shape[2])
    args = WinArgs(**{k: v.data_ptr() for k, v in ptrs.items()},
                   P=P, p0=lo, n=n, W1=span.rows, ws=span.ws,
                   we_b=span.we_b, T=span.T, out_stride=span.out_stride,
                   first_hit=span.first_hit, n_out=span.n_out,
                   cof_red=span.cof_red, **geo)
    lib = build.load()
    if fused:
        sk.fused_launch(lib, fa, "K5 fused", consts, tmp0.device)
    stream = torch.cuda.current_stream(tmp0.device).cuda_stream
    with torch.cuda.device(tmp0.device):
        if fused:
            rc = lib.roadsurf_window_fused(
                ctypes.addressof(consts), ctypes.addressof(fa),
                ctypes.addressof(args), stream)
        else:
            rc = lib.roadsurf_window(ctypes.addressof(consts),
                                     ctypes.addressof(args), stream)
    if rc != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {rc} "
                           f"({build.error_string(rc)})")
    if fused:
        LAUNCHES_FUSED += 1
    else:
        LAUNCHES += 1
    return out


def window(tmp0, scal0, forc, pts: WindowPoints, cfg: StepConfig,
           p: PhysicsParams, grid: LayerGrid, span: WindowSpan, lo: int = 0,
           out: WindowOut = None) -> WindowOut:
    """Phase B of the coupled run on one block's points (a table's [lo, lo
    + len(fidx)), a fused window's every point): CPU tensors run
    :func:`window_reference`, CUDA tensors the kernel (``roadsurf_window``
    on a table, ``roadsurf_window_fused`` on a fused window)."""
    args = (tmp0, scal0, forc, pts, cfg, p, grid, span, lo, out)
    if tmp0.device.type == "cpu":
        return window_reference(*args)
    if tmp0.device.type == "cuda":
        return window_cuda(*args)
    raise ValueError(f"no window kernel for device {tmp0.device}")
