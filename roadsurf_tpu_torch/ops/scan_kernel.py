"""The whole-forecast scan: CUDA kernel wrapper, its plain torch version, and
the packed state/forcing layouts.

The counterpart of ``roadsurf_tpu/ops/pallas_step.py`` (``pallas_scan`` in
its point-major, slim and tile-major modes, ``_make_kernel``, and the
packing helpers at pallas_step.py:736-821).  The kernel itself is
``csrc/scan_kernel.cu``: one CUDA thread per road point runs every step of
the chunk with the profile and the scalar state in registers.  ``scan``
dispatches on the tensors' device: CPU tensors take :func:`scan_reference`,
CUDA tensors launch the kernel (or raise); nothing falls back.

Four modes of the one kernel:

 * K1, point-major: forcing ``[T, NCH, P]`` with all 16 channels;
 * K2, slim (``aux_rows`` given): forcing ``[T, NCH_SLIM, P]`` with only the
   11 (station, step)-varying channels, the traffic friction read from a
   time-only vector ``slim_trf [T_pad]`` at the global step, and the
   coupling obs and the radiation-coefficient decay inputs from per-point
   ``aux_rows [4, P]``; the coefficients are exactly 1, or with
   ``aux_cofs`` decayed in kernel (``forcing.cof_window`` semantics);
 * K3, tile-major: the forcing of K1 or K2 as ``[P / TP, T, NCH or
   NCH_SLIM, TP]`` (point ``p`` is lane ``p % TP`` of tile ``p // TP``, TP a
   multiple of ``LANE``), so each tile's steps are one contiguous slab
   (pallas_step.py:387-398, :619-629); state, aux rows and outputs stay
   point-major;
 * K3 fused (:func:`scan_fused`): K3 slim with no forcing tensor at all.
   Each thread prepares its step's 11 channels in registers from the
   chunk's raw inputs, a ``FusedChunk`` of ``production``: the grid part's
   series rows in the tile layout with the gap-capped interpolation's
   segment lines, the station part's series and index, the source-order
   merge, and every rule of ``forcing.prepare_window`` (sky view and
   relaxation included) and :func:`forcing_thermo`.  Its plain version
   composes what the unfused route runs: the chunk's eager prep,
   :func:`pack_forcing_slim_tm` and :func:`scan_reference`.

K4, the sharded launch (``scan_cuda_sharded``; the counterpart of
``roadsurf_tpu/parallel/sharding.py:pallas_scan_sharded``), has no
arithmetic of its own: one host call launches the kernel above once for each
contiguous block of points, block ``b`` on its device and its stream.  It is
bound by what its blocks are: the bytes of K1-K3 over the memory rate of the
card a block lies on.  ``parallel/sharding.py`` holds its wrapper
``scan_sharded`` and its plain version.

Layouts (unchanged from the JAX package, so both sides compare like with
like): the profile is ``tmp [LPAD, P]`` (row 0 air, rows 1..L ground, row
L+1 climatology, padded rows carried through); the per-point scalar state is
row-packed into ``scal [NROWS, P]`` (rows ``R_*``); forcing is point-minor
``[T, NCH, P]`` (channels ``C_*``), so one step's read of a channel is
coalesced across a warp; output rows are ``[n_out, N_OUT_FIELDS, P]``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import PhysicsParams
from ..grid import LayerGrid
from ..step import StepConfig

# ---- row indices into the packed scalar state [NROWS, P] (pallas_step.py:54-57)
R_TSURF, R_WAT, R_SNOW, R_ICE, R_ICE2, R_DEP = 0, 1, 2, 3, 4, 5
R_Q2MELT, R_T4MELT, R_EVAP, R_BLCOND, R_ALBEDO = 6, 7, 8, 9, 10
R_VERYCOLD, R_FAILED = 11, 12          # 0.0 / 1.0 flags
NROWS = 16

# ---- forcing channel indices (axis 1 of [T, NCH, P]; pallas_step.py:59-67)
# C_EAIR and C_AIRVCAP are pure functions of the raw forcing (tair, rhz),
# precomputed once in pack_forcing: one exp and one divide fewer per step.
C_TAIR, C_VZ, C_EAIR, C_RAIN, C_SNOW, C_SW, C_LW = 0, 1, 2, 3, 4, 5, 6
C_TSURF_OBS, C_VALID, C_TRF, C_SWCOF, C_LWCOF, C_INCPL, C_CPLOBS = \
    7, 8, 9, 10, 11, 12, 13
C_AIRVCAP = 14
NCH = 16

# SLIM forcing layout (pallas_step.py:69-78): only the channels that vary
# per (station, step); TRF is time-only, SWCOF/LWCOF are 1 outside coupling
# (computed in kernel from aux rows when coupled), CPLOBS is an aux row.
SLIM_CHANNELS = (C_TAIR, C_VZ, C_EAIR, C_RAIN, C_SNOW, C_SW, C_LW,
                 C_TSURF_OBS, C_VALID, C_INCPL, C_AIRVCAP)
NCH_SLIM = len(SLIM_CHANNELS)
SLIM_POS = {c: i for i, c in enumerate(SLIM_CHANNELS)}
# aux rows of the slim mode: sw_corr, lw_corr, coupling_end, coupling obs
A_SWCORR, A_LWCORR, A_CEND, A_CPLOBS = 0, 1, 2, 3
N_AUX = 4

N_OUT_FIELDS = 8  # tsurf, wat, snow, ice, ice2, dep, (2 zero pad)

#: largest ``ModelSettings.nlayers`` the kernel holds in registers
#: (the template buckets of csrc/scan_kernel.cu)
LMAX = 32

#: the kernel's thread block, and the multiple of a tile width (a warp's
#: points then lie in one tile)
LANE = 128

#: kernel launches by :func:`scan_cuda` in this process, K1 (point-major),
#: K2 (slim) and K3 (tile-major, either channel set); the plain version does
#: not count
LAUNCHES = 0
LAUNCHES_SLIM = 0
LAUNCHES_TM = 0
#: kernel launches of K3 fused (:func:`scan_cuda_fused` and the fused
#: sharded launch), one for each block
LAUNCHES_TM_FUSED = 0
#: sharded launches by :func:`scan_cuda_sharded` (K4): one for each host call,
#: whatever its number of blocks; each of its blocks also counts in its
#: mode's counter above
LAUNCHES_SHARDED = 0


class ScanConsts(ctypes.Structure):
    """Mirror of ``struct ScanConsts`` in csrc/scan_kernel.cu: StepConfig,
    the derived PhysicsParams and the grid arrays, passed to the kernel by
    value.  Products of parameters are formed in float64 on the host and
    rounded once, as the JAX kernel's weakly typed python constants are."""
    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "L", "lpad", "out_stride", "n_out", "bl_iters", "use_depth",
            "depth_idx", "force_snow", "force_ice", "melt_change")]
        + [(n, ctypes.c_float) for n in (
            "dt", "tph", "depth_w",
            "vk", "log_ustar", "log_cond", "log_mom", "log_heat", "stab_c",
            "lvap", "lfus", "emiss", "emiss_sb", "dry1", "dry2",
            "t_lim_cold_h", "t_lim_cold_l", "max_por_mms", "por_eva_f",
            "w_wear_lim", "w_wet_lim", "damp_wear_f", "min_wat_mms",
            "max_wat_mms", "t_lim_dew", "wet_snow_form_r",
            "t_lim_melt_snow", "melt_heat", "wet_snow_melt_r",
            "t_lim_freeze", "min_snow_mms", "max_snow_mms", "half_max_snow",
            "t_lim_melt_ice", "min_ice_mms", "max_ice_mms", "t_lim_melt_dep",
            "min_dep_mms", "max_dep_mms", "alb_dry", "alb_snow",
            "alb_span")]
        + [(n, ctypes.c_float * LMAX) for n in ("dyc", "cond_dz", "wcont")])


#: RawForcing's fields in order (forcing.RawForcing), the order of
#: FuseArgs' pointer arrays
RAW_FIELDS = ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw", "sw_dir",
              "lw_net", "tsurf_obs", "prec_phase")
_VP = ctypes.c_void_p
_FUSE_PTRS = (("trw", "trel", "pos", "pick", "tex", "havep"),
              ("sidx", "sok", "lat", "lon", "sky", "hor", "init_len",
               "cstart", "cend", "tr_relax", "vz_relax", "rh_relax",
               "ctsurf", "anc_t", "anc_v", "anc_r", "hour", "sun"))
_FUSE_INTS = ("has_grid", "has_station", "grid_last", "K", "KW", "span",
              "k0", "lo", "complete", "s_tpad", "hor_w", "t_total", "relax",
              "coupling", "force_tsurf", "sky_on", "flat_hor", "sun_stride")
_FUSE_FLOATS = ("max_gap", "calm_ngt", "calm_day", "night_on", "night_off",
                "min_prec", "p_snow", "p_rain", "miss_i", "alb_sur", "dt_f")
_FUSE_DOUBLES = ("dt", "p_snow_d", "p_rain_d")


class FuseArgs(ctypes.Structure):
    """Mirror of ``struct FuseArgs`` in csrc/scan_kernel.cu: one block's
    raw inputs of one chunk of K3 fused (pointers, then ints, floats and
    doubles; a null pointer is an absent channel)."""
    _fields_ = ([("g", _VP * len(RAW_FIELDS))]
                + [(n, _VP) for n in _FUSE_PTRS[0]]
                + [("s", _VP * len(RAW_FIELDS))]
                + [(n, _VP) for n in _FUSE_PTRS[1]]
                + [(n, ctypes.c_int) for n in _FUSE_INTS]
                + [(n, ctypes.c_float) for n in _FUSE_FLOATS]
                + [("stage", ctypes.c_int)]
                + [(n, ctypes.c_double) for n in _FUSE_DOUBLES])


#: the dtype each FuseArgs pointer field must have
_FUSE_DTYPES = dict(
    trw=torch.float32, trel=torch.float32, pos=torch.int32,
    pick=torch.int32, tex=torch.bool, havep=torch.bool, sidx=torch.int64,
    sok=torch.bool, lat=torch.float32, lon=torch.float32,
    sky=torch.float32, hor=torch.float32, init_len=torch.int32,
    cstart=torch.int32, cend=torch.int32, tr_relax=torch.float32,
    vz_relax=torch.float32, rh_relax=torch.float32, ctsurf=torch.float32,
    anc_t=torch.float32, anc_v=torch.float32, anc_r=torch.float32,
    hour=torch.int32, sun=torch.float32)


def fuse_args(src, device) -> FuseArgs:
    """The FuseArgs of a ``FusedChunk`` (``src.kernel_args()``: tensors
    for the pointer fields, None for a null one, numbers for the rest),
    each tensor checked for its device, dtype and contiguity.  The caller
    keeps ``src`` alive until the launch is issued."""
    a = src.kernel_args()
    fa = FuseArgs()

    def ptr(name, x, dtype):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor) or x.device != device:
            raise ValueError(f"fused input {name} must be a tensor on "
                             f"{device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"fused input {name}: {x.dtype}, contiguous "
                             f"{x.is_contiguous()}; need contiguous {dtype}")
        return x.data_ptr()
    for key in ("g", "s"):
        for i, n in enumerate(RAW_FIELDS):
            dt = (torch.int32 if key == "s" and n == "prec_phase"
                  else torch.float32)
            getattr(fa, key)[i] = ptr(f"{key}.{n}", a[key].get(n), dt)
    for n in _FUSE_PTRS[0] + _FUSE_PTRS[1]:
        setattr(fa, n, ptr(n, a.get(n), _FUSE_DTYPES[n]))
    for n in _FUSE_INTS:
        setattr(fa, n, int(a.get(n, 0)))
    for n in _FUSE_FLOATS + _FUSE_DOUBLES:
        setattr(fa, n, float(a.get(n, 0.0)))
    if fa.has_grid and fa.span < 1:
        raise ValueError(f"the grid's SPAN {fa.span} is not positive")
    return fa


# ---- the stage width of the segment lines (K3 fused, K5 fused) ----------

#: bytes of shared memory one segment line of one channel takes in a block
#: (an alpha and a beta float for each of the block's LANE threads)
SEG_LINE_BYTES = 2 * 4 * LANE


class SmBudget(NamedTuple):
    """What bounds a fused instantiation's blocks an SM on a card, from
    ``roadsurf_fused_info`` (``cudaFuncGetAttributes``, the occupancy call
    and the device's attributes; bytes)."""
    blocks: int        #: blocks an SM with no dynamic shared memory
    static_smem: int   #: the instantiation's static shared memory a block
    sm_smem: int       #: shared memory an SM
    block_smem: int    #: the most shared memory a block may opt in to
    reserved: int      #: shared memory reserved for each block


def seg_bytes(n_ch: int, span: int, stage: int) -> int:
    """The dynamic shared memory of a fused launch of a grid with ``n_ch``
    continuous channels at ``span`` segments a window and stage width
    ``stage`` (csrc/scan_kernel.cu:seg_bytes)."""
    return n_ch * min(span, stage) * SEG_LINE_BYTES if n_ch else 0


def stage_width(n_ch: int, span: int, budget: SmBudget) -> int:
    """The stage width of a fused launch: the widest power of two whose
    full stage of segment lines (``seg_bytes`` of ``n_ch`` channels at that
    many segments) still lets the SM hold ``budget.blocks`` blocks, the
    number the instantiation's registers allow, and fits one block; no
    wider than the first power of two >= ``span`` (past it the layout is
    the same: one stage holds the whole window).  At least 1: a grid whose
    single lines do not fit is refused at launch.  A grid with SPAN <=
    the width keeps one stage, so the hourly grid runs as it did; the
    width never grows with the channels nor shrinks with the SPAN."""
    def fits(w):
        blk = budget.static_smem + seg_bytes(n_ch, w, w)
        return (blk <= budget.block_smem and budget.blocks
                * (blk + budget.reserved) <= budget.sm_smem)
    w = 1
    while w < span and fits(2 * w):
        w *= 2
    return w


#: the grid channel sets a fused kernel is instantiated for, by the index
#: the launch reports (csrc/scan_kernel.cu: CS_ANY, CS_NWP)
CHANNEL_SETS = ("any, tested each step", "the NWP grid's, compiled in")


class FusedLaunch(NamedTuple):
    """One fused launch's stage width and occupancy (``fused_launch``)."""
    stage: int         #: segment lines a stage holds a channel
    smem: int          #: dynamic shared memory a block (bytes)
    regs: int          #: registers a thread
    static_smem: int   #: static shared memory a block (bytes)
    blocks_regs: int   #: blocks an SM its registers allow
    blocks: int        #: blocks an SM at smem (the occupancy call)
    channel_set: int   #: the instantiation's channel set (CHANNEL_SETS)


#: the last fused launch of each kind ("K3 fused", "K5 fused"): its
#: ``FusedLaunch``
LAST_LAUNCH = {}
_INFO = {}


def _fused_info(lib, fa, window: bool, nlayers: int, use_depth: bool,
                dyn_smem: int, device) -> list:
    """``roadsurf_fused_info`` of ``lib`` on ``device`` for a launch of the
    FuseArgs ``fa`` (cached by its grid's channels)."""
    key = (id(lib), device.index, window, nlayers <= 16, bool(use_depth),
           bool(fa.has_grid), tuple(bool(g) for g in fa.g), dyn_smem)
    if key not in _INFO:
        info = (ctypes.c_int * 8)()
        with torch.cuda.device(device):
            rc = lib.roadsurf_fused_info(ctypes.addressof(fa), int(window),
                                         int(nlayers), int(bool(use_depth)),
                                         int(dyn_smem), info)
        if rc != 0:
            raise RuntimeError(
                f"fused occupancy query failed: CUDA error {rc} at "
                f"{dyn_smem} B of segment lines a block (the most a block "
                f"may hold: {info[5]} B)")
        _INFO[key] = list(info)
    return _INFO[key]


def grid_channels(fa) -> int:
    """The continuous channels a FuseArgs' grid part carries (the segment
    lines' channels: prec_phase has none)."""
    return sum(1 for i, n in enumerate(RAW_FIELDS)
               if n != "prec_phase" and fa.g[i]) if fa.has_grid else 0


def fused_launch(lib, fa, kind: str, consts, device) -> FusedLaunch:
    """Set ``fa.stage`` for a launch of ``kind`` ("K3 fused" or "K5 fused")
    with the ScanConsts ``consts`` (its layers and output depth, with
    ``fa``'s grid channels, pick the instantiation) on ``device``:
    ``stage_width`` of the instantiation's
    budget on the card (a measurement replaces ``stage_width`` to force a
    width, a power of two); returns (and records in LAST_LAUNCH) the
    launch's width and occupancy."""
    window = kind == "K5 fused"
    n_ch, span = grid_channels(fa), max(int(fa.span), 1)
    inst = (lib, fa, window, consts.L, consts.use_depth)
    info = _fused_info(*inst, 0, device)
    budget = SmBudget(info[2], info[1], info[4], info[5], info[6])
    stage = stage_width(n_ch, span, budget)
    if stage < 1 or stage & (stage - 1):
        raise ValueError(f"stage width {stage} is not a power of two")
    fa.stage = stage
    smem = seg_bytes(n_ch, span, stage)
    blocks = _fused_info(*inst, smem, device)[3]
    launch = FusedLaunch(stage, smem, info[0], info[1], info[2], blocks,
                         info[7])
    LAST_LAUNCH[kind] = launch
    return launch


def make_consts(cfg: StepConfig, p: PhysicsParams, grid: LayerGrid,
                lpad: int, out_stride: int, n_out: int) -> ScanConsts:
    L = grid.nlayers
    c = ScanConsts(
        L=L, lpad=lpad, out_stride=out_stride, n_out=n_out,
        bl_iters=int(cfg.bl_max_iter), use_depth=int(bool(cfg.use_depth)),
        depth_idx=int(cfg.depth_idx),
        force_snow=int(bool(cfg.force_snow_melting)),
        force_ice=int(bool(cfg.force_ice_melting)),
        melt_change=int(bool(cfg.melting_can_change_temperature)),
        dt=cfg.dt, tph=cfg.tph, depth_w=cfg.depth_w,
        vk=p.vk_const, log_ustar=p.log_ustar, log_cond=p.log_cond,
        log_mom=p.log_mom, log_heat=p.log_heat,
        stab_c=-p.vk_const * p.zref_t * p.grav,
        lvap=p.lvap, lfus=p.lfus, emiss=p.emiss,
        emiss_sb=p.emiss * p.sb_const,
        dry1=(1.0 - p.poro1) * p.vsh1, dry2=(1.0 - p.poro2) * p.vsh2,
        t_lim_cold_h=p.t_lim_cold_h, t_lim_cold_l=p.t_lim_cold_l,
        max_por_mms=p.max_por_mms, por_eva_f=p.por_eva_f,
        w_wear_lim=p.w_wear_lim, w_wet_lim=p.w_wet_lim,
        damp_wear_f=p.damp_wear_f, min_wat_mms=p.min_wat_mms,
        max_wat_mms=p.max_wat_mms, t_lim_dew=p.t_lim_dew,
        wet_snow_form_r=p.wet_snow_form_r,
        t_lim_melt_snow=p.t_lim_melt_snow,
        melt_heat=p.wat_m_heat * p.wat_dens,
        wet_snow_melt_r=p.wet_snow_melt_r, t_lim_freeze=p.t_lim_freeze,
        min_snow_mms=p.min_snow_mms, max_snow_mms=p.max_snow_mms,
        half_max_snow=p.max_snow_mms / 2.0,
        t_lim_melt_ice=p.t_lim_melt_ice, min_ice_mms=p.min_ice_mms,
        max_ice_mms=p.max_ice_mms, t_lim_melt_dep=p.t_lim_melt_dep,
        min_dep_mms=p.min_dep_mms, max_dep_mms=p.max_dep_mms,
        alb_dry=p.alb_dry, alb_snow=p.alb_snow,
        alb_span=p.alb_snow - p.alb_dry)
    for name in ("dyc", "cond_dz", "wcont"):
        arr = getattr(c, name)
        for j, v in enumerate(np.asarray(getattr(grid, name), np.float32)):
            arr[j] = float(v)
    return c


def _out_geometry(nsteps: int, out_stride: int, out_offset, n_out):
    """(global offset, rows allocated, first global output row index):
    pallas_step.py:639-645 and :380-382."""
    if out_offset is None:
        if n_out is not None:
            raise ValueError("n_out is only given with out_offset")
        off, n_rows = 0, -(-nsteps // out_stride)
    else:
        if n_out is None:
            raise ValueError("out_offset requires an explicit n_out")
        off, n_rows = int(out_offset), max(int(n_out), 1)
    if off < 0:
        raise ValueError(f"out_offset must be >= 0, got {off}")
    return off, n_rows, -(-off // out_stride)


# ---------------------------------------------------------------------------
# the plain torch version (the kernel's own formulation, pallas_step.py:95-576)
# ---------------------------------------------------------------------------

def _sel(cond, a: float, b: float, like):
    return torch.where(cond, torch.full_like(like, a),
                       torch.full_like(like, b))


def _esat(t):
    # Magnus over ice/water with the coefficients selected per point, one
    # exp (pallas_step.py:95-101; BoundaryLayer.f90:156-170)
    a = _sel(t < 0.0, 21.875, 17.269, t)
    b = _sel(t < 0.0, 265.5, 237.3, t)
    return 0.61078 * torch.exp(a * t / (t + b))


def _bl_fixed_point(blcond, tsurf, tair, vz, air_vcap, p: PhysicsParams,
                    n_iter: int):
    """Masked-freeze boundary-layer iteration with the carried 1/ustar
    (pallas_step.py:104-172; BoundaryLayer.f90:60-101).  Also returns each
    point's iteration count: the iterations the kernel's thread runs before
    it leaves the loop."""
    tak = tair + 273.15
    dt_ts = tsurf - tair
    inv_kvz = 1.0 / (p.vk_const * vz)
    inv_avt = 1.0 / (air_vcap * tak)
    stab_c = -p.vk_const * p.zref_t * p.grav
    bl = blcond
    psim = torch.zeros_like(blcond)
    psih = torch.zeros_like(blcond)
    done = torch.zeros_like(blcond, dtype=torch.bool)
    iters = torch.full_like(blcond, float(n_iter))
    for j in range(n_iter):
        ustar_inv = (p.log_ustar + psim) * inv_kvz
        bl_new = air_vcap * p.vk_const / ((p.log_cond + psih) * ustar_inv)
        stab = (stab_c * bl_new * dt_ts * inv_avt
                * ustar_inv * ustar_inv * ustar_inv)
        stab = torch.clamp(stab, max=1.0)
        psih_s = 4.7 * stab
        psih_u = -2.0 * torch.log(
            (1.0 + torch.sqrt(torch.clamp(1.0 - 16.0 * stab, min=0.0))) / 2.0)
        stable = stab > 0.0
        psih_n = torch.where(stable, psih_s, psih_u)
        psim_n = torch.where(stable, psih_n, 0.6 * psih_n)
        newly = (torch.abs(bl_new - bl) < 1e-3) & (j + 1 >= 5)
        bl = torch.where(done, bl, bl_new)
        psim = torch.where(done, psim, psim_n)
        psih = torch.where(done, psih, psih_n)
        iters = torch.where(newly & ~done, float(j + 1), iters)
        done = done | newly
        # frozen points stop changing, so leaving once all are done gives
        # the fixed n_iter loop's result (pallas_step.py:144-150)
        if (j + 1) % 5 == 0 and bool(done.all()):
            break
    return bl, psim, psih, inv_kvz, iters


def stats_to_host(stats):
    """``stats`` (the counts a plain version accumulates on the device, one
    read a count instead of one a step) as Python ints, in place."""
    if stats is not None:
        stats.update({k: int(v) for k, v in stats.items()})


def _warp_iters(lane_iters):
    """The iterations the kernel's warps issue for ``lane_iters`` [P] (one
    step's count per point): 32 times the largest of each 32 consecutive
    points, summed (a ragged last warp padded with idle lanes)."""
    pad = -lane_iters.shape[0] % 32
    w = torch.nn.functional.pad(lane_iters, (0, pad)).reshape(-1, 32)
    return 32 * w.amax(dim=1).sum()


def _surf_ave(tmp, cfg: StepConfig):
    if cfg.use_depth:
        i = cfg.depth_idx
        return tmp[i] + cfg.depth_w * (tmp[i + 1] - tmp[i])
    return (tmp[1] + tmp[2]) / 2.0


def _stencil(tmp, bl, rnet, le, trf, dt, p, dyc, cond_dz, wcont, nlayers):
    """CalcHCapHCond + calcProfile + calcHStor over the layers
    (pallas_step.py:175-208; BalanceModel.f90:90-129, :189-251, :311-322);
    tmp: list of [P] rows."""
    sens = bl * (tmp[0] - tmp[1])
    g_prev = rnet - le + trf + sens
    hs1 = None
    new = list(tmp)
    for j in range(1, nlayers + 1):
        t = tmp[j]
        t2_ = t * t
        roo = torch.where(t < 0.0, 920.0,
                          -0.0050 * t2_ + 0.0079 * t + 1000.0028)
        cw = torch.where(t < 0.0, 2100.0,
                         0.0000102 * t2_ * t2_ - 0.0017169 * t2_ * t
                         + 0.11516 * t2_ - 3.4739 * t + 4217.2)
        chwt = roo * cw
        if j <= 2:
            vsh = (1.0 - p.poro1) * p.vsh1 + wcont[j - 1] * chwt
        else:
            vsh = (1.0 - p.poro2) * p.vsh2 + wcont[j - 1] * chwt
        if j == 1:
            hs1 = vsh * dyc[0] / dt
        cap_dz = -1.0 / (dyc[j - 1] * vsh)
        gflux = cond_dz[j - 1] * (tmp[j + 1] - tmp[j])
        new[j] = tmp[j] + dt * cap_dz * (gflux - g_prev)
        g_prev = gflux
    t1a = (tmp[1] + 3.0 * tmp[2]) / 4.0
    tna = (new[1] + 3.0 * new[2]) / 4.0
    hstor = hs1 * (tna - t1a)
    return new, hs1, hstor


def _melting(tmp_new, tsurf, snow, ice, ice2, q2, t4, hstor, hs1,
             in_cpl, last_obs, cfg, p):
    """Storage.f90:319-402 on row layout (pallas_step.py:218-241)."""
    zero = torch.zeros_like(q2)
    has_frozen = (snow > 0.0) | (ice > 0.0) | (ice2 > 0.0)
    q2_out = torch.where(has_frozen, q2, zero)
    if not cfg.melting_can_change_temperature:
        return tmp_new, q2_out
    guard = ((hstor <= 0.00001) | (tsurf <= t4) | (q2 <= 0.0)
             | (in_cpl & (last_obs < t4)))
    cold = guard & (tsurf < 0.5)
    hot = guard & (tsurf > 2.0)
    qavail = hs1 * (tmp_new[1] - t4)
    pin = has_frozen & (~cold) & (~hot)
    all_used = q2 >= qavail
    t1p = torch.where(all_used, t4 + 0.01, t4 + (qavail - q2) / hs1)
    t2p = t4 + 0.01
    tmp_out = list(tmp_new)
    tmp_out[1] = torch.where(pin, t1p, tmp_new[1])
    tmp_out[2] = torch.where(pin, t2p, tmp_new[2])
    q2_out = torch.where(has_frozen & cold, zero, q2_out)
    q2_out = torch.where(has_frozen & hot, torch.minimum(q2_out, qavail),
                         q2_out)
    q2_out = torch.where(pin & all_used, qavail, q2_out)
    return tmp_out, q2_out


def _road_cond(wat, snow, ice, ice2, dep, tsurf, evap, q2, t4, vcold,
               cfg: StepConfig, p: PhysicsParams):
    """WearFactors + RoadCond + CalcAlbedo (pallas_step.py:244-350;
    src/Cond.f90, src/Storage.f90)."""
    tph, dt = cfg.tph, cfg.dt
    zero = torch.zeros_like(wat)
    vcold = vcold & ~(vcold & (tsurf > p.t_lim_cold_h))
    vcold = vcold | ((~vcold) & (tsurf < p.t_lim_cold_l))

    snow_tran = torch.clamp(0.45 * snow, min=0.01)
    snow_tran = torch.where(snow < 0.2, snow_tran * 3.0, snow_tran) * tph
    ice_wear = torch.clamp(1.1 * 2.0 * 0.145 * ice, min=0.01) * tph
    ice_wear2 = torch.clamp(1.1 * 2.0 * 4.0 * 0.290 * ice2, min=0.01) * tph
    dep_wear = torch.clamp(0.5 * 2.0 * 4.0 * 0.290 * dep, min=0.01) * tph
    wat_wear = 10.0 * torch.clamp(0.145 * wat, min=0.06) * tph
    s2i = 0.25 / 0.45

    bare = (snow <= 0.0) & (ice <= 0.0) & (dep <= 0.0) & (tsurf > p.t_lim_dew)
    loss = torch.where(wat > p.max_por_mms, evap, p.por_eva_f * evap)
    wat = torch.where(bare, wat - loss, wat)
    wearing = wat > 0.0
    ww = torch.where(wat < p.w_wear_lim, zero, wat_wear)
    amt = torch.where(wat > p.w_wet_lim, ww, p.damp_wear_f * ww)
    wat = torch.where(wearing, wat - amt, wat)
    wat = torch.where(wat < p.min_wat_mms, zero, wat)
    wat = torch.clamp(wat, max=p.max_wat_mms)
    srf_ext = torch.clamp(wat - p.max_por_mms, min=0.0)

    rd = srf_ext + snow
    wsr = torch.where(rd > 0.001, srf_ext / rd, zero)
    snow_wet = (snow > 0.0) & (wsr > p.wet_snow_form_r)
    under = snow > 0.0
    ice = torch.where(under, ice + dep, ice)
    dep = torch.where(under, zero, dep)
    has_snow = snow > 0.0
    melt_f = has_snow & bool(cfg.force_snow_melting)
    melts = has_snow & (~melt_f) & (q2 > 0.0) & (tsurf >= p.t_lim_melt_snow)
    mm = 1000.0 * (q2 * dt) / (p.wat_m_heat * p.wat_dens)
    wat = torch.where(melt_f, wat + snow, torch.where(melts, wat + mm, wat))
    snow = torch.where(melt_f, zero, torch.where(melts, snow - mm, snow))
    wearing = snow > 0.0
    snow = torch.where(wearing, snow - snow_tran, snow)
    ice = torch.where(wearing, ice + s2i * snow_tran, ice)
    ice2 = torch.where(wearing, ice2 + s2i * snow_tran, ice2)
    wet_block = (snow > 0.0) & snow_wet
    melting_wet = wet_block & (wsr > p.wet_snow_melt_r)
    wat = torch.where(melting_wet, wat + snow, wat)
    snow = torch.where(melting_wet, zero, snow)
    freezing = wet_block & (tsurf < p.t_lim_freeze)
    amt2 = snow + wat
    ice = torch.where(freezing, ice + amt2, ice)
    ice2 = torch.where(freezing, ice2 + amt2, ice2)
    snow = torch.where(freezing, zero, snow)
    wat = torch.where(freezing, zero, wat)
    snow = torch.where(snow < p.min_snow_mms, zero, snow)
    snow = torch.where(snow > p.max_snow_mms, snow - p.max_snow_mms / 2.0,
                       snow)

    freezing = (tsurf < p.t_lim_freeze) & (wat > 0.0)
    ice = torch.where(freezing, ice + wat, ice)
    ice2 = torch.where(freezing, ice2 + wat, ice2)
    wat = torch.where(freezing, zero, wat)
    meltable = (snow <= 0.0) & (ice > 0.0)
    melt_f = meltable & bool(cfg.force_ice_melting)
    melts = meltable & (~melt_f) & (q2 > 0.0) & (tsurf >= p.t_lim_melt_ice)
    wat = torch.where(melt_f, wat + ice, torch.where(melts, wat + mm, wat))
    ice_n = torch.where(melt_f, zero, torch.where(melts, ice - mm, ice))
    ice2 = torch.where(melt_f, zero, torch.where(melts, ice2 - mm, ice2))
    ice = ice_n
    ice = torch.where(ice > 0.0, ice - ice_wear, ice)
    ice2 = torch.where(ice2 > 0.0, ice2 - ice_wear2, ice2)
    ice = torch.where(ice < p.min_ice_mms, zero, ice)
    ice = torch.clamp(ice, max=p.max_ice_mms)
    ice2 = torch.where(ice2 < p.min_ice_mms, zero, ice2)
    ice2 = torch.clamp(ice2, max=p.max_ice_mms)

    dep = torch.where(evap < 0.0, dep - evap, dep)
    melting = tsurf > p.t_lim_melt_dep
    wat = torch.where(melting, wat + dep, wat)
    dep = torch.where(melting, zero, dep)
    wearing = (snow <= 0.0) & (dep > 0.0)
    dep = torch.where(wearing, dep - dep_wear, dep)
    dep = torch.where(dep < p.min_dep_mms, zero, dep)
    over = dep > p.max_dep_mms
    wat = torch.where(over, wat + dep - p.max_dep_mms, wat)
    dep = torch.clamp(dep, max=p.max_dep_mms)

    wat = torch.where(wat < p.min_wat_mms, zero, wat)
    wat = torch.clamp(wat, max=p.max_wat_mms)

    snowy = snow > 0.0
    q2n = torch.where(snowy,
                      p.wat_m_heat * p.wat_dens * (snow / 1000.0) / dt, zero)
    t4n = torch.where(snowy, torch.full_like(t4, p.t_lim_melt_snow), t4)
    icy = (~snowy) & (ice > 0.0)
    q2n = torch.where(icy, p.wat_m_heat * p.wat_dens * (ice / 1000.0) / dt,
                      q2n)
    t4n = torch.where(icy, torch.full_like(t4, p.t_lim_melt_ice), t4n)
    q2n = torch.clamp(q2n, min=0.0)

    ice_sum = torch.clamp(0.5 * (ice + ice2) + dep, min=0.0)
    snowy_a = (snow > 0.01) & (snow > ice)
    icy_a = (ice > 0.01) | (dep > 0.01)
    icy_alb = torch.where(
        ice_sum < 1.5, p.alb_dry + (ice_sum / 1.5) * (p.alb_snow - p.alb_dry),
        torch.full_like(ice_sum, p.alb_snow))
    albedo = torch.full_like(wat, p.alb_dry)
    albedo = torch.where(snowy_a, torch.full_like(wat, p.alb_snow),
                         torch.where(icy_a & ~snowy_a, icy_alb, albedo))
    return wat, snow, ice, ice2, dep, vcold, q2n, t4n, albedo


def is_fused(forcing) -> bool:
    """Whether ``forcing`` is a chunk of raw inputs for K3 fused (a
    ``production.FusedChunk``), not a forcing tensor."""
    return not isinstance(forcing, torch.Tensor)


def _forcing_layout(forcing, P: int, slim: bool):
    """(T, tile width) of a point-major ``[T, nch, P]`` forcing (tile width
    P), a tile-major ``[P / TP, T, nch, TP]`` one, or a fused chunk of
    ``tc`` steps on ``tile_geom``; raises on any other."""
    if is_fused(forcing):
        nt, tp = forcing.tile_geom
        if not slim or nt * tp != P or tp % LANE:
            raise ValueError(f"a fused chunk needs the slim arguments and "
                             f"whole {LANE}-point tiles of the {P} points, "
                             f"got {forcing.tile_geom}")
        return forcing.tc, tp
    nch = NCH_SLIM if slim else NCH
    shape = tuple(forcing.shape)
    if forcing.dim() == 3 and shape[1:] == (nch, P):
        return shape[0], P
    if (forcing.dim() == 4 and shape[2] == nch and shape[3] % LANE == 0
            and shape[0] * shape[3] == P):
        return shape[1], shape[3]
    raise ValueError(f"forcing shape {shape}, expected [T, {nch}, {P}] or "
                     f"[{P} / TP, T, {nch}, TP] with TP a multiple of "
                     f"{LANE}")


def _slim_args(P, slim_trf, aux_rows, aux_cofs, t_total, cof_red, off,
               nsteps):
    """Check the slim-mode arguments; returns whether the call is slim."""
    slim = aux_rows is not None
    if not slim:
        if slim_trf is not None or aux_cofs:
            raise ValueError("slim_trf / aux_cofs need aux_rows")
        return False
    if slim_trf is None:
        raise ValueError("the slim mode needs slim_trf")
    if tuple(aux_rows.shape) != (N_AUX, P):
        raise ValueError(f"aux_rows shape {tuple(aux_rows.shape)}, expected "
                         f"({N_AUX}, {P})")
    if slim_trf.dim() != 1 or slim_trf.shape[0] < off + nsteps:
        raise ValueError(f"slim_trf must be [T_pad >= {off + nsteps}], got "
                         f"{tuple(slim_trf.shape)}")
    if aux_cofs and (t_total is None or cof_red is None):
        raise ValueError("aux_cofs needs t_total and cof_red")
    return True


def _decayed_cofs(aux, tg: int, t_total: int, dt: float, cof_red: float):
    """The post-coupling coefficient pair at global step ``tg``
    (pallas_step.py:475-493, forcing.cof_window semantics): each product,
    the difference and the quotient round on their own in float32."""
    i_eff = tg if (t_total >= 2 and tg == t_total - 1) else tg + 1
    i_eff_f = torch.tensor(float(i_eff), dtype=torch.float32,
                           device=aux.device)
    cend = aux[A_CEND]
    red = torch.tensor(cof_red, dtype=torch.float32, device=aux.device)
    expo = -(dt * i_eff_f - dt * cend) / red
    dec = torch.exp(torch.clamp(expo, max=0.0))
    on = (i_eff_f >= cend) & (cend >= 1.0)
    return (torch.where(on, 1.0 + aux[A_SWCORR] * dec, 1.0),
            torch.where(on, 1.0 + aux[A_LWCORR] * dec, 1.0))


def grid_layers(grid: LayerGrid):
    """``step_rows``' ``layers`` of ``grid``: (dyc, cond_dz, wcont) as
    float32-rounded Python floats, and the layer count."""
    f32 = lambda a: tuple(float(v) for v in np.asarray(a, np.float32))
    return f32(grid.dyc), f32(grid.cond_dz), f32(grid.wcont), grid.nlayers


def step_rows(tmp, sc, ch, cofs, trf, cplobs, cfg: StepConfig,
              p: PhysicsParams, layers, act=None, stats: dict = None):
    """One step of the kernel's body (``step_body`` of csrc/scan_kernel.cu;
    pallas_step.py:411-568) on the profile rows ``tmp`` (LPAD [P] rows) and
    the packed state rows ``sc`` (NROWS [P] rows), updated in place where
    the point has not failed before the step (and, with ``act``, where
    ``act`` holds).  ``ch(c)`` is forcing channel ``c`` (K1's channel
    indices; C_VALID and C_INCPL are read as floats against 0.5), ``cofs``
    the radiation coefficients (sw, lw), ``trf`` the traffic friction,
    ``cplobs`` the coupling obs; ``layers`` is (dyc, cond_dz, wcont,
    nlayers) as float32-rounded Python floats.  Returns the failed mask
    before the step."""
    dyc, cond_dz, wcont, nlayers = layers
    dt = cfg.dt
    tair = ch(C_TAIR)
    failed_prev = sc[R_FAILED] > 0.5
    tsurf = sc[R_TSURF]
    abnormal = (tsurf < -100.0) | (tsurf > 100.0)
    failed = failed_prev | (ch(C_VALID) < 0.5) | abnormal
    active = ~failed_prev if act is None else act & ~failed_prev

    # SetCurrentValues + obs forcing
    obs = ch(C_TSURF_OBS)
    force_obs = obs > -100.0
    cur = list(tmp)
    cur[0] = tair
    cur[1] = torch.where(force_obs, obs, tmp[1])
    cur[2] = torch.where(force_obs, obs, tmp[2])
    tsurf = torch.where(force_obs, _surf_ave(cur, cfg), tsurf)

    # precipitation to storage
    wat = sc[R_WAT] + ch(C_RAIN)
    snow = sc[R_SNOW] + ch(C_SNOW)
    ice, ice2, dep = sc[R_ICE], sc[R_ICE2], sc[R_DEP]

    # boundary layer + latent heat
    vz = ch(C_VZ)
    air_vcap = ch(C_AIRVCAP)
    bl, psim, psih, inv_kvz, iters = _bl_fixed_point(
        sc[R_BLCOND], tsurf, tair, vz, air_vcap, p, cfg.bl_max_iter)
    if stats is not None:
        lane = torch.where(active, iters, 0.0).to(torch.int64)
        for key, n in (("point_steps", active.sum()),
                       ("bl_iters", lane.sum()),
                       ("bl_warp_iters", _warp_iters(lane))):
            stats[key] = stats.get(key, 0) + n      # on the device

    raero = torch.clamp((p.log_mom + psim) * (p.log_heat + psih)
                        * (inv_kvz / p.vk_const), max=30.0)
    tak = tair + 273.15
    psych_c = 0.1 * (0.00063 * tak + 0.47496)
    wat_den = -0.0050 * tsurf * tsurf + 0.0079 * tsurf + 1000.0028
    esurf = _esat(tsurf)
    le = air_vcap * (esurf - ch(C_EAIR)) / (psych_c * raero)
    lheat = _sel(tsurf >= 0.0, p.lvap, p.lfus, tsurf)
    evap = le / (lheat * wat_den) * 1000.0 * dt
    dry = (le > 0.0) & (wat <= 0.0)
    le = torch.where(dry, torch.zeros_like(le), le)
    evap = torch.where(dry, torch.zeros_like(evap), evap)

    # net radiation
    sw_cof, lw_cof = cofs
    tk = tsurf + 273.15
    tk2 = tk * tk
    rnet = ((1.0 - sc[R_ALBEDO]) * ch(C_SW) * sw_cof
            + p.emiss * ch(C_LW) * lw_cof
            - p.emiss * p.sb_const * tk2 * tk2)

    # stencil + melting limiter
    new_tmp, hs1, hstor = _stencil(cur, bl, rnet, le, trf, dt, p,
                                   dyc, cond_dz, wcont, nlayers)
    new_tmp, q2 = _melting(new_tmp, tsurf, snow, ice, ice2,
                           sc[R_Q2MELT], sc[R_T4MELT], hstor, hs1,
                           ch(C_INCPL) > 0.5, cplobs, cfg, p)
    tsurf_new = _surf_ave(new_tmp, cfg)

    # storages
    (wat, snow, ice, ice2, dep, vcold, q2, t4, albedo) = _road_cond(
        wat, snow, ice, ice2, dep, tsurf_new, evap, q2, sc[R_T4MELT],
        sc[R_VERYCOLD] > 0.5, cfg, p)

    # commit (mask by active)
    sel = lambda n, o: torch.where(active, n, o)
    tmp[:] = [sel(n, o) for n, o in zip(new_tmp, tmp)]
    new_rows = {
        R_TSURF: tsurf_new, R_WAT: wat, R_SNOW: snow, R_ICE: ice,
        R_ICE2: ice2, R_DEP: dep, R_Q2MELT: q2, R_T4MELT: t4,
        R_EVAP: evap, R_BLCOND: bl, R_ALBEDO: albedo,
        R_VERYCOLD: vcold.to(torch.float32)}
    for r, v in new_rows.items():
        sc[r] = sel(v, sc[r])
    new_failed = torch.maximum(failed.to(torch.float32), sc[R_FAILED])
    sc[R_FAILED] = (new_failed if act is None
                    else torch.where(act, new_failed, sc[R_FAILED]))
    return failed_prev


def scan_reference(tmp0, scal0, forcing, cfg: StepConfig, p: PhysicsParams,
                   grid: LayerGrid, out_stride: int = 1, nsteps: int = None,
                   out_offset=None, n_out: int = None, slim_trf=None,
                   aux_rows=None, aux_cofs: bool = False, t_total: int = None,
                   cof_red: float = None, stats: dict = None):
    """The kernel's semantics in plain torch ops, on any device: the same
    signature, layouts and results as :func:`scan_cuda`.

    tmp0: [LPAD, P] f32 profile; scal0: [NROWS, P] f32 packed state;
    forcing: [T, NCH, P] f32 (K1), or [T, NCH_SLIM, P] with ``aux_rows``
    (K2, the slim mode), or either channel set tile-major,
    [P / TP, T, nch, TP] (K3), read through a view of the tile layout: one
    step's channel row at a time, never a transposed copy of the whole
    forcing.  Steps ``t < nsteps`` run (default T); an
    output row is written where ``(out_offset + t) % out_stride == 0``, at
    row ``(out_offset + t) // out_stride - ceil(out_offset / out_stride)``
    of ``n_out`` rows (``n_out`` is required with ``out_offset``; without
    it, ``ceil(nsteps / out_stride)`` rows from step 0).  Fields 6 and 7
    are zero; a point that failed before the step outputs -9999.  The
    boundary-layer fixed point runs at most ``cfg.bl_max_iter`` iterations.

    Slim mode (pallas_step.py:599-605): ``slim_trf`` [T_pad] f32 traffic
    friction indexed by the global step; ``aux_rows`` [4, P] f32 (sw_corr,
    lw_corr, coupling_end, coupling obs).  The radiation coefficients are 1;
    with ``aux_cofs`` they decay after each point's window end
    (forcing.cof_window semantics, including the lastValues reuse at
    ``t_total - 1``; ``cof_red`` is settings.coupling_effect_reduction).

    ``stats`` (optional dict): accumulates ``point_steps``, the steps run
    by points not yet failed, ``bl_iters``, the boundary-layer iterations
    those steps take (the work the kernel does on these inputs), and
    ``bl_warp_iters``, the iterations a warp issues for them: for each
    group of 32 consecutive points (one warp of the kernel) 32 times its
    largest count, summed over steps, since a warp runs the loop until its
    slowest lane is done (a failed point counts 0).

    Returns (tmp [LPAD, P], scal [NROWS, P], out [n_out, N_OUT_FIELDS, P]).
    """
    lpad, P = tmp0.shape
    slim = aux_rows is not None
    T, _ = _forcing_layout(forcing, P, slim)
    nsteps = T if nsteps is None else int(nsteps)
    if not 0 < nsteps <= T:
        raise ValueError(f"nsteps {nsteps} outside (0, {T}]")
    off, n_rows, out_base = _out_geometry(nsteps, out_stride, out_offset,
                                          n_out)
    _slim_args(P, slim_trf, aux_rows, aux_cofs, t_total, cof_red, off,
               nsteps)
    # [n_tiles, T, nch, TP] view: one tile of width P for the point-major
    # layout, so both layouts run the one loop below
    f4 = forcing if forcing.dim() == 4 else forcing.unsqueeze(0)
    layers = grid_layers(grid)
    dt = cfg.dt

    tmp = [tmp0[j].clone() for j in range(lpad)]
    sc = [scal0[r].clone() for r in range(NROWS)]
    out = torch.zeros((n_rows, N_OUT_FIELDS, P), dtype=torch.float32,
                      device=tmp0.device)
    for t in range(nsteps):
        f = f4[:, t]                                 # [n_tiles, nch, TP]
        ch = ((lambda c: f[:, SLIM_POS[c]].reshape(P)) if slim
              else (lambda c: f[:, c].reshape(P)))
        tg = off + t
        # net radiation's coefficients: K1's channels; the slim mode's are
        # 1 (multiplying by the exact 1.0 reproduces K1's ones channels bit
        # for bit), or the in-kernel post-coupling decay
        if not slim:
            cofs = (ch(C_SWCOF), ch(C_LWCOF))
        elif aux_cofs:
            cofs = _decayed_cofs(aux_rows, tg, t_total, dt, cof_red)
        else:
            cofs = (1.0, 1.0)
        trf = slim_trf[tg] if slim else ch(C_TRF)
        cplobs = aux_rows[A_CPLOBS] if slim else ch(C_CPLOBS)
        failed_prev = step_rows(tmp, sc, ch, cofs, trf, cplobs, cfg, p,
                                layers, stats=stats)

        # output at the GLOBAL stride; the step failing CheckValues still
        # emits, later steps are poisoned (step.py semantics)
        if tg % out_stride == 0:
            row = tg // out_stride - out_base
            if row < n_rows:
                for k, r in enumerate((R_TSURF, R_WAT, R_SNOW, R_ICE,
                                       R_ICE2, R_DEP)):
                    out[row, k] = torch.where(
                        failed_prev, torch.full_like(sc[r], -9999.0), sc[r])
    stats_to_host(stats)
    return torch.stack(tmp), torch.stack(sc), out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _check(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _checked_launch(tmp0, scal0, forcing, cfg, grid, out_stride, nsteps,
                    out_offset, n_out, slim_trf, aux_rows, aux_cofs, t_total,
                    cof_red):
    """Check one launch's tensors and arguments (a whole run's, or one
    block's of a sharded one); returns (lpad, P, T, tile width, nsteps,
    offset, output rows, first output row index, slim)."""
    if tmp0.device.type != "cuda":
        raise ValueError(f"the scan kernel needs CUDA tensors, got "
                         f"{tmp0.device}")
    lpad, P = tmp0.shape
    slim = aux_rows is not None
    T, tp = _forcing_layout(forcing, P, slim)
    nlayers = grid.nlayers
    if not 1 <= nlayers <= LMAX:
        raise ValueError(f"nlayers {nlayers} outside the kernel's 1..{LMAX}")
    if lpad < nlayers + 2:
        raise ValueError(f"tmp0 has {lpad} rows, need >= {nlayers + 2}")
    if P <= 0:
        raise ValueError("no points")
    nsteps = T if nsteps is None else int(nsteps)
    if not 0 < nsteps <= T:
        raise ValueError(f"nsteps {nsteps} outside (0, {T}]")
    if out_stride < 1 or cfg.bl_max_iter < 0:
        raise ValueError("out_stride must be >= 1 and bl_max_iter >= 0")
    off, n_rows, out_base = _out_geometry(nsteps, out_stride, out_offset,
                                          n_out)
    if off + nsteps >= 2 ** 31:
        raise ValueError("global step index overflows int32")
    _slim_args(P, slim_trf, aux_rows, aux_cofs, t_total, cof_red, off,
               nsteps)
    _check("tmp0", tmp0, (lpad, P), tmp0.device)
    _check("scal0", scal0, (NROWS, P), tmp0.device)
    if not is_fused(forcing):
        _check("forcing", forcing, tuple(forcing.shape), tmp0.device)
    if slim:
        _check("slim_trf", slim_trf, tuple(slim_trf.shape), tmp0.device)
        _check("aux_rows", aux_rows, (N_AUX, P), tmp0.device)
    return lpad, P, T, tp, nsteps, off, n_rows, out_base, slim


def _count_launches(forcing, slim: bool, n: int = 1):
    """Add ``n`` launches to the counter of the mode that ran."""
    global LAUNCHES, LAUNCHES_SLIM, LAUNCHES_TM, LAUNCHES_TM_FUSED
    if is_fused(forcing):
        LAUNCHES_TM_FUSED += n
    elif forcing.dim() == 4:
        LAUNCHES_TM += n
    elif slim:
        LAUNCHES_SLIM += n
    else:
        LAUNCHES += n


def scan_cuda(tmp0, scal0, forcing, cfg: StepConfig, p: PhysicsParams,
              grid: LayerGrid, out_stride: int = 1, nsteps: int = None,
              out_offset=None, n_out: int = None, slim_trf=None,
              aux_rows=None, aux_cofs: bool = False, t_total: int = None,
              cof_red: float = None):
    """Launch csrc/scan_kernel.cu on CUDA tensors; the arguments and results
    of :func:`scan_reference` (K1, K2 with ``aux_rows``, K3 with a
    tile-major forcing).  Runs on the current stream, does not synchronise,
    and raises if the launch is refused."""
    from . import build

    lpad, P, T, tp, nsteps, off, n_rows, out_base, slim = _checked_launch(
        tmp0, scal0, forcing, cfg, grid, out_stride, nsteps, out_offset,
        n_out, slim_trf, aux_rows, aux_cofs, t_total, cof_red)
    if is_fused(forcing):
        raise ValueError("a fused chunk launches through scan_cuda_fused")
    consts = make_consts(cfg, p, grid, lpad, int(out_stride), n_rows)
    tmp_f = torch.empty_like(tmp0)
    scal_f = torch.empty_like(scal0)
    out = torch.empty((n_rows, N_OUT_FIELDS, P), dtype=torch.float32,
                      device=tmp0.device)
    lib = build.load()
    stream = torch.cuda.current_stream(tmp0.device).cuda_stream
    with torch.cuda.device(tmp0.device):
        if slim:
            rc = lib.roadsurf_scan_slim(
                ctypes.addressof(consts), tmp0.data_ptr(), scal0.data_ptr(),
                forcing.data_ptr(), slim_trf.data_ptr(), aux_rows.data_ptr(),
                tmp_f.data_ptr(), scal_f.data_ptr(), out.data_ptr(), P, tp,
                T, nsteps, off, out_base, int(bool(aux_cofs)),
                int(t_total) if aux_cofs else 0,
                float(cof_red) if aux_cofs else 1.0, stream)
        else:
            rc = lib.roadsurf_scan(
                ctypes.addressof(consts), tmp0.data_ptr(), scal0.data_ptr(),
                forcing.data_ptr(), tmp_f.data_ptr(), scal_f.data_ptr(),
                out.data_ptr(), P, tp, T, nsteps, off, out_base, stream)
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {rc} "
                           f"({build.error_string(rc)})")
    _count_launches(forcing, slim)
    return tmp_f, scal_f, out


def scan_cuda_fused(tmp0, scal0, src, cfg: StepConfig, p: PhysicsParams,
                    grid: LayerGrid, out_stride: int = 1,
                    nsteps: int = None, out_offset=None, n_out: int = None,
                    slim_trf=None, aux_rows=None, aux_cofs: bool = False,
                    t_total: int = None, cof_red: float = None):
    """Launch K3 fused (``roadsurf_scan_fused``) on CUDA tensors: the
    arguments and results of :func:`scan_fused_reference`, at
    :func:`stage_width`'s stage width (any power of two gives the same
    bits).  Runs on the current stream, does not synchronise, and raises
    if the launch is refused."""
    from . import build

    lpad, P, T, tp, nsteps, off, n_rows, out_base, _ = _checked_launch(
        tmp0, scal0, src, cfg, grid, out_stride, nsteps, out_offset, n_out,
        slim_trf, aux_rows, aux_cofs, t_total, cof_red)
    fa = fuse_args(src, tmp0.device)
    consts = make_consts(cfg, p, grid, lpad, int(out_stride), n_rows)
    tmp_f = torch.empty_like(tmp0)
    scal_f = torch.empty_like(scal0)
    out = torch.empty((n_rows, N_OUT_FIELDS, P), dtype=torch.float32,
                      device=tmp0.device)
    lib = build.load()
    fused_launch(lib, fa, "K3 fused", consts, tmp0.device)
    stream = torch.cuda.current_stream(tmp0.device).cuda_stream
    with torch.cuda.device(tmp0.device):
        rc = lib.roadsurf_scan_fused(
            ctypes.addressof(consts), ctypes.addressof(fa), tmp0.data_ptr(),
            scal0.data_ptr(), slim_trf.data_ptr(), aux_rows.data_ptr(),
            tmp_f.data_ptr(), scal_f.data_ptr(), out.data_ptr(), P, tp,
            nsteps, off, out_base, int(bool(aux_cofs)),
            int(t_total) if aux_cofs else 0,
            float(cof_red) if aux_cofs else 1.0, stream)
    if rc != 0:
        raise RuntimeError(f"fused scan kernel launch failed: CUDA error "
                           f"{rc} ({build.error_string(rc)})")
    _count_launches(src, True)
    return tmp_f, scal_f, out


def scan_fused_reference(tmp0, scal0, src, cfg: StepConfig,
                         p: PhysicsParams, grid: LayerGrid,
                         out_stride: int = 1, nsteps: int = None,
                         out_offset=None, n_out: int = None, slim_trf=None,
                         aux_rows=None, aux_cofs: bool = False,
                         t_total: int = None, cof_red: float = None,
                         stats: dict = None):
    """The plain version of K3 fused, on any device: the chunk's eager prep
    (``src.prepared()``: the expander's tile-layout raw window, the parts
    merged, ``forcing.prepare_window(time_axis=1)``), stacked by
    :func:`pack_forcing_slim_tm` into K3's slim forcing and run by
    :func:`scan_reference` with the same slim arguments."""
    forcing = pack_forcing_slim_tm(src.prepared())[0]
    return scan_reference(tmp0, scal0, forcing, cfg, p, grid,
                          out_stride=out_stride, nsteps=nsteps,
                          out_offset=out_offset, n_out=n_out,
                          slim_trf=slim_trf, aux_rows=aux_rows,
                          aux_cofs=aux_cofs, t_total=t_total,
                          cof_red=cof_red, stats=stats)


def scan_fused(tmp0, scal0, src, cfg: StepConfig, p: PhysicsParams,
               grid: LayerGrid, out_stride: int = 1, nsteps: int = None,
               out_offset=None, n_out: int = None, slim_trf=None,
               aux_rows=None, aux_cofs: bool = False, t_total: int = None,
               cof_red: float = None):
    """K3 fused on one block: CPU tensors run :func:`scan_fused_reference`,
    CUDA tensors the kernel."""
    args = (tmp0, scal0, src, cfg, p, grid, out_stride, nsteps, out_offset,
            n_out, slim_trf, aux_rows, aux_cofs, t_total, cof_red)
    if tmp0.device.type == "cpu":
        return scan_fused_reference(*args)
    if tmp0.device.type == "cuda":
        return scan_cuda_fused(*args)
    raise ValueError(f"no fused scan kernel for device {tmp0.device}")


def check_out(out, tmp0, scal0, shapes):
    """The caller's outputs of a sharded launch: one (tmp, scal, rows) of
    contiguous float32 tensors per block, on the block's device, of the
    launch's ``shapes`` [(tmp, scal, rows shape)], none of them in the
    storage of the block's ``tmp0`` or ``scal0`` (the kernel reads those
    while it writes these)."""
    if len(out) != len(tmp0):
        raise ValueError(f"out holds {len(out)} sets for {len(tmp0)} "
                         f"blocks")
    for b, (o, want) in enumerate(zip(out, shapes)):
        if len(o) != 3:
            raise ValueError(f"out[{b}]: (tmp, scal, rows), got {len(o)} "
                             f"tensors")
        reads = {x.untyped_storage().data_ptr() for x in (tmp0[b], scal0[b])}
        for name, x, shape in zip(("tmp", "scal", "rows"), o, want):
            if (tuple(x.shape) != tuple(shape) or x.dtype != torch.float32
                    or x.device != tmp0[b].device or not x.is_contiguous()):
                raise ValueError(
                    f"out[{b}] {name}: {tuple(x.shape)} {x.dtype} on "
                    f"{x.device}, contiguous {x.is_contiguous()}; need "
                    f"contiguous float32 {tuple(shape)} on "
                    f"{tmp0[b].device}")
            if x.untyped_storage().data_ptr() in reads:
                raise ValueError(f"out[{b}] {name} shares the storage of "
                                 f"the block's tmp0 or scal0")


def scan_cuda_sharded(tmp0, scal0, forcing, cfg: StepConfig,
                      p: PhysicsParams, grid: LayerGrid, streams,
                      out_stride: int = 1, nsteps: int = None,
                      out_offset=None, n_out: int = None, slim_trf=None,
                      aux_rows=None, aux_cofs: bool = False,
                      t_total: int = None, cof_red: float = None, out=None):
    """K4: one host call (``roadsurf_scan_sharded`` of csrc/scan_kernel.cu)
    that launches the kernel once per block of points, block ``b`` on
    ``streams[b]``, a ``torch.cuda.Stream`` of the device its tensors lie on.

    ``tmp0``, ``scal0``, ``forcing`` and, in the slim mode, ``slim_trf`` and
    ``aux_rows`` are sequences with one entry per block, each as
    :func:`scan_cuda` takes it (a fused chunk in place of every forcing
    tensor runs K3 fused on each block); the other arguments are the same
    for every block.  The results of block ``b`` are allocated on
    ``streams[b]`` (or are ``out[b]``, the caller's (tmp, scal, rows),
    checked by :func:`check_out`) and ordered after its launch there: the
    caller issues a block's other work on the same stream, or orders it
    against that stream itself.  Does not synchronise; raises if any launch
    is refused.  Returns a list of (tmp, scal, out) per block."""
    global LAUNCHES_SHARDED
    from . import build

    n = len(tmp0)
    if n == 0 or not (len(scal0) == len(forcing) == len(streams) == n):
        raise ValueError("one tmp0, scal0, forcing and stream per block")
    slim = aux_rows is not None
    if slim and not (slim_trf is not None
                     and len(aux_rows) == len(slim_trf) == n):
        raise ValueError("the slim mode needs one slim_trf and aux_rows per "
                         "block")
    geo = [_checked_launch(
        tmp0[b], scal0[b], forcing[b], cfg, grid, out_stride, nsteps,
        out_offset, n_out, slim_trf[b] if slim else None,
        aux_rows[b] if slim else None, aux_cofs, t_total, cof_red)
        for b in range(n)]
    lpad, _, T, _, nsteps, off, n_rows, out_base, _ = geo[0]
    fused = is_fused(forcing[0])
    kind = lambda f: "fused" if is_fused(f) else f.dim()
    for b, g in enumerate(geo):
        if (g[0], g[2]) != (lpad, T) or kind(forcing[b]) != kind(forcing[0]):
            raise ValueError(
                f"block {b} differs from block 0 in profile rows, steps or "
                f"forcing layout")
        if streams[b].device != tmp0[b].device:
            raise ValueError(f"block {b} on {tmp0[b].device}, its stream on "
                             f"{streams[b].device}")
    consts = make_consts(cfg, p, grid, lpad, int(out_stride), n_rows)
    if out is not None:
        check_out(out, tmp0, scal0,
                  [(t.shape, s.shape, (n_rows, N_OUT_FIELDS, g[1]))
                   for t, s, g in zip(tmp0, scal0, geo)])
        results = [tuple(o) for o in out]
    else:
        results = []
        for b in range(n):
            with torch.cuda.stream(streams[b]):
                results.append((
                    torch.empty_like(tmp0[b]), torch.empty_like(scal0[b]),
                    torch.empty((n_rows, N_OUT_FIELDS, geo[b][1]),
                                dtype=torch.float32,
                                device=tmp0[b].device)))
    ptrs = lambda xs: (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs))
    ints = lambda xs: (ctypes.c_int * n)(*xs)
    null = (ctypes.c_void_p * n)()
    lib = build.load()
    fas = None
    if fused:
        fas = (FuseArgs * n)(*(fuse_args(f, t.device)
                               for f, t in zip(forcing, tmp0)))
        for b in range(n):
            fused_launch(lib, fas[b], "K3 fused", consts, tmp0[b].device)
    failed_block = ctypes.c_int(-1)
    with torch.cuda.device(tmp0[0].device):
        rc = lib.roadsurf_scan_sharded(
            ctypes.addressof(consts), n,
            ints(t.device.index for t in tmp0),
            (ctypes.c_void_p * n)(*(s.cuda_stream for s in streams)),
            ptrs(tmp0), ptrs(scal0), null if fused else ptrs(forcing),
            ptrs(slim_trf) if slim else null,
            ptrs(aux_rows) if slim else null,
            ptrs(r[0] for r in results), ptrs(r[1] for r in results),
            ptrs(r[2] for r in results), ints(g[1] for g in geo),
            ints(g[3] for g in geo), T, nsteps, off, out_base, int(slim),
            int(bool(aux_cofs)), int(t_total) if aux_cofs else 0,
            float(cof_red) if aux_cofs else 1.0,
            ctypes.addressof(fas) if fused else None,
            ctypes.byref(failed_block))
    if rc != 0:
        raise RuntimeError(
            f"sharded scan kernel launch failed at block "
            f"{failed_block.value} of {n}: CUDA error {rc} "
            f"({build.error_string(rc)})")
    LAUNCHES_SHARDED += 1
    _count_launches(forcing[0], slim, n)
    return results


def scan(tmp0, scal0, forcing, cfg: StepConfig, p: PhysicsParams,
         grid: LayerGrid, out_stride: int = 1, nsteps: int = None,
         out_offset=None, n_out: int = None, slim_trf=None, aux_rows=None,
         aux_cofs: bool = False, t_total: int = None, cof_red: float = None):
    """The whole-scan entry point (pallas_step.py:579 ``pallas_scan``):
    CPU tensors run :func:`scan_reference`, CUDA tensors the kernel."""
    args = (tmp0, scal0, forcing, cfg, p, grid, out_stride, nsteps,
            out_offset, n_out, slim_trf, aux_rows, aux_cofs, t_total,
            cof_red)
    if tmp0.device.type == "cpu":
        return scan_reference(*args)
    if tmp0.device.type == "cuda":
        return scan_cuda(*args)
    raise ValueError(f"no scan kernel for device {tmp0.device}")


# ---------------------------------------------------------------------------
# packing helpers: State/Prepared <-> kernel layouts (pallas_step.py:736-821)
# ---------------------------------------------------------------------------

def pack_state(state, lpad: int = None):
    """State ([P] leaves, tmp [P, L+2]) -> (tmp0 [LPAD, P],
    scal0 [NROWS, P]) float32 on the state's device."""
    tmp = state.tmp.to(torch.float32).T                 # [L+2, P]
    l2, P = tmp.shape
    lpad = lpad or -(-l2 // 8) * 8
    tmp0 = torch.zeros((lpad, P), dtype=torch.float32, device=tmp.device)
    tmp0[:l2] = tmp
    scal0 = torch.zeros((NROWS, P), dtype=torch.float32, device=tmp.device)
    for r, x in ((R_TSURF, state.tsurf_ave), (R_WAT, state.wat),
                 (R_SNOW, state.snow), (R_ICE, state.ice),
                 (R_ICE2, state.ice2), (R_DEP, state.dep),
                 (R_Q2MELT, state.q2melt), (R_T4MELT, state.t4melt),
                 (R_EVAP, state.evap), (R_BLCOND, state.blcond),
                 (R_ALBEDO, state.albedo), (R_VERYCOLD, state.very_cold),
                 (R_FAILED, state.failed)):
        scal0[r] = x.to(torch.float32)
    return tmp0, scal0


def unpack_state(tmp_f, scal_f, nlayers: int, state_template):
    """Inverse of pack_state (keeps the template's float dtype)."""
    dt = state_template.tmp.dtype
    row = lambda r: scal_f[r].to(dt)
    return state_template._replace(
        tmp=tmp_f[:nlayers + 2].T.to(dt).contiguous(),
        tsurf_ave=row(R_TSURF), wat=row(R_WAT), snow=row(R_SNOW),
        ice=row(R_ICE), ice2=row(R_ICE2), dep=row(R_DEP),
        q2melt=row(R_Q2MELT), t4melt=row(R_T4MELT), evap=row(R_EVAP),
        blcond=row(R_BLCOND), albedo=row(R_ALBEDO),
        very_cold=scal_f[R_VERYCOLD] > 0.5,
        failed=scal_f[R_FAILED] > 0.5)


def forcing_thermo(tair, rhz):
    """Pure-forcing thermodynamics, precomputed out of the per-step kernel:
    eair (Magnus vapour pressure at the air temperature,
    BoundaryLayer.f90:156-170) and the air volumetric heat capacity
    rho_air*cp_air (BoundaryLayer.f90:33-36).  float32 in/out; shared by
    pack_forcing and the station-level prepared channels."""
    tak = tair + 273.15
    air_dens = 100000.0 / (287.05 * tak)
    air_hcap = 1005.0 + (tak - 250.0) ** 2 / 3364.0
    eair = torch.clamp(0.01 * rhz, max=1.0) * _esat(tair)
    return eair, air_hcap * air_dens


def prep_channels(prep):
    """The 11 (station, step)-varying channels of a Prepared ([T, P]
    leaves), float32, keyed by channel index (pallas_step.py:798-821)."""
    f32 = lambda x: x.to(torch.float32)
    tair = f32(prep.tair)
    eair, airvcap = forcing_thermo(tair, f32(prep.rhz))
    return {C_TAIR: tair, C_VZ: f32(prep.vz), C_EAIR: eair,
            C_AIRVCAP: airvcap, C_RAIN: f32(prep.rain),
            C_SNOW: f32(prep.snow), C_SW: f32(prep.sw), C_LW: f32(prep.lw),
            C_TSURF_OBS: f32(prep.tsurf_obs), C_VALID: f32(prep.valid),
            C_INCPL: f32(prep.in_coupling)}


def pack_forcing(prep, sw_cof, lw_cof, coupling_tsurf):
    """Prepared ([T, P] channels) -> [T, NCH, P] float32 (K1)."""
    T, P = prep.tair.shape
    out = torch.zeros((T, NCH, P), dtype=torch.float32,
                      device=prep.tair.device)
    for c, x in prep_channels(prep).items():
        out[:, c] = x
    out[:, C_TRF] = prep.trf_fric.to(torch.float32)[:, None]
    out[:, C_SWCOF] = sw_cof
    out[:, C_LWCOF] = lw_cof
    out[:, C_CPLOBS] = coupling_tsurf.to(torch.float32)[None, :]
    return out


def pack_forcing_slim(prep):
    """Prepared ([T, P] channels) -> (forcing [T, NCH_SLIM, P], slim_trf
    [T]) float32 (K2)."""
    T, P = prep.tair.shape
    out = torch.empty((T, NCH_SLIM, P), dtype=torch.float32,
                      device=prep.tair.device)
    for c, x in prep_channels(prep).items():
        out[:, SLIM_POS[c]] = x
    return out, prep.trf_fric.to(torch.float32).contiguous()


def pack_forcing_tm(prep, sw_cof, lw_cof, coupling_tsurf):
    """Prepared with tile-major [n_tiles, T, TP] channels (forcing.
    prepare_window with ``time_axis=1``) -> [n_tiles, T, NCH, TP] float32
    (K3 with all 16 channels).  ``sw_cof``/``lw_cof`` broadcast against
    [n_tiles, T, TP]; ``coupling_tsurf`` is [n_tiles, TP]."""
    nt, T, tp = prep.tair.shape
    out = torch.zeros((nt, T, NCH, tp), dtype=torch.float32,
                      device=prep.tair.device)
    for c, x in prep_channels(prep).items():
        out[:, :, c] = x
    out[:, :, C_TRF] = prep.trf_fric.to(torch.float32)[None, :, None]
    out[:, :, C_SWCOF] = sw_cof
    out[:, :, C_LWCOF] = lw_cof
    out[:, :, C_CPLOBS] = coupling_tsurf.to(torch.float32)[:, None, :]
    return out


def pack_forcing_slim_tm(prep):
    """Prepared with tile-major [n_tiles, T, TP] channels -> (forcing
    [n_tiles, T, NCH_SLIM, TP], slim_trf [T]) float32 (K3, slim;
    production.py:1689-1700): one stack, no point-major tensor."""
    ch = prep_channels(prep)
    return (torch.stack([ch[c] for c in SLIM_CHANNELS], dim=2),
            prep.trf_fric.to(torch.float32).contiguous())


def to_tile_major(forcing, tp: int):
    """Point-major [T, nch, P] forcing -> tile-major [P / tp, T, nch, tp]
    (a copy)."""
    T, nch, P = forcing.shape
    return (forcing.reshape(T, nch, P // tp, tp).permute(2, 0, 1, 3)
            .contiguous())


def to_point_major(forcing):
    """Tile-major [n_tiles, T, nch, TP] forcing -> point-major [T, nch, P]
    (a copy)."""
    nt, T, nch, tp = forcing.shape
    return forcing.permute(1, 2, 0, 3).reshape(T, nch, nt * tp)


def pack_aux(coupling_tsurf, sw_corr=None, lw_corr=None, coupling_end=None):
    """K2's aux rows [4, P] float32: sw_corr, lw_corr, coupling_end and the
    coupling obs (production.py:1762-1764); the first three are zero when
    not given (no coefficient decay)."""
    obs = coupling_tsurf.to(torch.float32)
    zero = torch.zeros_like(obs)
    f32 = lambda x: zero if x is None else x.to(torch.float32)
    return torch.stack([f32(sw_corr), f32(lw_corr), f32(coupling_end), obs])
