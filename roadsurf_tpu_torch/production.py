"""Production-scale streamed execution: the operational nationwide run, on
one GPU or over the point blocks of several devices and processes.

The counterpart of ``roadsurf_tpu/production.py`` (``StationExpander``,
``GridExpander``, ``CompositeExpander``, ``merge_windows``,
``last_valid_scan``, ``validation_counts``, ``host_shard``, ``_Engine``,
``run_production``, ``run_production_coupled``), with a list of devices in
place of the mesh.  The reference's
operational path is an async thread-pool runner over the full data plane
(examples/example2/src/roadrunner.cpp:595-719).  Here:

 * the compact forcing sources ship to the device once: station-keyed
   series ([S, T], a few thousand stations) and NWP grids (the raw
   [K, ny, nx] fields, extracted at the points on the device into [K, P]
   series on the raw times); per-point forcing is expanded chunk by chunk
   ON DEVICE (a row gather from the nearest-station index; the grid's
   gap-capped time interpolation), so the full [T, P] forcing tensor
   (hundreds of GB at 1M points) never exists anywhere;
 * every expander has a tile geometry (``tile_geometry`` of its point
   count) and keeps its per-point series in the kernel's tile layout
   [n_tiles, K, TP]; off the fast path each chunk goes to K3 fused as its
   raw inputs (``FusedChunk``: the grid's series rows and segment plan,
   the stations' series and index, the point parameters), and the kernel
   prepares every step's forcing, sky view included, in registers; no
   prepared forcing tensor exists (the JAX package's fused-generic route
   prepares it in XLA and stacks it for the kernel; ``_Engine.prepare``
   with ``tiled`` is that eager prep, the plain version's);
 * with a ``prep_ctx`` the forcing preparation runs once at station rank
   (the fast path) and each chunk is one row gather: into the slim
   [Tc, NCH_SLIM, P] layout of K2 (``slim=True``, the counterpart of the
   JAX package's fused route) or the packed [Tc, NCH, P] layout of K1
   (``slim=False``, its gather route); an expander without a tile
   geometry (a point count that is no multiple of 128) takes the generic
   path, the per-point ``forcing.prepare_window`` + ``pack_forcing`` into
   K1's layout, per chunk;
 * the points are cut into one equal contiguous block for each entry of
   ``devices`` (``expander.block``: station-rank data replicated on every
   device, point-rank data only on its block's; a station block sorted by
   station by ``station_sorted``, so a warp of the kernel runs points that converge together,
   its outputs returned in the caller's order); each chunk of every block
   goes through ONE sharded launch of the hand-written CUDA whole-scan
   kernel (K4, ``parallel/sharding.py`` -> ``ops/scan_kernel.py``), each
   block on its own stream, with no exchange between blocks; the
   prognostic state stays on its device in the kernel's packed layout
   between chunks;
 * the kernel writes only the run-level output-stride rows of each chunk,
   which are drained to the host chunk by chunk;
 * the coupled run streams phases A and C through the kernel and runs the
   coupling window (phase B) of each block as one launch of the window
   kernel K5 (``ops/window_kernel.py``), a program counter per point, its
   forcing a table of the window's prepared rows (or point slices of it,
   where the table would not fit the window budget).

``_Blocks.stream`` pipelines its dispatch ``PIPELINE_DEPTH`` (two) deep, as
the JAX engine does: per chunk the host issues every block's forcing on the
block's stream, launches all blocks in one call into one of two alternating
output sets, and queues each block's rows for the host (put in the caller's
order on the device, then copied on the block's copy stream into a pinned
staging buffer); only then does it drain the chunk before, waiting on that
chunk's copy events alone and copying its rows to their place among the
run's output steps while the card runs the chunk just issued.
Across processes (``parallel/distributed.py``) each process runs the blocks
of its own point range and drains only them (``drain="shard"``); no tensor
crosses between processes.

Spans (``observability.RunMetrics``; profiler ranges ``roadsurf::<name>``
while a torch profiler records): each engine-entry call is one ``cycle``
(its index an id of every span inside it), split into ``cycle_setup``
(from the entry to the first chunk's issue: ``.sky_route``, with the
counter ``horizon_table_scans`` of the calls that read the horizon table,
``.blocks``, each block's expander block and station sort, ``.place``, the
engine's placement, ``.build``, the kernels' library, ``.window_plan`` and
``.host_rows``), ``stream`` and ``output``.  Within the stream each chunk
is one ``stream.issue`` and, per block, one ``stream.drain.wait`` and one
``stream.drain.rows`` (the chunk's index an id of each; their seconds also
in the counters ``stream_issue_s``, ``stream_wait_s`` and
``stream_rows_s``, the bytes copied in ``stream_rows_bytes``); a coupled
run's stream is ``phase_a``, ``phase_b`` (``.launch``, ``.sync``) and
``phase_c``.
"""
from __future__ import annotations

import copy
import time as timelib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import MISSING
from .forcing import Calendar, Prepared, RawForcing, cof_window, \
    prepare_window, valid_threshold
from .model import Model
from .observability import Progress, RunMetrics
from .physics.sun import sun_time_terms
from .ops import scan_kernel as sk
from .ops import window_kernel as wk
from .state import PointParams, State

OUT_FIELD_ROWS = {"tsurf": sk.R_TSURF, "wat": sk.R_WAT, "snow": sk.R_SNOW,
                  "ice": sk.R_ICE, "ice2": sk.R_ICE2, "dep": sk.R_DEP}

#: point-count multiple (the JAX engine's mesh x lane rule,
#: production.py:90-93, on one device): the kernel's thread block
LANE = sk.LANE
#: the card's warp: K5's threads run in groups of this many points
WARP = 32

#: default largest tile width of the tile-major kernel mode (K3), chosen by
#: its timing on the card (PERF.md, Findings)
TILE_P = 1024


def padded_points(n_points: int, ndev: int = 1) -> int:
    """Points padded so that they divide ``ndev`` blocks of whole 128-point
    lanes (production.py:90-93)."""
    mult = ndev * LANE
    return -(-n_points // mult) * mult


def tile_geometry(n_points: int, ndev: int = 1):
    """``(n_tiles, TP)`` of the kernel's tile-major layout over ``ndev``
    equal point blocks (production.py:96-107): TP the largest multiple of
    LANE up to TILE_P that divides a block's point count, so each block
    holds whole tiles; None for a count that does not divide into blocks of
    whole lanes (the expander then has no tile layout)."""
    if n_points <= 0 or n_points % (ndev * LANE):
        return None
    p_loc = n_points // ndev
    tp = min(TILE_P, p_loc) // LANE * LANE
    while p_loc % tp:
        tp -= LANE
    return (n_points // tp, tp)


#: the chunk rule of ``auto_chunk_t``, from the station stream (K2) timed
#: on an H100 80GB HBM3 at 700 W at chunk 32-256, two rounds in each of
#: three runs of chip_smoke.py phase 9t (PERF.md, Findings, PR 7): at
#: 1,048,576 points chunk 128 beat 64 in all six readings (by 3-14%), 256
#: beat 128 in one run of three and lost in two, and the peak memory over
#: the resident rose 3.3 / 6.1 / 11.7 GiB at 64 / 128 / 256 (the slim
#: chunk, 44 B a point-step); at 65,536 points the stream is host-bound
#: and falls with every doubling up to 256 (0.29-0.55 s at 64, 0.12-0.17 s
#: at 256).  So chunk_t x P is held near 128 x 1M; the floor keeps a
#: chunk's forcing near 12 GB up to 4M points a process, the cap bounds a
#: small run's output rows a chunk.
CHUNK_TARGET_POINT_STEPS = 128 * 1048576
CHUNK_FLOOR = 64
CHUNK_CAP = 1024

#: chunks in flight in ``_Blocks.stream``: chunk k is issued before chunk
#: k-1 is drained (production.py:1826-1856 waits on chunk k-2 the same
#: way); 1 drains each chunk before the next is issued.  Both give the same
#: bits: only the order of the host's work changes.
PIPELINE_DEPTH = 2


def auto_chunk_t(n_points: int) -> int:
    """Streaming chunk length for a run of ``n_points`` (production.py:
    110-121): chunk_t x P held near CHUNK_TARGET_POINT_STEPS, at least
    CHUNK_FLOOR and at most CHUNK_CAP steps, a multiple of 8.  A chunk
    carries enough kernel work to hide the host's per-chunk cost while its
    forcing stays well inside the card's memory.  The kernel carries the
    state across chunks, so the station routes' results do not depend on
    it (a grid's float32 interpolation is rebased on each chunk's first
    step, ``GridExpander.segments``)."""
    tc = max(CHUNK_FLOOR, CHUNK_TARGET_POINT_STEPS // max(n_points, 1))
    return min(CHUNK_CAP, tc) // 8 * 8


def _span(pos, chunk_t: int, t_pad: int) -> int:
    """The most raw positions a window of ``chunk_t`` steps advances
    through, plus one, over the padded sim grid's raw positions ``pos``."""
    return int(np.max(pos[chunk_t - 1:] - pos[:t_pad - chunk_t + 1])) + 1


def grid_span(times, sim_epochs, chunk_t: int) -> int:
    """The SPAN (segments a chunk's window holds) of a GridExpander of the
    raw ``times`` over ``sim_epochs`` at ``chunk_t``, without building it.
    K3 fused and K5 fused take any SPAN: a lane holds its segment lines a
    stage (``ops.scan_kernel.stage_width`` segments) at a time."""
    times = np.unique(np.asarray(times, np.int64))
    sim = np.asarray(sim_epochs, np.int64)
    t_pad = (-(-len(sim) // chunk_t) + 1) * chunk_t
    sim_pad = np.concatenate([sim, np.full(t_pad - len(sim), sim[-1],
                                           np.int64)])
    return _span(np.searchsorted(times, sim_pad, side="left"), chunk_t,
                 t_pad)


def host_shard(blocks, axis: int):
    """This process's columns of a sharded value along ``axis``
    (production.py:63-87): ``blocks`` is [(tensor, (lo, hi))], the
    process's blocks with their global point ranges; returns (local numpy,
    (lo, hi)), the blocks joined in order on the host.  The reference
    assembles output by disjoint-row writes into one shared object
    (examples/example2/src/QueryDataTools.cpp:299-345); across processes
    the equivalent is each process pulling ONLY its own columns and writing
    them with a range manifest (io.writer.write_shard_npz /
    merge_shards)."""
    blocks = sorted(blocks, key=lambda b: b[1][0])
    lo = cur = blocks[0][1][0]
    parts = []
    for x, (b_lo, b_hi) in blocks:
        if b_lo != cur:
            raise ValueError(
                f"non-contiguous blocks along axis {axis}: expected start "
                f"{cur}, got {b_lo}")
        parts.append(x.detach().cpu().numpy())
        cur = b_hi
    return np.concatenate(parts, axis=axis), (lo, cur)


def _to_tiles(x, tile_geom):
    """A point-major [P, ...] tensor as the tile layout [n_tiles, TP, ...]
    (a view)."""
    nt, tp = tile_geom
    return x.reshape((nt, tp) + tuple(x.shape[1:]))


def _missing_like(shape, name, device):
    """The missing sentinel of a RawForcing field, broadcast to ``shape``."""
    if name == "prec_phase":
        return torch.full(shape, -9999, dtype=torch.int32, device=device)
    return torch.full(shape, MISSING, dtype=torch.float32, device=device)


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

    ``tile_geom`` (``tile_geometry(num_points)``; production.py:466-535):
    ``window_tm`` emits raw windows in the kernel's tile layout, by the same
    row gather as ``window``; the engine runs the per-point prep in that
    layout and the kernel's tile-major mode K3 whenever it does not take
    the fast path (sky view on, or no ``prep_ctx``), and a
    CompositeExpander can overlay it on a grid in that layout.

    Station order: ``block`` cuts in the caller's order; a run places each
    block through ``station_sorted``, which sorts its points by station.
    """

    def __init__(self, raw_st: RawForcing, st_idx, device, chunk_t: int,
                 prep_ctx: Optional[dict] = None, slim: bool = True):
        st_idx = np.asarray(st_idx)
        self.slim = bool(slim)
        self.device = torch.device(device)
        self.num_points = len(st_idx)
        self.tile_geom = tile_geometry(self.num_points)
        self.chunk_t = chunk_t
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
        self._replicas = {}
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
                                 device=dev),
            # K2's channels of stf, an index on the device: indexing with a
            # Python list would copy it to the card and wait for the
            # stream in every chunk
            "slim": torch.tensor(sk.SLIM_CHANNELS, dtype=torch.int64,
                                 device=dev)}

    @property
    def device_data(self) -> dict:
        """The device tensors the expansion reads."""
        d = {"ch": self.channels, "ok": self.ok, "sidx": self.st_idx}
        if self.prep_data is not None:
            d["prep"] = self.prep_data
        return d

    def _replica(self, device) -> dict:
        """The station-rank tensors (raw channels; prepared channels, their
        RH and TRF) on ``device``: this expander's own where it is its
        device, else one copy per device, shared by that device's
        blocks."""
        key = str(device)
        if key not in self._replicas:
            mv = lambda x: x.to(device)
            rep = {"channels": RawForcing(*(mv(x) for x in self.channels))}
            if self.prep_data is not None:
                rep["prep"] = {k: mv(self.prep_data[k])
                               for k in ("stf", "rhz", "trf", "slim")}
            self._replicas[key] = rep
        return self._replicas[key]

    def block(self, lo: int, hi: int, device):
        """The expander of the point block [lo, hi) on ``device`` (a block
        of a sharded run): station-rank data replicated per device,
        point-rank data (station index, mask) cut to the block; views of
        this expander's tensors where the device is its own."""
        device = torch.device(device)
        b = copy.copy(self)
        b.device, b.num_points = device, hi - lo
        b.tile_geom = tile_geometry(hi - lo)
        rep = self._replica(device)
        cut = lambda x: x[lo:hi].to(device)
        b.channels = rep["channels"]
        b.ok, b.st_idx = cut(self.ok), cut(self.st_idx)
        b._ok_host = self._ok_host[lo:hi]
        b._ie_host = self._ie_host[lo:hi]
        b.first_host = {n: v[lo:hi] for n, v in self.first_host.items()}
        if self.prep_data is not None:
            b.prep_data = dict(rep["prep"],
                               sidx=cut(self.prep_data["sidx"]))
        return b

    def host_at(self, sim_sel, names=("tair", "tdew", "rhz")) -> dict:
        """Host per-point values at selected sim steps (production.py:
        559-568): {name: [P, n]}."""
        sel = np.asarray(sim_sel)
        out = {}
        for n in names:
            v = np.asarray(getattr(self._raw_host, n))[:, sel]
            out[n] = np.where(self._ok_host[:, None], v[self._ie_host],
                              MISSING)
        return out

    def window(self, t0: int, tc: int) -> RawForcing:
        """[tc, P] raw forcing for global steps [t0, t0+tc) (the generic
        path)."""
        return self.window_from(self.channels, self.ok, self.st_idx, t0, tc)

    def window_tm(self, t0: int, tc: int) -> RawForcing:
        """Raw forcing for global steps [t0, t0+tc) in the kernel's tile
        layout, [n_tiles, tc, TP] leaves (point p at tile p // TP, lane
        p % TP): the row gather of ``window``, laid out per tile."""
        nt, tp = self.tile_geom
        ok = self.ok.reshape(nt, 1, tp)

        def expand(ch, name):
            v = ch[:, t0:t0 + tc].index_select(0, self.st_idx)  # [P, tc]
            v = v.reshape(nt, tp, -1).transpose(1, 2)        # [nt, tc, TP]
            return torch.where(ok, v, _missing_like((), name, v.device))
        return RawForcing(*(expand(getattr(self.channels, n), n)
                            for n in RawForcing._fields))

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
        sl = pd["stf"][t0:t0 + tc].index_select(1, pd["slim"])
        return sl.index_select(2, pd["sidx"])

    def prepared_window(self, t0: int, tc: int) -> Prepared:
        """[tc, P] Prepared rows from the station-level prepared channels
        (production.py:2044-2067): equal, bit for bit, to prepare_window on
        the expanded raws.  The provider of the eager window engine
        (``coupling.run_window_passes``) on the station route, which K5's
        station table is held against; the run reads the table itself
        (``_Engine.window_table``)."""
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


def station_sorted(block):
    """``block`` (an expander's ``block``) in the order a run places it.

    A StationExpander block comes back with its points sorted by station
    with a stable sort, out-of-radius points last (production.py:289-346,
    the JAX package's ``point_perm``): the 32 points of a warp of the
    kernel then mostly share a station and run the boundary-layer fixed
    point for the same count of iterations, where in the caller's order a
    warp runs it until the slowest of 32 random stations is done.  The sort
    never crosses the block, so its range, shards and checkpoints keep
    their points.  ``point_perm`` [P] (on the block's device) lists the
    caller's points in that order and ``point_inv`` is its inverse, both
    None where the caller's order is already sorted; the station index and
    mask follow the order, the host arrays stay in the caller's.  The
    engine places every per-point array in that order and returns outputs
    and state in the caller's.  Grid and composite blocks keep the caller's
    order and come back as they are."""
    if not isinstance(block, StationExpander):
        return block
    b = copy.copy(block)
    S = np.asarray(b._raw_host.tair).shape[0]
    order = np.argsort(np.where(b._ok_host, b._ie_host, S), kind="stable")
    b.point_perm = b.point_inv = None
    if np.array_equal(order, np.arange(len(order))):
        return b
    perm = torch.as_tensor(order, device=b.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(order), device=b.device)
    b.point_perm, b.point_inv = perm, inv
    b.ok, b.st_idx = (b.ok.index_select(0, perm),
                      b.st_idx.index_select(0, perm))
    if b.prep_data is not None:
        b.prep_data = dict(b.prep_data, sidx=b.prep_data["sidx"]
                           .index_select(0, perm))
    return b


def merge_windows(windows: Sequence[RawForcing]) -> RawForcing:
    """Source-overlay merge of windows of one layout, in config order:
    later sources overwrite earlier values where valid (production.py:
    632-646; DataHandler per-value overlay,
    examples/example1/src/DataHandler.cpp:73-82)."""
    if len(windows) == 1:
        return windows[0]
    out = {}
    for name in RawForcing._fields:
        thr = valid_threshold(name)
        acc = getattr(windows[0], name)
        for w in windows[1:]:
            v = getattr(w, name)
            acc = torch.where(v > thr, v, acc)
        out[name] = acc
    return RawForcing(**out)


class CompositeExpander:
    """Overlay of several expanders (grid + station sources in one config),
    merged per value in source order (production.py:649-718; the example2
    DataManager stack, examples/example2/src/DataManager.cpp:67-77).

    The tile layout composes when all parts share one ``tile_geom``;
    otherwise the composite has none and the engine runs the generic
    path.  The composite keeps the caller's point order, which its grid
    parts are laid out in: parts that carry a point permutation (a block
    through ``station_sorted``) are refused."""

    def __init__(self, parts: Sequence):
        if not parts:
            raise ValueError("CompositeExpander needs at least one part")
        for p in parts:
            if getattr(p, "point_perm", None) is not None:
                raise ValueError(
                    "CompositeExpander parts must not carry a point "
                    "permutation: the port keeps every part in the "
                    "caller's point order")
        self.parts = list(parts)
        self.num_points = parts[0].num_points
        self.t_pad = parts[0].t_pad
        self.chunk_t = min(p.chunk_t for p in parts)
        self.device = parts[0].device
        for p in parts[1:]:
            if p.num_points != self.num_points or p.t_pad != self.t_pad:
                raise ValueError(
                    f"parts differ in points or padded steps: "
                    f"{(p.num_points, p.t_pad)} vs "
                    f"{(self.num_points, self.t_pad)}")
        geoms = [getattr(p, "tile_geom", None) for p in parts]
        self.tile_geom = (geoms[0] if all(
            g is not None and g == geoms[0] for g in geoms) else None)
        self.first_host = {}
        for name in RawForcing._fields:
            thr = valid_threshold(name)
            acc = np.asarray(self.parts[0].first_host[name])
            for p in self.parts[1:]:
                v = np.asarray(p.first_host[name])
                acc = np.where(v > thr, v, acc)
            self.first_host[name] = acc

    @property
    def device_data(self):
        return tuple(p.device_data for p in self.parts)

    def block(self, lo: int, hi: int, device):
        """The composite of every part's block [lo, hi) on ``device``."""
        return CompositeExpander([p.block(lo, hi, device)
                                  for p in self.parts])

    def window(self, t0: int, tc: int) -> RawForcing:
        return merge_windows([p.window(t0, tc) for p in self.parts])

    def window_tm(self, t0: int, tc: int) -> RawForcing:
        """Tile-layout overlay: each part expands in the kernel's tile
        layout; the per-value merge is elementwise."""
        return merge_windows([p.window_tm(t0, tc) for p in self.parts])

    def host_at(self, sim_sel, names=("tair", "tdew", "rhz")) -> dict:
        outs = [p.host_at(sim_sel, names) for p in self.parts]
        merged = {}
        for n in names:
            thr = valid_threshold(n)
            acc = outs[0][n]
            for o in outs[1:]:
                acc = np.where(o[n] > thr, o[n], acc)
            merged[n] = acc
        return merged


#: CheckValues input ranges (src/InputOutput.f90:55-82); a value outside its
#: range (or missing, -9999.9) poisons the point from that step on.
CHECK_RANGES = (("tair", -90.0, 100.0), ("tdew", -90.0, 100.0),
                ("rhz", -0.1, 120.0), ("vz", -1.0, 100.0),
                ("sw", -0.1, 4000.0), ("lw", -0.1, 1000.0),
                ("prec", -0.1, 500.0))


def validation_counts(expander, T: int, chunk_t: int = 64,
                      n_real: Optional[int] = None):
    """Per-variable CheckValues failure screen over the MERGED forcing
    (production.py:729-775), chunk by chunk on the device: per variable,
    the count of points carrying any out-of-range or missing value (the
    final step is exempt: CheckValues does not run there,
    Simulation.f90:100-113).  Returns ({var: point_count},
    total_distinct_points).  Windows are at most the expander's own chunk
    long: its window geometry (the grid's SPAN) covers no longer one."""
    chunk_t = max(1, min(chunk_t, expander.chunk_t))
    dev = expander.device
    bad = torch.zeros((len(CHECK_RANGES), expander.num_points),
                      dtype=torch.bool, device=dev)
    for t0 in range(0, max(T - 1, 1), chunk_t):
        raw = expander.window(t0, chunk_t)
        live = (t0 + torch.arange(chunk_t, device=dev) < T - 1)[:, None]
        for i, (name, lo, hi) in enumerate(CHECK_RANGES):
            v = getattr(raw, name)
            bad[i] |= (((v < lo) | (v > hi)) & live).any(dim=0)
    badh = bad.cpu().numpy()
    if n_real is not None:
        badh = badh[:, :n_real]
    counts = {name: int(c) for (name, _, _), c
              in zip(CHECK_RANGES, badh.sum(axis=1))}
    return counts, int(badh.any(axis=0).sum())


def last_valid_scan(expander, T: int, chunk_t: int = 64,
                    names=("tsurf_obs",), n_real: Optional[int] = None):
    """Per-point last-valid 0-based sim index and value of merged forcing
    channels, chunk by chunk on the device (production.py:778-829): the
    coupling observation (latest valid TSurfObs and its index,
    examples/example1/src/roadrunner.cpp:258-276) and the relaxation anchor
    index (GetLatestObsIndex, JsonSource.cpp:397-414), without building the
    [P, T] series.  Returns {name: (last_idx [P] int32 (-1 = none),
    value_at_last [P] float32)}.  Windows are at most the expander's own
    chunk long, as in ``validation_counts``."""
    chunk_t = max(1, min(chunk_t, expander.chunk_t))
    dev = expander.device
    Pn = expander.num_points
    carry = {n: (torch.full((Pn,), -1, dtype=torch.int32, device=dev),
                 torch.full((Pn,), MISSING, dtype=torch.float32, device=dev))
             for n in names}
    krow = torch.arange(chunk_t, device=dev)[:, None]
    for t0 in range(0, T, chunk_t):
        raw = expander.window(t0, chunk_t)
        live = t0 + krow < T
        for n in names:
            idx, val = carry[n]
            v = getattr(raw, n).to(torch.float32)
            valid = (v > valid_threshold(n)) & live
            lastk = torch.where(valid, krow, -1).amax(dim=0)     # [P]
            any_v = lastk >= 0
            vlast = torch.gather(v, 0, lastk.clamp(min=0)[None])[0]
            carry[n] = (torch.where(any_v, t0 + lastk, idx).to(torch.int32),
                        torch.where(any_v, vlast, val))
    out = {}
    for n in names:
        idxh, valh = (x.cpu().numpy() for x in carry[n])
        if n_real is not None:
            idxh, valh = idxh[:n_real], valh[:n_real]
        out[n] = (idxh, valh)
    return out


class GridExpander:
    """On-device gridded-NWP -> point forcing expansion (production.py:
    832-1327; the QueryDataSource grid path,
    examples/example2/src/QueryDataSource.cpp:585-722, streamed).

    Once: the raw [K, ny, nx] grids go to the device and are extracted at
    the points there (``_extract_device``: four-corner gathers with the
    cell indices, weights and the prec_phase corner order computed on the
    host in float64), giving compact [K, P] per-variable series on the RAW
    forecast times (K ~ 75 hourly samples, tiny next to [T, P]);
    ``extract="host"`` extracts on the host instead
    (``io.gridsource.bilinear_at_points``).  The series are stored in the
    kernel's tile layout [n_tiles, K, TP] when ``tile_geometry(P)`` exists,
    else time-major [K, P].

    Per chunk (``window`` / ``window_tm``): the reference's gap-capped time
    interpolation with missing-sample search (QueryDataSource.cpp:331-425,
    io.gridsource.interpolate_gapped / nearest_gapped) for the chunk's sim
    steps, over a window of KW raw rows around the chunk's position (sized
    at build time so every sample pair within the gap cap lies inside);
    each step picks its piecewise-linear segment by a gather on the segment
    axis, and prec_phase its sample by a gather on the raw-time axis.  Both
    layouts run the same op sequence, so tiled equals flat bit for bit.
    A window is at most ``chunk_t`` steps long: SPAN covers no longer one.
    Float32 throughout.
    """

    #: host_at variables worth keeping resident (repeated reads); anything
    #: else recomputes rather than pinning a [P, K] float64 series
    _PV_STAPLES = ("tair", "tdew", "rhz", "vz")

    def __init__(self, times, glats, glons, fields: dict, plat, plon,
                 sim_epochs, device, chunk_t: int,
                 max_gap_s: float = 180 * 60.0, extract: str = "device"):
        if extract not in ("device", "host"):
            raise ValueError(f"extract must be 'device' or 'host', got "
                             f"{extract!r}")
        plat = np.asarray(plat, np.float64)
        plon = np.asarray(plon, np.float64)
        self.device = dev = torch.device(device)
        self.num_points = Pn = len(plat)
        self.tile_geom = tile_geometry(Pn)
        self.chunk_t = chunk_t
        self.max_gap_s = float(max_gap_s)
        sim = np.asarray(sim_epochs, np.int64)
        T = len(sim)
        self.sim_len = T
        self.t_pad = t_pad = (-(-T // chunk_t) + 1) * chunk_t

        times = np.asarray(times, np.int64)
        order = np.argsort(times, kind="stable")
        # keep-last at duplicate raw times (directory-merge convention)
        keep = np.ones(len(times), bool)
        keep[:-1] = np.diff(times[order]) > 0
        sel = order[keep]
        times = times[sel]
        fields = {k: np.asarray(v, np.float64)[sel] for k, v in fields.items()}
        K = len(times)
        if K == 0:
            raise ValueError("grid source has no time samples")

        # --- position machinery on the padded sim grid (:902-914) ---------
        sim_pad = np.concatenate([sim, np.full(t_pad - T, sim[-1], np.int64)])
        pos = np.searchsorted(times, sim_pad, side="left")         # in [0, K]
        in_data = pos < K
        posc = np.clip(pos, 0, K - 1)
        texact = in_data & (times[posc] == sim_pad)
        # nearest-time pick for prec_phase (QueryDataSource.cpp:397-425):
        # candidates pos-1/pos, ties to the later sample, gap-capped
        p1 = np.clip(posc - 1, 0, K - 1)
        gap1 = (sim_pad - times[p1]).astype(np.float64)
        gap2 = (times[posc] - sim_pad).astype(np.float64)
        have_n = (pos > 0) & in_data & (np.minimum(gap1, gap2) <= max_gap_s)
        pick = np.where(gap1 < gap2, p1, posc)

        # --- window geometry (:916-935): MB raw rows below the position
        # cover every earlier sample within the gap cap, MF rows above every
        # later one; SPAN is the largest position advance in a chunk
        if K > 1:
            jmin = np.searchsorted(times, times[:-1] - int(max_gap_s),
                                   side="right")
            MB = int(np.max(np.arange(1, K) - jmin))
            jmax = np.searchsorted(times, times[1:] + int(max_gap_s),
                                   side="right") - 1
            MF = int(np.max(jmax - np.arange(1, K))) + 1
        else:
            MB, MF = 1, 1
        self.MB = MB = max(MB, 1)
        self.SPAN = _span(pos, chunk_t, t_pad)
        self.KW = min(K, MB + self.SPAN + MF)
        self.K = K

        self.var_names = [n for n in RawForcing._fields if n in fields]
        self._href = (times, glats, glons, fields, plat, plon, sim)
        self._pv_cache = {}        # name -> [P, K] float64 point series
        if (extract == "device" and self.var_names
                and len(np.atleast_1d(glats)) >= 2
                and len(np.atleast_1d(glons)) >= 2):
            pv = self._extract_device(fields, glats, glons, plat, plon)
        else:
            pv = {}
            for name in self.var_names:
                x = torch.tensor(self._point_series(name).astype(np.float32),
                                 device=dev)                      # [P, K]
                pv[name] = (_to_tiles(x, self.tile_geom).transpose(1, 2)
                            .contiguous() if self.tile_geom is not None
                            else x.T.contiguous())
        put = lambda x: torch.tensor(x, device=dev)
        self._pos_host = pos
        self._data = {
            "pv": pv,
            "trw": put((times - sim[0]).astype(np.float32)),
            "pos": put(pos.astype(np.int64)),
            "trel": put((sim_pad - sim[0]).astype(np.float32)),
            "tex": put(texact),
            "pick": put(pick.astype(np.int64)),
            "havep": put(have_n),
            "miss": torch.tensor(MISSING, dtype=torch.float32, device=dev),
        }

        # first-step values from only the raw samples that can influence
        # sim[0] (within the gap cap), not the full series (:977-996)
        from .io.gridsource import (bilinear_at_points,
                                    nearest_corner_at_points,
                                    timeseries_at_points)
        k1 = min(K, int(np.searchsorted(
            times, sim[0] + np.int64(max_gap_s), side="right")) + 1)
        pv1 = {}
        for n in self.var_names:
            sp = (nearest_corner_at_points if n == "prec_phase"
                  else bilinear_at_points)
            pv1[n] = sp(fields[n][:k1], glats, glons, plat, plon).T
        first = timeseries_at_points(times[:k1], pv1, sim[:1],
                                     self.max_gap_s)
        self.first_host = {
            n: (first[n][:, 0] if n in first
                else np.full(Pn, -9999 if n == "prec_phase" else MISSING))
            for n in RawForcing._fields}

    def _extract_device(self, fields, glats, glons, plat, plon) -> dict:
        """Device-side spatial extraction (production.py:998-1103): the raw
        [K, ny*nx] grids go to the device with per-point cell geometry
        computed on the host in float64 -- the decisions of
        io.gridsource.bilinear_at_points / nearest_corner_at_points,
        including the weight-sorted corner order where the first valid
        corner wins for prec_phase -- so only the weighted accumulation
        runs in float32 (QueryDataSource.cpp:931, InterpolatedValue).
        Returns {name: [n_tiles, K, TP] or [K, P] float32}."""
        K, dev = self.K, self.device
        la = np.asarray(glats, np.float64)
        lo_ = np.asarray(glons, np.float64)
        flip = len(la) > 1 and la[1] < la[0]
        if flip:
            la = la[::-1]
        ny, nx = len(la), len(lo_)
        iy = np.clip(np.searchsorted(la, plat, side="right") - 1, 0, ny - 2)
        ix = np.clip(np.searchsorted(lo_, plon, side="right") - 1, 0,
                     nx - 2)
        inside = ((plat >= la[0]) & (plat <= la[-1])
                  & (plon >= lo_[0]) & (plon <= lo_[-1]))
        dy = la[iy + 1] - la[iy]
        dx = lo_[ix + 1] - lo_[ix]
        fy = np.where(dy > 0, (plat - la[iy]) / np.where(dy > 0, dy, 1.0),
                      0.0)
        fx = np.where(dx > 0, (plon - lo_[ix]) / np.where(dx > 0, dx, 1.0),
                      0.0)
        i_list, w_list = [], []
        for cy, cx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                          (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            i_list.append((iy + cy) * nx + (ix + cx))
            w_list.append(w)
        idx4 = np.stack(i_list, axis=1)                    # [P, 4]
        w4 = np.stack(w_list, axis=1)                      # [P, 4] float64
        # nearest-valid-corner pick order: weight-descending, stable in
        # corner order (the host loop's strict `w > best` tie-break)
        order = np.argsort(-w4, axis=1, kind="stable")
        sidx4 = np.take_along_axis(idx4, order, axis=1)
        put = lambda x, dt=None: torch.tensor(np.ascontiguousarray(x),
                                              dtype=dt, device=dev)
        idx4_d, sidx4_d = put(idx4, torch.int64), put(sidx4, torch.int64)
        w4_d = put(w4.astype(np.float32))
        ins_d = put(inside)[None, :]
        miss = torch.tensor(MISSING, dtype=torch.float32, device=dev)

        def extract(ff, nearest):
            # ff: [K, ny*nx] float32 -> [K, P]
            valid_of = lambda v: ~(torch.isnan(v) | (v <= -9000.0))
            if nearest:
                best = torch.full((K, self.num_points), MISSING,
                                  dtype=ff.dtype, device=dev)
                havec = torch.zeros(best.shape, dtype=torch.bool, device=dev)
                for c in range(4):
                    v = ff.index_select(1, sidx4_d[:, c])
                    valid = valid_of(v)
                    best = torch.where(valid & ~havec, v, best)
                    havec = havec | valid
                return torch.where(ins_d, best, miss)
            acc = torch.zeros((K, self.num_points), dtype=ff.dtype,
                              device=dev)
            wsum = torch.zeros_like(acc)
            for c in range(4):
                v = ff.index_select(1, idx4_d[:, c])
                valid = valid_of(v)
                w = w4_d[:, c][None, :]
                acc = acc + torch.where(valid, v, 0.0) * w
                wsum = wsum + w * valid
            ok = (wsum > 1e-12) & ins_d
            return torch.where(ok, acc / torch.where(wsum > 1e-12, wsum, 1.0),
                               miss)

        pv = {}
        for name in self.var_names:
            f = np.asarray(fields[name])
            if flip:
                f = f[:, ::-1, :]
            ff = put(f.reshape(K, ny * nx).astype(np.float32))
            out = extract(ff, name == "prec_phase")              # [K, P]
            if self.tile_geom is not None:
                nt, tp = self.tile_geom
                out = out.reshape(K, nt, tp).transpose(0, 1).contiguous()
            pv[name] = out
            del ff
        return pv

    def block(self, lo: int, hi: int, device):
        """The expander of the point block [lo, hi) on ``device`` (a block
        of a sharded run): the per-point raw-time series cut to the block
        (a view of this expander's where the device is its own and the
        block holds whole tiles of its layout, else a copy in the block's
        own layout), the time machinery replicated."""
        device = torch.device(device)
        b = copy.copy(self)
        b.device, b.num_points = device, hi - lo
        b.tile_geom = geom = tile_geometry(hi - lo)
        times, glats, glons, fields, plat, plon, sim = self._href
        b._href = (times, glats, glons, fields, plat[lo:hi], plon[lo:hi],
                   sim)
        b._pv_cache = {}
        b.first_host = {n: v[lo:hi] for n, v in self.first_host.items()}
        K = self.K

        def cut(x):
            if self.tile_geom is not None:
                tp = self.tile_geom[1]
                if geom is not None and geom[1] == tp and lo % tp == 0:
                    return x[lo // tp:hi // tp].to(device)
                x = x.transpose(0, 1).reshape(K, self.num_points)
            x = x[:, lo:hi].to(device)                           # [K, n]
            if geom is None:
                return x.contiguous()
            return x.reshape(K, *geom).transpose(0, 1).contiguous()
        b._data = {k: (v.to(device) if k != "pv"
                       else {n: cut(x) for n, x in v.items()})
                   for k, v in self._data.items()}
        return b

    def _point_series(self, name, rows=slice(None)) -> np.ndarray:
        """Spatially-extracted [P, K] float64 series on the host, of the
        raw rows ``rows`` (a slice); the staples' whole series are cached
        (production.py:1105-1125)."""
        if name in self._pv_cache:
            return self._pv_cache[name][:, rows]
        from .io.gridsource import bilinear_at_points, \
            nearest_corner_at_points
        times, glats, glons, fields, plat, plon, _ = self._href
        interp_sp = (nearest_corner_at_points if name == "prec_phase"
                     else bilinear_at_points)
        out = interp_sp(fields[name][rows], glats, glons, plat, plon).T
        if rows == slice(None) and name in self._PV_STAPLES:
            self._pv_cache[name] = out
        return out

    def _host_values(self, sim_abs, names) -> dict:
        """The extraction pipeline on the host at arbitrary epoch times
        (io.gridsource.timeseries_at_points over the per-point series;
        production.py:1127-1144): {name: [P, n]}, missing-filled for
        absent variables.  Only the raw rows within the gap cap of the
        times, and one more on either side, can decide their values (a
        bracketing sample, a nearest one, or none within the cap), so only
        those are extracted: the same values, bit for bit, at a fraction
        of the whole series' cost when the times are few."""
        from .io.gridsource import timeseries_at_points
        times = self._href[0]
        want = set(names) | ({"tair", "tdew", "rhz"} & set(self.var_names))
        sim_abs = np.asarray(sim_abs, np.int64)
        rows = slice(None)
        if sim_abs.size:
            lo = np.searchsorted(times, sim_abs.min() - self.max_gap_s,
                                 side="left")
            hi = np.searchsorted(times, sim_abs.max() + self.max_gap_s,
                                 side="right")
            rows = slice(max(int(lo) - 1, 0), min(int(hi) + 1, len(times)))
            if rows == slice(0, len(times)):
                rows = slice(None)
        pv = {n: self._point_series(n, rows)
              for n in sorted(want & set(self.var_names))}
        out = timeseries_at_points(times[rows], pv, sim_abs, self.max_gap_s)
        for n in names:
            if n not in out:
                out[n] = np.full((self.num_points, len(sim_abs)),
                                 -9999 if n == "prec_phase" else MISSING)
        return out

    def host_at(self, sim_sel, names=("tair", "tdew", "rhz")) -> dict:
        """Host per-point values at selected sim steps (for output writers
        and anchor derivation): {name: [P, n]}."""
        sim = self._href[6]
        return self._host_values(sim[np.asarray(sim_sel)], tuple(names))

    @property
    def device_data(self) -> dict:
        return self._data

    def window(self, t0: int, tc: int) -> RawForcing:
        """[tc, P] raw forcing for global sim steps [t0, t0+tc)."""
        if self.tile_geom is None:
            return self._raw_window(t0, tc, tiled=False)
        out = self._raw_window(t0, tc, tiled=True)
        return RawForcing(*(x.transpose(0, 1).reshape(tc, self.num_points)
                            for x in out))

    def window_tm(self, t0: int, tc: int) -> RawForcing:
        """Raw forcing in the kernel's tile layout, [n_tiles, tc, TP]
        leaves (point p at tile p // TP, lane p % TP): the interpolation
        runs in that layout, so no transpose comes between it and K3."""
        return self._raw_window(t0, tc, tiled=True)

    def window_rows(self, t0: int):
        """(k0, lo) of the window at global step t0: the raw position of
        its first step and its first raw row."""
        k0 = int(self._pos_host[t0])
        return k0, min(max(k0 - self.MB, 0), max(self.K - self.KW, 0))

    def plan(self, t0: int, tc: int) -> "GridPlan":
        """The time-only part of the window of global steps [t0, t0 + tc):
        its raw rows, each step's segment and exact-time flag, each
        segment's rows and prec_phase's picks (production.py:1175-1240).
        The chunk's fused kernel derives the same from ``device_data``
        with ``k0`` and ``lo``."""
        if tc > self.chunk_t:
            raise ValueError(
                f"a {tc}-step window is longer than the expander's chunk of "
                f"{self.chunk_t} steps, which its SPAN was sized for")
        KW, SPAN, K = self.KW, self.SPAN, self.K
        d = self._data
        k0, lo = self.window_rows(t0)
        pos_c = d["pos"][t0:t0 + tc]
        t_r = d["trel"][t0:t0 + tc]
        kgs = [k0 + s for s in range(SPAN)]
        return GridPlan(
            k0=k0, lo=lo, tw=d["trw"][lo:lo + KW],
            s_t=(pos_c - k0).clamp(0, SPAN - 1), trd=t_r - t_r[0],
            tr0=t_r[0], tex=d["tex"][t0:t0 + tc],
            kl=tuple(min(max(kg - lo, 0), KW - 1) for kg in kgs),
            klm1=tuple(min(max(kg - lo - 1, 0), KW - 1) for kg in kgs),
            seg_ok=tuple(0 < kg < K for kg in kgs),
            ex_in=tuple(kg < K for kg in kgs),
            lpos=(pos_c - lo).clamp(0, KW - 1),
            lpick=(d["pick"][t0:t0 + tc] - lo).clamp(0, KW - 1),
            havep=d["havep"][t0:t0 + tc])

    def segments(self, plan: "GridPlan", pvw, ta: int):
        """The segment stage of one channel: ``pvw`` its window's raw rows
        (time on axis ``ta``); returns ``(alpha, beta, ex_v, ex_ok)``, each
        a list of SPAN point-shaped tensors: segment s's line
        ``v(t) = alpha + (t - tr0) * beta`` through the last valid sample
        before its position and the next valid one at or after it within
        the gap cap (missing where there is none), its exact-time sample
        and whether that sample is valid (QueryDataSource.cpp:331-425)."""
        KW, dev = self.KW, self.device
        miss = self._data["miss"]
        row = lambda a, k: a.select(ta, k)            # one raw-time row
        validw = pvw > -9000.0
        pshape = row(pvw, 0).shape
        NEG = torch.tensor(-3e38, dtype=torch.float32, device=dev)
        POS = torch.tensor(3e38, dtype=torch.float32, device=dev)
        tw = plan.tw
        # running last-valid / next-valid (time, value) pairs over the KW
        # window rows (raw times increase: a plain where-carry)
        lv_t, lv_v, nx_t, nx_v = [], [], [None] * KW, [None] * KW
        ct = NEG.expand(pshape)
        cv = torch.zeros(pshape, dtype=torch.float32, device=dev)
        for k in range(KW):
            ct = torch.where(row(validw, k), tw[k], ct)
            cv = torch.where(row(validw, k), row(pvw, k), cv)
            lv_t.append(ct)
            lv_v.append(cv)
        ct = POS.expand(pshape)
        cv = torch.zeros(pshape, dtype=torch.float32, device=dev)
        for k in reversed(range(KW)):
            ct = torch.where(row(validw, k), tw[k], ct)
            cv = torch.where(row(validw, k), row(pvw, k), cv)
            nx_t[k] = ct
            nx_v[k] = cv
        alpha, beta, ex_v, ex_ok = [], [], [], []
        for s in range(self.SPAN):
            kl, klm1 = plan.kl[s], plan.klm1[s]
            t1, v1 = lv_t[klm1], lv_v[klm1]
            t2, v2 = nx_t[kl], nx_v[kl]
            gap = t2 - t1
            have = ((t1 > NEG * 0.5) & (t2 < POS * 0.5)
                    & (gap <= self.max_gap_s) & plan.seg_ok[s])
            invg = torch.where(gap > 0, 1.0 / gap, 0.0)
            b = torch.where(have, (v2 - v1) * invg, 0.0)
            # chunk-rebased intercept: v(t) = alpha + (t - tr0) * beta
            # keeps the f32 cancellation at window scale, not run scale
            alpha.append(torch.where(have, v1 + (plan.tr0 - t1) * b, miss))
            beta.append(b)
            ex_v.append(row(pvw, kl))
            ex_ok.append(row(validw, kl) & plan.ex_in[s])
        return alpha, beta, ex_v, ex_ok

    @staticmethod
    def evaluate(plan: "GridPlan", segs, ta: int):
        """Each step's value from the segment stage: its segment's line at
        the step, or the exact-time valid sample, which overrides
        unconditionally (QueryDataSource.cpp:798-801 / interpolate_gapped).
        One gather on the segment axis picks each step's segment (the JAX
        package's SPAN-way select chain works around a [tc]-indexed take on
        the TPU's scalar core)."""
        alpha, beta, ex_v, ex_ok = segs
        nd = alpha[0].dim() + 1
        tvec = lambda x: x.reshape((1,) * ta + (-1,) + (1,) * (nd - ta - 1))
        pick = lambda xs: torch.stack(xs).index_select(
            0, plan.s_t).movedim(0, ta)           # [SPAN, *p] -> layout
        res = pick(alpha) + tvec(plan.trd) * pick(beta)
        return torch.where(tvec(plan.tex) & pick(ex_ok), pick(ex_v), res)

    def _raw_window(self, t0: int, tc: int, tiled: bool) -> RawForcing:
        """The gap-capped interpolation (production.py:1175-1327) in either
        layout: ``tiled`` works on [n_tiles, *, TP] (series [n_tiles, K,
        TP], time on axis 1), else on [*, P] (series [K, P], time on axis
        0): ``plan``, then for each channel ``segments`` and ``evaluate``,
        prec_phase's nearest pick, the clamps and the Tdew/RH completion.
        Every rule is elementwise over points, so both layouts run the one
        op sequence."""
        plan = self.plan(t0, tc)
        KW, lo = self.KW, plan.lo
        d = self._data
        dev, miss = self.device, d["miss"]
        if tiled:
            ta = 1
            nt, tp = self.tile_geom
            oshape = (nt, tc, tp)
            tvec = lambda x: x.reshape(1, tc, 1)
        else:
            ta = 0
            oshape = (tc, self.num_points)
            tvec = lambda x: x.reshape(tc, 1)

        out = {}
        for name in RawForcing._fields:
            arr = d["pv"].get(name)
            if arr is None:
                out[name] = _missing_like(oshape, name, dev)
                continue
            pvw = arr.narrow(ta, lo, KW)        # the window's raw rows
            if name == "prec_phase":
                validw = pvw > -9000.0
                vex = pvw.index_select(ta, plan.lpos)
                res = torch.where(
                    tvec(plan.tex) & validw.index_select(ta, plan.lpos), vex,
                    torch.where(tvec(plan.havep),
                                pvw.index_select(ta, plan.lpick), miss))
                out[name] = torch.where(res > -9000.0, res,
                                        -9999.0).to(torch.int32)
                continue
            res = self.evaluate(plan, self.segments(plan, pvw, ta), ta)
            if name == "rhz":
                res = torch.where(res > -9000.0, res.clamp(0.0, 100.0), res)
            if name == "prec":
                res = torch.where(res > 100.0, miss, res)
            out[name] = res

        # Tdew <-> RH completion per source (QueryDataSource.cpp:817-828)
        ta_, td, rh = out["tair"], out["tdew"], out["rhz"]
        t_ok = ta_ > -9000.0
        if "tair" in self.var_names:
            from .physics.moisture import rh_from_tdew, tdew_from_rh
            need_td = (td <= -9000.0) & (rh > -9000.0) & t_ok
            need_rh = (rh <= -9000.0) & (td > -9000.0) & t_ok
            out["tdew"] = torch.where(need_td, tdew_from_rh(ta_, rh), td)
            out["rhz"] = torch.where(need_rh, rh_from_tdew(ta_, td), rh)
        return RawForcing(**out)


class GridPlan(NamedTuple):
    """The time-only part of one grid window (``GridExpander.plan``):
    host ints and [tc] device vectors, shared by every point."""
    k0: int              #: raw position of the window's first step
    lo: int              #: first raw row of the window (KW rows)
    tw: torch.Tensor     #: [KW] f32 raw times of the rows
    s_t: torch.Tensor    #: [tc] each step's segment
    trd: torch.Tensor    #: [tc] f32 step time less the window's first
    tr0: torch.Tensor    #: 0-d f32 the window's first step time
    tex: torch.Tensor    #: [tc] the step falls on a raw time
    kl: tuple            #: segment s's row (window-local)
    klm1: tuple          #: the row before it
    seg_ok: tuple        #: 0 < k0 + s < K
    ex_in: tuple         #: k0 + s < K
    lpos: torch.Tensor   #: [tc] prec_phase's exact-time row
    lpick: torch.Tensor  #: [tc] prec_phase's nearest row
    havep: torch.Tensor  #: [tc] a nearest row lies within the gap cap


def sky_route(pts: PointParams):
    """(enable_sky, flat_horizons) of a run: whether any point's sky view
    is active, and whether every horizon is zero (the lookup is then
    skipped and the table never read).  The [P, 360] horizon table is
    scanned only where some sky view is active: with none, nothing reads
    the horizons, and ``flat_horizons`` is True without a look at them."""
    sky = np.asarray(pts.sky_view)
    if not np.any((sky < 1.0) & (sky > -0.01)):
        return False, True
    return True, not np.asarray(pts.horizons).any()


def fused_parts(expander):
    """``(grid, station, grid_last)`` of an expander K3 fused takes: a
    GridExpander, a StationExpander, or a CompositeExpander of at most one
    of each (``grid_last``: the grid part overlays the station part);
    None for any other (it takes the unfused tile-major route)."""
    parts = (expander.parts if isinstance(expander, CompositeExpander)
             else [expander])
    grids = [p for p in parts if isinstance(p, GridExpander)]
    stations = [p for p in parts if isinstance(p, StationExpander)]
    if (len(grids) > 1 or len(stations) > 1
            or len(grids) + len(stations) != len(parts)):
        return None
    g = grids[0] if grids else None
    st = stations[0] if stations else None
    return g, st, bool(g is not None and st is not None and parts[-1] is g)


class FusedChunk:
    """The raw inputs of one chunk of one block for K3 fused (the kernel
    prepares each step's channels from them in registers): ``prepared()``
    is the chunk's eager prep, which the kernel's plain version runs, and
    ``kernel_args()`` the kernel's pointers and numbers."""

    def __init__(self, engine: "_Engine", t0: int):
        self.engine, self.t0 = engine, t0
        self.tc = engine.chunk_t
        self.tile_geom = engine.tile_geom

    def prepared(self) -> Prepared:
        """The tile-layout prep of the chunk (``_Engine.prepare``)."""
        return self.engine.prepare(self.t0, self.tc, tiled=True)

    def kernel_args(self) -> dict:
        args = dict(self.engine.fuse_base)
        grid = self.engine.fused_parts[0]
        if grid is not None:
            args["k0"], args["lo"] = grid.window_rows(self.t0)
        return args


class FusedWindow:
    """The raw inputs of one block's coupling window for K5 fused (the
    kernel prepares each step's channels from them in registers, as K3
    fused does a chunk's): ``table()`` is the window's eager table, which
    the kernel's plain version reads, and ``kernel_args()`` the kernel's
    pointers and numbers.  The table route prepares the window in chunks
    of ``tc`` rows from global row ws-1 (``_Engine.window_table``), and the
    grid evaluates each segment line from its chunk's first step, so the
    kernel is given each window chunk's grid rows (``wrows``)."""

    def __init__(self, engine: "_Engine", span):
        self.engine, self.span = engine, span
        self.tc = tc = engine.window_chunk(span)
        self.tile_geom = engine.tile_geom
        r0, W1 = span.ws - 1, span.rows
        grid = engine.fused_parts[0]
        rows = [grid.window_rows(r0 + k) if grid is not None else (0, 0)
                for k in range(0, W1, tc)]
        self._args = dict(engine.fuse_base, wtc=tc,
                          wrows=torch.tensor(rows, dtype=torch.int32,
                                             device=engine.device),
                          trf=engine.trf_dev[r0:r0 + W1])

    def table(self):
        """The table triple of every point of the block
        (``_Engine.window_table``)."""
        return self.engine.window_table(self.span, 0, self.engine.P_pad)

    def kernel_args(self) -> dict:
        return self._args


class ProductionResult(NamedTuple):
    state: State                 #: final prognostic state (unpadded, host)
    out_steps: np.ndarray        #: [n_out] global 0-based step indices
    fields: dict                 #: name -> [n_out, P_local] numpy
    #: sustained streaming rate over the real points this result covers
    point_steps_per_s: float
    #: global [lo, hi) point range this result covers: the full run in one
    #: process, this process's shard in a run of several (drain="shard")
    point_range: tuple = (0, -1)


class _Engine:
    """Device placement and chunk functions of ONE point block on one
    device (production.py:1340-1800, a device's share of the mesh); a run
    is a list of these (``_Blocks``), one for each block of its devices.

    Routes, in order: the station fast path (``prep_data``, sky view off;
    K2, or K1 with ``slim=False``); the tile-major path for an expander with
    a ``tile_geom``: K3 fused, which prepares each step's forcing in the
    kernel from the raw series (``fused_parts``: a grid, a station source
    or one of each), else the per-point prep in the tile layout into K3
    slim; else the generic path (per-point prep in [Tc, P]; K1).

    Point order: an expander with a ``point_perm`` (a station block) holds
    its points in station order, and the engine places every per-point
    array (params, anchors, packed state) in that order, as
    production.py:1384-1407 does; ``to_caller`` maps a per-point tensor
    back.  Without one, the engine's order is the caller's."""

    #: True sends every run off the fast path down the generic route (the
    #: reference the tile-major route is held to in the tests and on the
    #: card)
    force_generic = False
    #: True runs phase B of a K3 fused route on the window's eager table
    #: (K5, over point slices past ``wcache_bytes``): the reference K5
    #: fused is held to in the tests and on the card
    force_window_table = False

    def __init__(self, model: Model, expander,
                 pts: PointParams, cal: Calendar, state: State, *,
                 anchors=None, chunk_t: int = 64,
                 out_stride: Optional[int] = None,
                 metrics: Optional[RunMetrics] = None,
                 n_real: Optional[int] = None, sky=None):
        """``pts``/``state``/``anchors``: [P_real], padded here to whole
        lanes; or, with ``n_real`` (a block of a sharded run), already at
        the expander's point count, of which the first ``n_real`` are real.
        ``sky``: the run's (enable_sky, flat_horizons), which a block takes
        from all points of the run, not from its own."""
        settings, params, cfg, grid = (model.settings, model.params,
                                       model.cfg, model.grid)
        self.expander = expander
        self.perm = getattr(expander, "point_perm", None)
        self.inv = getattr(expander, "point_inv", None)
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
        # all-zero horizons skip the lookup and never read the table
        self.enable_sky, self.flat_horizons = sky or sky_route(pts)

        if n_real is None:
            self.n_real = int(np.asarray(pts.lat).shape[0])
            self.P_pad = padded_points(self.n_real)
        else:
            self.n_real = int(n_real)
            self.P_pad = int(np.asarray(pts.lat).shape[0])
        if expander.num_points != self.P_pad:
            raise ValueError(f"expander built for {expander.num_points} "
                             f"points, need {self.P_pad}")

        with self.metrics.phase("cycle_setup.place"):
            dev = self.device
            f32 = np.float32

            def put_pts(x, dt):
                x = _pad_tail(np.asarray(x), self.P_pad, axis=0)
                return self.to_engine(torch.tensor(x.astype(dt),
                                                   device=dev), 0)

            # the [P, 360] horizon table (1.5 GB at 1M points) only when
            # sky view reads it; else a 1-wide placeholder
            if self.enable_sky and not self.flat_horizons:
                horizons = put_pts(pts.horizons, f32)
            else:
                horizons = torch.zeros((self.P_pad, 1), dtype=torch.float32,
                                       device=dev)
            self.pts_dev = PointParams(
                lat=put_pts(pts.lat, f32), lon=put_pts(pts.lon, f32),
                sky_view=put_pts(pts.sky_view, f32),
                horizons=horizons,
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
            # the Julian day in float64: the sun's time terms are formed
            # from it before the cast to float32 (physics/sun.py)
            self.jde_dev = (torch.tensor(
                _pad_tail(np.asarray(cal.jde, np.float64), expander.t_pad),
                device=dev) if self.enable_sky else None)

            # packed state; padded points marked failed -> frozen at step 0
            # (production.py:1478-1498)
            def padleaf(x):
                x = torch.as_tensor(x).to(dev)
                n = self.P_pad - x.shape[0]
                if n <= 0:
                    return x
                return torch.cat([x, x[-1:].expand(n, *x.shape[1:])])
            st = State(*(padleaf(x) for x in state))
            tmp0, scal0 = sk.pack_state(st)
            scal0[sk.R_FAILED, self.n_real:] = 1.0
            self.tmp0, self.scal0 = (self.to_engine(tmp0, 1),
                                     self.to_engine(scal0, 1))
            self.template = state

        # station-level prepared channels bypass per-point forcing prep;
        # the per-point sky-view correction cannot ride them
        self.fast = (not self.enable_sky
                     and getattr(expander, "prep_data", None) is not None)
        self.slim = self.fast and expander.slim
        # tile-major: the expander emits raw windows in the kernel's tile
        # layout (production.py:1517-1539)
        self.tile_geom = expander.tile_geom
        self.tile_major = (not self.fast and not self.force_generic
                           and self.tile_geom is not None)
        # K3 fused: the tile-major route of a grid, station or grid +
        # station source prepares its forcing in the kernel
        self.fused_parts = (fused_parts(expander) if self.tile_major
                            else None)
        self.fused = self.fused_parts is not None
        # phase B through K5 fused (no window table)
        self.window_fused = self.fused and not self.force_window_table
        sky_note = ", incl. sky view" if self.enable_sky else ""
        if self.fast:
            self._check_fast_contract(expander, pts)
            self.metrics.note(
                "station-level prepared channels active ("
                + ("slim kernel mode K2" if self.slim
                   else "packed row gather, kernel mode K1") + ")")
        elif self.fused:
            self.metrics.note(
                f"tile-major path with the prep in the kernel{sky_note} "
                "(kernel mode K3 fused)")
        elif self.tile_major:
            self.metrics.note(
                "tile-major forcing path (per-point prep in the kernel's "
                f"tile layout{sky_note}, kernel mode K3)")
        else:
            self.metrics.note("generic per-point forcing prep (kernel mode "
                              f"K1{sky_note})")
        if self.tile_major:
            # per-point params and anchors as views in the tile layout
            # [n_tiles, TP] (horizons [n_tiles, TP, 360] when read), and the
            # time-only traffic friction (SetDayDependendVariables,
            # src/BalanceModel.f90:354-387; production.py:1553-1594)
            tiles = lambda x: _to_tiles(x, self.tile_geom)
            self.pts_tm = PointParams(*(tiles(x) for x in self.pts_dev))
            self.anchors_tm = (tuple(tiles(a) for a in self.anchors_dev)
                               if self.anchors_dev is not None else None)
            prm = self.params
            t32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
            night = ((self.hour_dev >= prm.night_on)
                     | (self.hour_dev <= prm.night_off))
            self.trf_dev = torch.where(night, t32(prm.trf_fric_ngt),
                                       t32(prm.trf_fric_day))
        if self.fused:
            self.fuse_base = self._fuse_base()
        # fixed output-row allocation: the most stride hits any chunk holds
        self.k_alloc = (chunk_t - 1) // self.os_ + 1
        if self.device.type == "cuda":
            from .ops import build
            with self.metrics.phase("cycle_setup.build"):
                build.load()

    def _fuse_base(self) -> dict:
        """The chunk-invariant FuseArgs of this block (``ops.scan_kernel.
        fuse_args``): its grid part's tile rows and time machinery, its
        station part's series and index, its per-point parameters in the
        engine's order, the time-only hour and sun terms and the prep's
        settings."""
        grid, st, grid_last = self.fused_parts
        settings, prm = self.settings, self.params
        pts = self.pts_dev
        base = dict(
            g={}, s={}, has_grid=int(grid is not None),
            has_station=int(st is not None), grid_last=int(grid_last),
            lat=pts.lat, lon=pts.lon, sky=pts.sky_view, hor=pts.horizons,
            hor_w=pts.horizons.shape[1], init_len=pts.init_len,
            cstart=pts.coupling_start, cend=pts.coupling_end,
            tr_relax=pts.tair_relax, vz_relax=pts.vz_relax,
            rh_relax=pts.rh_relax, ctsurf=pts.coupling_tsurf,
            hour=self.hour_dev.to(torch.int32), t_total=self.T,
            relax=int(settings.use_relaxation),
            coupling=int(settings.use_coupling),
            force_tsurf=int(settings.force_tsurf),
            sky_on=int(self.enable_sky), flat_hor=int(self.flat_horizons),
            calm_ngt=prm.calm_lim_ngt, calm_day=prm.calm_lim_day,
            night_on=prm.night_on, night_off=prm.night_off,
            min_prec=prm.min_prec_mm, p_snow=prm.p_lim_snow,
            p_rain=prm.p_lim_rain, p_snow_d=prm.p_lim_snow,
            p_rain_d=prm.p_lim_rain, miss_i=prm.miss_val_i,
            alb_sur=prm.albedo_surroundings, dt=settings.dt,
            dt_f=settings.dt)
        if self.anchors_dev is not None:
            base.update(anc_t=self.anchors_dev[0], anc_v=self.anchors_dev[1],
                        anc_r=self.anchors_dev[2])
        if self.enable_sky:
            # the sun's time terms from the float64 day, then float32
            sun = torch.stack(sun_time_terms(self.jde_dev))
            base.update(sun=sun.to(torch.float32).contiguous(),
                        sun_stride=sun.shape[1])
        if grid is not None:
            d = grid.device_data
            base.update(
                g=dict(d["pv"]), trw=d["trw"], trel=d["trel"],
                pos=d["pos"].to(torch.int32), pick=d["pick"].to(torch.int32),
                tex=d["tex"], havep=d["havep"], K=grid.K, KW=grid.KW,
                span=grid.SPAN, complete=int("tair" in grid.var_names),
                max_gap=grid.max_gap_s)
        if st is not None:
            base.update(
                s=dict(zip(RawForcing._fields, st.channels)),
                sidx=st.st_idx, sok=st.ok, s_tpad=st.t_pad)
        return base

    def to_engine(self, x, dim: int):
        """A per-point tensor (points on ``dim``) from the caller's order
        into the engine's."""
        return x if self.perm is None else x.index_select(dim, self.perm)

    def to_caller(self, x, dim: int):
        """A per-point tensor (points on ``dim``) from the engine's order
        back into the caller's."""
        return x if self.inv is None else x.index_select(dim, self.inv)

    def rows_to_caller(self, rows, n_rows: int):
        """Output rows ``rows[:n_rows, :6]`` ([k, F, P]) in the caller's
        point order as a tensor of their own, contiguous: the drain copies
        it to the host while the launches write ``rows`` again."""
        x = rows[:n_rows, :6]
        return (x.index_select(2, self.inv) if self.inv is not None
                else x.clone(memory_format=torch.contiguous_format))

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
        got = lambda n: np.asarray(getattr(pts, n),
                                   np.float64)[:self.n_real]

        def fail(check, mask, *names):
            """Raise at the first point of ``mask`` where ``check`` fails,
            with the point's values of the fields ``names`` it reads (a
            joint check reads several) and its station row's."""
            bad = int(np.argmax(mask))
            vals = lambda f: ", ".join(f"{n} {f(n)[bad]!r}" for n in names)
            raise ValueError(
                f"station-level fast path contract violated at point {bad} "
                f"({check}: per-point {vals(got)} vs st_pts[{sidx[bad]}] "
                f"{vals(gat)}); the prep_ctx expander requires param i == "
                f"st_pts[st_idx[i]] for every prep-relevant field (build "
                f"pts by gathering st_pts, or drop prep_ctx to use the "
                f"generic path)")

        if not np.array_equal(gat("init_len"), got("init_len")):
            fail("init_len", gat("init_len") != got("init_len"), "init_len")
        # relaxation validity is joint over the three fields; where OFF on
        # both sides the raw sentinels may differ
        def relax_on(t, v, r):
            return ((t >= -100.0) & (t <= 100.0) & (v >= 0.0) & (v <= 100.0)
                    & (r >= 0.0) & (r <= 110.0))
        names = ("tair_relax", "vz_relax", "rh_relax")
        on_w = relax_on(*(gat(n) for n in names))
        on_g = relax_on(*(got(n) for n in names))
        if not np.array_equal(on_w, on_g):
            fail("relax validity", on_w != on_g, *names)
        for n in names:
            bad = on_w & (gat(n).astype(got(n).dtype) != got(n))
            if bad.any():
                fail(n, bad, n)
        # coupling activity (prepare_window's coupling flags)
        def cpl_on(end, obs):
            return (end >= 1) & (obs > -100.0)
        cw = cpl_on(gat("coupling_end"), gat("coupling_tsurf"))
        cg = cpl_on(got("coupling_end"), got("coupling_tsurf"))
        if not np.array_equal(cw, cg):
            fail("coupling activity", cw != cg, "coupling_end",
                 "coupling_tsurf")
        for n in ("coupling_start", "coupling_end", "coupling_tsurf"):
            bad = cw & (gat(n).astype(got(n).dtype) != got(n))
            if bad.any():
                fail(n, bad, n)

    # -- chunk functions ----------------------------------------------------

    def prepare(self, t0: int, tc: int, tiled: bool = False,
                points=None) -> Prepared:
        """Per-point forcing prep of global steps [t0, t0 + tc) from the
        expander's raw window: [tc, P] leaves, or with ``tiled`` the tile
        layout [n_tiles, tc, TP] (production.py:1668-1700, 1717-1726).
        ``points``: a point slice's (expander, pts, anchors), from
        :meth:`point_slice`, prepared alone ([tc, n] leaves)."""
        if tiled:
            raw = self.expander.window_tm(t0, tc)
            pts, anchors = self.pts_tm, self.anchors_tm
        else:
            exp, pts, anchors = points or (self.expander, self.pts_dev,
                                           self.anchors_dev)
            raw = exp.window(t0, tc)
        return prepare_window(
            raw, pts, self.hour_dev[t0:t0 + tc], self.settings, self.params,
            t_offset=t0, t_total=self.T, anchors=anchors,
            jde=self.jde_dev[t0:t0 + tc] if self.enable_sky else None,
            enable_skyview=self.enable_sky,
            flat_horizons=self.flat_horizons, time_axis=1 if tiled else 0)

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
        prep = self.prepare(t0, tc)
        if cofs is None:
            swc = lwc = torch.ones(prep.tair.shape, dtype=torch.float32,
                                   device=self.device)
        return sk.pack_forcing(prep, swc, lwc, self.obs_dev)

    def kernel_inputs(self, t0: int, cofs=None):
        """(forcing, slim keyword arguments of ``scan``) for the chunk at
        t0: the slim forcing with the time-only TRF and the aux rows (the
        coupling obs, and with ``cofs`` the corrections and window ends of
        the in-kernel decay, production.py:1755-1766) when the engine runs
        K3 fused (a ``FusedChunk`` of the chunk's raw inputs), K3 (the
        tile-major prep, for a composite K3 fused does not take) or K2 (the
        station window), else K1's packed forcing."""
        if self.fused:
            forc = FusedChunk(self, t0)
            trf = self.trf_dev
        elif self.tile_major:
            forc = sk.pack_forcing_slim_tm(
                self.prepare(t0, self.chunk_t, tiled=True))[0]
            trf = self.trf_dev
        elif self.slim:
            forc = self.expander.slim_window(t0, self.chunk_t)
            trf = self.expander.prep_data["trf"]
        else:
            return self.chunk_forcing(t0, cofs), {}
        kw = dict(slim_trf=trf, aux_rows=sk.pack_aux(self.obs_dev))
        if cofs is not None:
            kw.update(aux_rows=sk.pack_aux(self.obs_dev, cofs[0], cofs[1],
                                           self.pts_dev.coupling_end),
                      aux_cofs=True, t_total=self.T,
                      cof_red=self.settings.coupling_effect_reduction)
        return forc, kw

    def point_slice(self, lo: int, hi: int):
        """(expander, pts, anchors) of this block's points [lo, hi) for
        :meth:`prepare`: the expander's block of them (views of its point
        data where the slice holds whole tiles of its layout) and the
        per-point arrays cut to them; this block's own for all of them."""
        if (lo, hi) == (0, self.P_pad):
            return self.expander, self.pts_dev, self.anchors_dev
        cut = lambda xs: [x[lo:hi] for x in xs]
        return (self.expander.block(lo, hi, self.device),
                PointParams(*cut(self.pts_dev)),
                None if self.anchors_dev is None
                else tuple(cut(self.anchors_dev)))

    def window_chunk(self, span) -> int:
        """The rows of each chunk the window of ``span`` is prepared in
        (``window_table``), the most the expander's chunk allows."""
        return min(self.chunk_t, span.we_b - span.ws + 1)

    def window_input(self, span, lo: int, hi: int):
        """K5's forcing of this block's points [lo, hi) over the window
        ``span``: a ``FusedWindow`` (every point) where phase B runs K5
        fused, else ``window_table``'s."""
        if self.window_fused:
            return FusedWindow(self, span)
        return self.window_table(span, lo, hi)

    def window_table(self, span, lo: int, hi: int):
        """K5's forcing table of this block's points [lo, hi) over the window
        ``span`` (``ops.window_kernel.WindowSpan``): (table [W+1, NCH, R],
        fidx [hi - lo] int32, trf [W+1]).  On the station fast path the
        station-rank prepared channels of the window's rows (a view, R =
        S + 1) at each point's station row; on every other route the
        prepared window of these points alone (``prepare``, sky view
        included, chunk by chunk; R = hi - lo, fidx the identity)."""
        W1, r0 = span.rows, span.ws - 1
        if self.fast:
            pd = self.expander.prep_data
            return (pd["stf"][r0:r0 + W1],
                    pd["sidx"][lo:hi].to(torch.int32).contiguous(),
                    pd["trf"][r0:r0 + W1])
        tc = self.window_chunk(span)
        points = self.point_slice(lo, hi)
        table = torch.empty((W1, sk.NCH, hi - lo), dtype=torch.float32,
                            device=self.device)
        trf = torch.empty(W1, dtype=torch.float32, device=self.device)
        for k0 in range(0, W1, tc):
            m = min(tc, W1 - k0)
            prep = self.prepare(r0 + k0, tc, points=points)
            part = Prepared(*(x[:m] for x in prep[:-1]),
                            trf_fric=prep.trf_fric[:m])
            wk.table_rows(part, table[k0:k0 + m])
            trf[k0:k0 + m] = part.trf_fric
        return (table, torch.arange(hi - lo, dtype=torch.int32,
                                    device=self.device), trf)

    def scan_kwargs(self, t0: int, nsteps: int) -> dict:
        """The chunk geometry of the launch at global step t0."""
        return dict(out_stride=self.os_, nsteps=nsteps, out_offset=t0,
                    n_out=self.k_alloc)


def _rows(x, lo: int, hi: int, n_real: int):
    """Rows [lo, hi) of ``x`` (numpy or tensor) edge-padded past its
    ``n_real`` rows: a view where the range holds no padding."""
    if hi <= n_real:
        return x[lo:hi]
    idx = np.minimum(np.arange(lo, hi), n_real - 1)
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)]
    return np.asarray(x)[idx]


def _run_devices(devices, expander_device):
    """The device list of a run: ``devices``, or for None every visible
    CUDA device (an error where there is none), except that an expander the
    caller built on the CPU runs there, as one block."""
    from .parallel import sharding
    if devices is None and torch.device(expander_device).type == "cpu":
        devices = [expander_device]
    return sharding.make_mesh(devices)


class _Blocks:
    """The point blocks of one run and its streamed loop (production.py:
    1802-1930 over the mesh): one ``_Engine`` for each block of this
    process's devices, every chunk of every block through ONE sharded
    launch (K4, ``parallel.sharding.scan_sharded``), each block's work
    issued on its own stream, each block's output rows drained to the
    host through its copy stream, ``PIPELINE_DEPTH`` chunks in flight.

    The points are padded to ``padded_points(n_real, blocks of all
    processes)`` and cut into equal contiguous blocks; process ``i`` of
    ``n`` owns blocks ``[i * ndev, (i + 1) * ndev)`` for its ``ndev``
    devices.  ``pts``, ``state`` and ``anchors`` cover ALL points on the
    host in every process (the coupling window and the route are the whole
    run's); device data exists only for this process's blocks.  Padded
    points are marked failed and may fill whole blocks."""

    def __init__(self, model: Model, expander, pts: PointParams,
                 cal: Calendar, state: State, *, anchors=None, devices=None,
                 chunk_t: int = 64, out_stride: Optional[int] = None,
                 metrics: Optional[RunMetrics] = None,
                 drain: str = "gather"):
        from .parallel import distributed
        if drain not in ("gather", "shard"):
            raise ValueError(f"drain must be 'gather' or 'shard', got "
                             f"{drain!r}")
        nproc, pid = distributed.process_count(), distributed.process_index()
        if nproc > 1 and drain != "shard":
            raise ValueError(
                "a run of several processes drains per process (no tensor "
                "crosses between them): pass drain='shard'")
        self.metrics = metrics = metrics or RunMetrics()
        self.mesh = mesh = _run_devices(devices, expander.device)
        self.model, self.T = model, model.settings.sim_len
        self.chunk_t = chunk_t
        ndev = len(mesh)
        self.n_real = n_real = int(np.asarray(pts.lat).shape[0])
        self.P_pad = padded_points(n_real, ndev * nproc)
        if expander.num_points != self.P_pad:
            raise ValueError(
                f"expander built for {expander.num_points} points, need "
                f"{self.P_pad} ({n_real} padded to {ndev * nproc} blocks "
                f"of whole {LANE}-point lanes)")
        per = self.P_pad // (ndev * nproc)
        with metrics.phase("cycle_setup.sky_route"):
            sky = sky_route(pts)
        # the route reads the horizon table only where sky view is on
        metrics.add("horizon_table_scans", int(sky[0]))
        self.engines, self.ranges = [], []
        for b in range(ndev):
            lo = (pid * ndev + b) * per
            cut = lambda x: _rows(x, lo, lo + per, n_real)
            with mesh.scope(b):
                with metrics.phase("cycle_setup.blocks"):
                    block = station_sorted(
                        expander.block(lo, lo + per, mesh.devices[b]))
                eng = _Engine(
                    model, block, PointParams(*(cut(x) for x in pts)), cal,
                    State(*(cut(x) for x in state)),
                    anchors=(tuple(cut(np.asarray(a)) for a in anchors)
                             if anchors is not None else None),
                    chunk_t=chunk_t, out_stride=out_stride, metrics=metrics,
                    n_real=max(0, min(lo + per, n_real) - lo), sky=sky)
            self.engines.append(eng)
            self.ranges.append((lo, lo + per))
        self.os_ = self.engines[0].os_
        # the drain's state of each block: its two output sets (made at the
        # first launch), a copy stream on the card, a ring of staging
        # buffers keyed by (block, slot)
        self._outs = [None] * ndev
        self._copy = [torch.cuda.Stream(device=d) if d.type == "cuda"
                      else None for d in mesh.devices]
        self._stage, self._n_queued = {}, 0
        #: chunks issued so far in this run: the next chunk's index
        self._n_issued = 0
        # blocks issue on their own streams: order them after the set-up
        for d in {d for d in mesh.devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    def __len__(self):
        return len(self.engines)

    def scopes(self):
        """(block index, engine) with the block's device and stream
        current."""
        for b, eng in enumerate(self.engines):
            with self.mesh.scope(b):
                yield b, eng

    def carry0(self):
        """The packed initial state [(tmp, scal)] of every block."""
        return [(e.tmp0, e.scal0) for e in self.engines]

    def synchronize(self):
        self.mesh.synchronize()

    def chunks(self, t_lo: int, t_hi: int):
        """[(t0, steps, output steps)] of a stream over global steps
        [t_lo, t_hi), at the global-offset output cadence (production.py:
        1844-1846)."""
        grid = []
        for t0 in range(t_lo, t_hi, self.chunk_t):
            nsteps = min(self.chunk_t, t_hi - t0)
            first_hit = -(-t0 // self.os_) * self.os_
            grid.append((t0, nsteps,
                         list(range(first_hit, t0 + nsteps, self.os_))))
        return grid

    def row_plan(self, t_lo: int, t_hi: int) -> list:
        """The output steps of each drain of a stream over [t_lo, t_hi)
        that holds any (``_HostRows``' plan)."""
        return [s for _, _, s in self.chunks(t_lo, t_hi) if s]

    def _out_set(self, b: int, eng, tmp):
        """Block ``b``'s output set (tmp, scal, rows) for a launch that
        reads the profile ``tmp``: the block keeps two and the launches
        alternate between them (the kernel reads tmp0 and writes tmp, so
        they cannot be one).  Made on the block's stream at first use."""
        if self._outs[b] is None:
            self._outs[b] = [(
                torch.empty_like(eng.tmp0), torch.empty_like(eng.scal0),
                torch.empty((eng.k_alloc, sk.N_OUT_FIELDS, eng.P_pad),
                            dtype=torch.float32, device=eng.device))
                for _ in range(2)]
        first, second = self._outs[b]
        return second if first[0] is tmp else first

    def _staging(self, b: int, slot: int, shape):
        """A host buffer of ``shape`` from block ``b``'s ring (pinned where
        the block is on the card), grown where it is too small."""
        need = int(np.prod(shape))
        buf = self._stage.get((b, slot))
        if buf is None or buf.numel() < need:
            buf = torch.empty(need, dtype=torch.float32,
                              pin_memory=self._copy[b] is not None)
            self._stage[(b, slot)] = buf
        return buf[:need].view(shape)

    def _ids(self, chunk=None) -> dict:
        """A span's ids: the cycle's index and, where given, the chunk's."""
        ids = {"cycle": self.metrics.cycles - 1}
        if chunk is not None:
            ids["chunk"] = chunk
        return ids

    def host_rows(self, plan) -> "_HostRows":
        """This process's host rows of a run whose drains hold ``plan``."""
        with self.metrics.phase("cycle_setup.host_rows"):
            return _HostRows(plan, self.ranges, self.n_real)

    def _queue(self, rows, n_rows: int, out: "_HostRows", k, chunk=None):
        """Queue the output rows ``rows[b][:n_rows]`` of every block for the
        host as drain ``k`` of ``out`` (None: the chunk has no output row).
        Each block's rows are put in the caller's order on its device and
        copied into a staging buffer of the ring: on the card
        ``non_blocking`` on the block's copy stream, ordered after the launch
        by an event, the copied tensor recorded on the copy stream so the
        allocator keeps it until the copy has read it; on the CPU at once.
        A block with nothing to copy records an event on its stream, the
        drain's back-pressure (production.py:1840).  Returns the pending
        item: (k, [(staged rows or None, event or None)] per block, the
        chunk's index or None)."""
        slot = self._n_queued % PIPELINE_DEPTH
        self._n_queued += 1
        staged = []
        for b, eng in self.scopes():
            cs = self._copy[b]
            ev = torch.cuda.Event() if cs is not None else None
            if k is None or out.cols[b][1] == 0:
                if ev is not None:
                    ev.record()
                staged.append((None, ev))
                continue
            src = eng.rows_to_caller(rows[b], n_rows)
            buf = self._staging(b, slot, src.shape)
            if cs is None:
                buf.copy_(src)
            else:
                ev.record()
                cs.wait_event(ev)
                with torch.cuda.stream(cs):
                    buf.copy_(src, non_blocking=True)
                src.record_stream(cs)
                ev = torch.cuda.Event()
                ev.record(cs)
            staged.append((buf, ev))
        return k, staged, chunk

    def _drain(self, item, out: "_HostRows"):
        """Wait for a queued item's events, one block after the other, and
        copy each block's staged rows to their place in ``out``: the spans
        ``stream.drain.wait`` and ``stream.drain.rows`` (their seconds also
        in the counters ``stream_wait_s`` and ``stream_rows_s``), the bytes
        copied in ``stream_rows_bytes``."""
        k, staged, chunk = item
        ids = self._ids(chunk)
        metrics = self.metrics
        for b, (buf, ev) in enumerate(staged):
            with metrics.phase("stream.drain.wait", "stream_wait_s", **ids):
                if ev is not None:
                    ev.synchronize()
            with metrics.phase("stream.drain.rows", "stream_rows_s", **ids):
                if buf is not None:
                    metrics.add("stream_rows_bytes", out.put(k, b, buf))
        if k is not None:
            out.done += 1

    def drain_rows(self, rows, n_rows: int, out: "_HostRows", steps):
        """Drain the output rows ``rows[b][:n_rows]`` of every block (phase
        B's) to their steps in ``out`` now, through the stream's path."""
        self._drain(self._queue(rows, n_rows, out, out.claim(steps)), out)

    def _issue(self, carry, t0: int, nsteps: int, steps, out: "_HostRows",
               cofs):
        """Issue the chunk at global step t0 on every block (the span
        ``stream.issue``, its seconds also in the counter
        ``stream_issue_s``): its forcing on the block's stream, one sharded
        launch into the blocks' alternate output sets, its rows queued for
        the host.  Returns (the carry after the chunk, the pending item of
        ``_queue``)."""
        from .parallel import sharding
        model = self.model
        chunk = self._n_issued
        self._n_issued += 1
        with self.metrics.phase("stream.issue", "stream_issue_s",
                                **self._ids(chunk)):
            inputs = [eng.kernel_inputs(t0, cofs[b] if cofs else None)
                      for b, eng in self.scopes()]
            forc, kws = [i[0] for i in inputs], [i[1] for i in inputs]
            kw = dict(kws[0])
            for name in ("slim_trf", "aux_rows"):
                if name in kw:
                    kw[name] = [k[name] for k in kws]
            outs = [self._out_set(b, eng, carry[b][0])
                    for b, eng in self.scopes()]
            res = sharding.scan_sharded(
                [c[0] for c in carry], [c[1] for c in carry], forc,
                model.cfg, model.params, model.grid, self.mesh, fence=False,
                out=outs, **self.engines[0].scan_kwargs(t0, nsteps), **kw)
            # the chunk's forcing goes as soon as its launch is issued: it
            # was made on each block's stream, which reuses the room only
            # after the launch
            del inputs, forc, kws, kw
            item = self._queue([r[2] for r in res], len(steps), out,
                               out.claim(steps) if steps else None, chunk)
        self.metrics.add("stream_chunks", 1)
        return [(r[0], r[1]) for r in res], item

    def stream(self, carry, t_lo: int, t_hi: int, out: "_HostRows",
               cofs=None, progress: Optional[Progress] = None):
        """Stream global forcing rows [t_lo, t_hi) through the kernel with
        ``PIPELINE_DEPTH``-deep pipelined dispatch (production.py:
        1826-1856): for each chunk the host issues every block's forcing on
        its stream, launches all blocks in one sharded call into their
        alternate output sets and queues their rows (``_queue``); only then
        does it drain the chunk issued ``PIPELINE_DEPTH - 1`` before, its
        rows landing in ``out`` while the card runs the later chunks.  Every
        chunk is drained when it returns.  ``carry``: [(tmp, scal)] per
        block; ``cofs``: optional [(sw_corr, lw_corr)] per block, [P_b]
        tensors enabling the post-window coefficient decay.  Returns the
        carry."""
        pending = []
        for t0, nsteps_c, steps in self.chunks(t_lo, t_hi):
            carry, item = self._issue(carry, t0, nsteps_c, steps, out, cofs)
            pending.append((item, nsteps_c))
            while len(pending) >= PIPELINE_DEPTH:
                item, n = pending.pop(0)
                self._drain(item, out)
                if progress:
                    progress.update(n)
        for item, n in pending:
            self._drain(item, out)
            if progress:
                progress.update(n)
        return carry

    def run_uncoupled(self, out: "_HostRows",
                      progress: Optional[Progress] = None):
        """Stream every step [0, T) into ``out`` (``host_rows`` of
        ``row_plan(0, T)``) and assemble the result."""
        with self.metrics.phase("stream"):
            t_start = timelib.perf_counter()
            carry = self.stream(self.carry0(), 0, self.T, out,
                                progress=progress)
            self.synchronize()
            wall = timelib.perf_counter() - t_start
        return self.assemble(out, carry, wall)

    def assemble(self, out: "_HostRows", carry, wall: float
                 ) -> ProductionResult:
        """The result: the final state on the host, the counters, and the
        output rows the stream has already put in step order."""
        with self.metrics.phase("output"):
            # a padding-only range (every point >= n_real) anchors its
            # empty range at n_real, so the ranges of all processes still
            # tile [0, n_real) exactly for merge_shards
            lo = self.ranges[0][0]
            n_loc = max(0, min(self.ranges[-1][1], self.n_real) - lo)
            lo_eff = min(lo, self.n_real)

            nlayers = self.model.grid.nlayers
            leaves = []
            for b, eng in self.scopes():
                tmp, scal = (eng.to_caller(x, 1) for x in carry[b])
                ust = sk.unpack_state(tmp, scal, nlayers, eng.template)
                leaves.append([x.cpu() for x in ust])
            final = State(*(
                torch.from_numpy(host_shard(
                    list(zip(xs, self.ranges)), axis=0)[0][:n_loc])
                for xs in zip(*leaves)))

            rate = n_loc * self.T / wall
            self.metrics.count("point_steps_per_s", round(rate, 1))
            self.metrics.count("points", n_loc)
            self.metrics.count("steps", self.T)
            self.metrics.count("blocks", len(self))
            self.metrics.count("pipeline_depth", PIPELINE_DEPTH)
            for d in sorted({d for d in self.mesh.devices
                             if d.type == "cuda"}, key=str):
                self.metrics.count(f"peak_device_bytes_{d}",
                                   torch.cuda.max_memory_allocated(d))
        return ProductionResult(state=final, out_steps=out.steps,
                                fields=out.fields(), point_steps_per_s=rate,
                                point_range=(lo_eff, lo_eff + n_loc))


class _HostRows:
    """The output rows of a run on the host, [n_rows, 6, n_loc] in step
    order, this process's columns only, filled as each drain lands (the
    reference writes disjoint rows into one shared object the same way,
    examples/example2/src/QueryDataTools.cpp:299-345).  ``plan`` lists the
    steps of every drain of the run in the order the drains come (each
    chunk that holds an output step, phase B's rows), which is step order,
    so each drain's destination rows are known before the stream starts;
    ``claim`` hands out the next drain's index, ``put`` copies one block's
    rows of it."""

    def __init__(self, plan, ranges, n_real: int):
        lo = ranges[0][0]
        n_loc = max(0, min(ranges[-1][1], n_real) - lo)
        self.plan = [list(s) for s in plan]
        self.steps = np.asarray([s for steps in self.plan for s in steps],
                                np.int64)
        if np.any(np.diff(self.steps) <= 0):
            raise ValueError("the drains' steps are not in step order")
        cuts = np.cumsum([0] + [len(s) for s in self.plan])
        self.dest = [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
        # a torch tensor: its copies run on torch's intra-op threads (the
        # first touch of each page is most of their time)
        self.rows = torch.empty((len(self.steps), 6, n_loc),
                                dtype=torch.float32)
        #: each block's first column here and its count of real points
        self.cols = [(b_lo - lo, max(0, min(b_hi, n_real) - b_lo))
                     for b_lo, b_hi in ranges]
        self.claimed = self.done = 0

    def claim(self, steps) -> int:
        """The index of the next drain, which must hold ``steps``."""
        k = self.claimed
        if k >= len(self.plan) or list(steps) != self.plan[k]:
            raise RuntimeError(f"drain {k} holds steps {list(steps)}, the "
                               f"run's plan {self.plan[k:k + 1]}")
        self.claimed += 1
        return k

    def put(self, k: int, b: int, part: torch.Tensor) -> int:
        """Block ``b``'s rows [n, 6, P_b] (a host tensor) of drain ``k``
        into place; returns the bytes copied."""
        c0, n_b = self.cols[b]
        src = part[:, :, :n_b]
        self.rows[self.dest[k], :, c0:c0 + n_b].copy_(src)
        return src.numel() * src.element_size()

    def fields(self) -> dict:
        """{field: [n_rows, n_loc]} views, once every drain has landed."""
        if self.done != len(self.plan):
            raise RuntimeError(f"{self.done} of {len(self.plan)} drains "
                               f"landed")
        return {name: self.rows[:, r].numpy()
                for name, r in OUT_FIELD_ROWS.items()}


def run_production(model: Model, expander,
                   pts: PointParams, cal: Calendar, state: State, *,
                   anchors=None, devices=None, chunk_t: int = 64,
                   out_stride: Optional[int] = None,
                   metrics: Optional[RunMetrics] = None,
                   progress: Optional[Progress] = None,
                   drain: str = "gather") -> ProductionResult:
    """Run the full (uncoupled) forecast through the streamed, sharded
    whole-scan kernel (production.py:1933-1963).

    pts/state: [P_real] on the host, ALL points of the run in every
    process (padded internally to the blocks x 128-point lanes multiple,
    ``padded_points(P_real, blocks)``; the expander must already be built
    at the padded count).  anchors: the per-point relaxation anchor triple
    (forcing.relax_anchors), required when settings.use_relaxation.
    Returns outputs at the global ``out_stride`` cadence (default
    settings.output_stride).  The expander is a StationExpander,
    GridExpander or CompositeExpander.

    ``devices`` (the JAX package's ``mesh``): one entry for each point
    block of this process; a device named several times runs its blocks on
    streams of their own.  None means every visible CUDA device; only an
    expander built on the CPU runs there (one block).  CUDA runs the
    kernel, CPU its plain version.  ``drain``: ``"gather"`` returns all
    points (one process); ``"shard"`` this process's columns with their
    ``point_range`` (the only mode in a run of several processes,
    ``parallel.distributed``).

    ``metrics`` gets the call's spans (module docstring, "Spans").
    """
    metrics = metrics or RunMetrics()
    with metrics.cycle():
        with metrics.phase("cycle_setup"):
            run = _Blocks(model, expander, pts, cal, state, anchors=anchors,
                          devices=devices, chunk_t=chunk_t,
                          out_stride=out_stride, metrics=metrics,
                          drain=drain)
            out = run.host_rows(run.row_plan(0, run.T))
        return run.run_uncoupled(out, progress)


#: the most point slices a block's window runs in (``window_slices``):
#: a slice holds at least 1/16 of the block, whatever the budget
WINDOW_SLICES_MAX = 16


def window_slices(run: "_Blocks", span, budget: float) -> list:
    """The point ranges [lo, hi) of each block's K5 launches (block-local):
    one range where the window tables of a device's blocks fit
    ``budget`` bytes together, else equal slices whose tables fit it, at
    most ``WINDOW_SLICES_MAX`` a block, each of whole lanes (of whole
    tiles of the expander's layout where a slice holds one, so that its
    block of the expander is a view).  A table is [W+1, NCH, R] float32,
    R the slice's points; the station fast path's is a view of the
    station-rank channels and counts nothing, and K5 fused reads none:
    those blocks take one range whatever the budget."""
    no_table = lambda eng: eng.fast or eng.window_fused
    table_bytes = lambda eng: (0 if no_table(eng) else
                               4 * sk.NCH * span.rows * eng.P_pad)
    per_dev = {}
    for eng, d in zip(run.engines, run.mesh.devices):
        per_dev[d] = per_dev.get(d, 0) + table_bytes(eng)
    out = []
    for eng, d in zip(run.engines, run.mesh.devices):
        if no_table(eng):
            out.append([(0, eng.P_pad)])
            continue
        lanes = eng.P_pad // LANE
        n_sl = (1 if per_dev[d] <= budget else
                min(lanes, WINDOW_SLICES_MAX,
                    -(-per_dev[d] // max(int(budget), 1))))
        width = -(-lanes // n_sl) * LANE
        tp = eng.tile_geom[1] if eng.tile_geom else LANE
        if width >= tp:
            width = -(-width // tp) * tp
        out.append([(lo, min(lo + width, eng.P_pad))
                    for lo in range(0, eng.P_pad, width)])
    return out


def run_production_coupled(model: Model, expander,
                           pts: PointParams, cal: Calendar, state: State, *,
                           anchors=None, devices=None, chunk_t: int = 64,
                           out_stride: Optional[int] = None,
                           metrics: Optional[RunMetrics] = None,
                           progress: Optional[Progress] = None,
                           wcache_bytes: float = 4e9,
                           drain: str = "gather") -> ProductionResult:
    """Coupled production run: streamed kernel phases around the
    coupling window, as one program on each block's device
    (production.py:1966-2129).

    Phase split (1-based steps; ws/we_b from the coupling windows of ALL
    points of the run, whatever the blocks and processes):
      A [1, ws-1]    streamed kernel, coefficients 1
      B [ws, we_b]   per block: one launch of the window kernel K5
                     (``ops.window_kernel.window``) on the block's device
                     and stream, every point running its own first pass,
                     re-runs and tail (``coupling.run_window_passes``'s
                     semantics); K5 fused on the routes whose phases A
                     and C run K3 fused (the window's forcing prepared in
                     the kernel, ``FusedWindow``); the plain version on
                     the CPU
      C [we_b+1, T]  streamed kernel with the post-window coefficient decay
                     (in kernel on K2 and K3, cof_window channels on K1)

    With no coupled window the run is the uncoupled stream.  ``devices``
    and ``drain`` as in :func:`run_production`.
    ``wcache_bytes``: memory budget PER DEVICE for K5's forcing tables
    (``_Engine.window_table``, built once a block from the route's
    provider and read by every pass; the station fast path's is a view
    and counts nothing, and K5 fused reads none); where a device's tables
    exceed it, each block runs K5 over point slices whose tables fit, at
    most ``WINDOW_SLICES_MAX`` (the same values either way: the points are
    independent, and each slice prepares its own points' window alone).
    Phase B syncs with the host once a block, to read its counts.
    Counters (this process's blocks): coupling_window_steps (W),
    coupling_reruns (the most rewinds of any point), coupling_window_rows
    (the steps of each block's slowest lane, summed over blocks),
    coupling_window_cached (1 where every block ran one launch: its table
    fit, it had none, or it reads a view) and the coupled / succeeded /
    failed point counts; summed over calls, coupling_reruns_total (every
    point's rewinds), coupling_window_point_steps (every point's window
    steps) and coupling_window_lane_steps (the steps K5's warps run,
    ``_window_counts``); phases phase_a/phase_b/phase_c.  ``metrics`` gets
    the call's spans (module docstring, "Spans").
    """
    from .coupling import window_span

    metrics = metrics or RunMetrics()
    with metrics.cycle():
        with metrics.phase("cycle_setup"):
            run = _Blocks(model, expander, pts, cal, state, anchors=anchors,
                          devices=devices, chunk_t=chunk_t,
                          out_stride=out_stride, metrics=metrics,
                          drain=drain)
            settings = model.settings
            T, os_ = run.T, run.os_
            with metrics.phase("cycle_setup.window_plan"):
                coupled_np, span = window_span(settings, pts)
                if span is not None:
                    ws, we_b = span
                    wspan = wk.WindowSpan(
                        ws, we_b, T, os_, settings.coupling_effect_reduction)
                    slices = window_slices(run, wspan, float(wcache_bytes))
            if span is None:
                out = run.host_rows(run.row_plan(0, T))
            else:
                # phase A's chunks, phase B's rows, phase C's chunks: the
                # drains' order
                rows_b = wspan.out_rows
                plan_b = [list(rows_b)] if len(rows_b) else []
                out = run.host_rows(run.row_plan(0, ws - 1) + plan_b
                                    + run.row_plan(we_b, T))
        if span is None:
            return run.run_uncoupled(out, progress)
        return _coupled_stream(run, out, wspan, slices, coupled_np,
                               progress, wcache_bytes)


def _window_counts(res: wk.WindowOut, ranges):
    """A block's window counts on its device, for phase B's one host read:
    its most rewinds, the steps of its slowest point, its rewinds, its
    point-steps and the lane-steps K5 pays for, each warp of ``WARP``
    consecutive points of a launch's range running as long as its slowest
    point (csrc/scan_kernel.cu: ``window_kernel``'s thread j runs the
    range's point j).  Padded points are failed from the start and take no
    step."""
    st = res.steps
    lanes = sum(st[lo:hi].view(-1, WARP).amax(1).sum() for lo, hi in ranges)
    return torch.stack([res.reruns.max().long(), st.max().long(),
                        res.reruns.sum(), st.sum(), WARP * lanes])


def _coupled_stream(run: _Blocks, out: _HostRows, wspan: wk.WindowSpan,
                    slices, coupled_np, progress,
                    wcache_bytes: float) -> ProductionResult:
    """Phases A, B and C of a coupled run set up by
    ``run_production_coupled`` (its docstring), and the result."""
    settings = run.model.settings
    T = run.T
    ws, we_b = wspan.ws, wspan.we_b
    W = we_b - ws + 1
    rows_b = wspan.out_rows
    one_launch = all(len(s) == 1 for s in slices)
    metrics = run.metrics
    k5 = ("K5 fused (the forcing prepared in the kernel)"
          if run.engines[0].window_fused else "K5")
    metrics.note(
        f"coupling window through {k5}, one launch a block" if one_launch
        else f"coupling window through {k5} over point slices "
             f"({max(len(s) for s in slices)} launches a block) within "
             f"{float(wcache_bytes) / 1e9:.1f} GB a device")

    def phase_b(eng, ranges, tmp, scal):
        wpts = wk.window_points(eng.pts_dev, settings)
        res = None
        for lo, hi in ranges:
            forc = eng.window_input(wspan, lo, hi)
            res = wk.window(tmp, scal, forc, wpts, eng.cfg, eng.params,
                            eng.grid, wspan, lo=lo, out=res)
            # a later slice's table reuses the room on this stream
            del forc
        return res

    with metrics.phase("stream"):
        t_start = timelib.perf_counter()
        with metrics.phase("phase_a"):
            # drains every chunk before it returns: phase B reads the carry
            carry = run.stream(run.carry0(), 0, ws - 1, out,
                               progress=progress)
        with metrics.phase("phase_b"):
            with metrics.phase("phase_b.launch"):
                done = [phase_b(eng, slices[b], *carry[b])
                        for b, eng in run.scopes()]
            # the one host sync of each block's phase B, after every
            # block's launches are issued: its counts (_window_counts)
            with metrics.phase("phase_b.sync"):
                counts = [[int(v) for v in
                           _window_counts(done[b], slices[b]).cpu()]
                          for b, _ in run.scopes()]
            if max(c[0] for c in counts) > wk.MAX_RERUNS:
                raise RuntimeError(f"a point of the coupling window passed "
                                   f"{wk.MAX_RERUNS} re-runs")
            carry = [(d.tmp, d.scal) for d in done]
            if len(rows_b):
                run.drain_rows([d.rows for d in done], len(rows_b), out,
                               rows_b)
            if progress:
                progress.update(W)
        with metrics.phase("phase_c"):
            carry = run.stream(
                carry, we_b, T, out,
                cofs=[(d.sw_corr, d.lw_corr) for d in done],
                progress=progress)
            run.synchronize()
        wall = timelib.perf_counter() - t_start
    n_cpl = n_failed = 0
    for b, eng in run.scopes():
        lo, hi = run.ranges[b]
        cpl = torch.as_tensor(
            np.pad(coupled_np[lo:hi], (0, eng.P_pad - len(coupled_np[lo:hi]))),
            device=eng.device)
        n_cpl += int(cpl.sum())
        n_failed += int((cpl & eng.to_caller(done[b].cv_failed, 0)).sum())
    metrics.count("coupling_window_steps", W)
    metrics.count("coupling_reruns", max(c[0] for c in counts))
    metrics.count("coupling_window_rows", sum(c[1] for c in counts))
    metrics.count("coupling_window_cached", int(one_launch))
    metrics.count("coupling_points", n_cpl)
    metrics.count("coupling_failed", n_failed)
    metrics.count("coupling_succeeded", n_cpl - n_failed)
    for name, i in (("coupling_reruns_total", 2),
                    ("coupling_window_point_steps", 3),
                    ("coupling_window_lane_steps", 4)):
        metrics.add(name, sum(c[i] for c in counts))
    return run.assemble(out, carry, wall)
