"""K3 fused and K5 fused on a grid whose window holds more segments than one
stage of segment lines (``ops.scan_kernel.stage_width``): a sub-hourly grid
(a 5-minute raw clock) at 512 steps of 30 s in 256-step chunks, SPAN 27,
256 points, 8 channels.

 * the stage width rule: the segment lines never take more shared memory
   than the SM leaves the blocks the registers allow, a SPAN within the
   width keeps one layout, and the width is monotone in channels and SPAN
   (the shapes of chip_smoke's 7s, 3f and 3w and of the hourly grid);
 * ``fuse_args`` takes the chunk's and the window's arguments, and the
   engine keeps both fused routes (no route declines a grid by its SPAN);
 * the kernel's staged segment lines, evaluated one step at a time in
   numpy as csrc/scan_kernel.cu evaluates them (a stage's lines computed
   when a step enters it), equal the expander's window bit for bit at any
   width;
 * ``window_reference``'s segment-line statistics at a narrower width;
 * ``run_production`` on the fused route (its plain version on the CPU)
   equals the generic route bit for bit and the JAX package's
   ``run_production(interpret=True)`` at rtol 2e-4 / atol 2e-3 with equal
   failed masks; ``run_production_coupled`` on the K5 fused route equals
   the table route bit for bit and the JAX package's run.

The ``cuda`` cases of tests/test_torch_scan_kernel.py and
tests/test_torch_window_kernel.py run the kernels on these inputs."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import production as jprod
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import Calendar, RawForcing
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.coupling import window_span
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.ops import window_kernel as wk

from test_torch_production_grid import _assert_match, _assert_same, utc

torch.set_num_threads(1)

P, T, CHUNK = 256, 512, 256
#: the grid's gap cap: 30 minutes of a 5-minute clock keep its window (KW
#: raw rows) short, which the JAX package's window compiles row by row
MAX_GAP_S = 1800.0
#: the channels of the sub-hourly grid (prec_phase aside)
CHANNELS = ("tair", "tdew", "vz", "rhz", "prec", "sw", "lw", "sw_dir")
#: an NVIDIA H100's shared memory (an SM's, the most a block may opt in to,
#: the reserve of each block; cudaDeviceGetAttribute) and the blocks an SM
#: the fused instantiations' registers allow there (ptxas: K3 fused <16>
#: 94 registers, K5 fused <16> 128, <32> 149), with K5 fused's static
#: snapshot, (LM + 10) x 128 floats: the budgets ``sk.stage_width`` sees
#: on that card
H100 = dict(sm_smem=233472, block_smem=232448, reserved=1024)
K3_16 = sk.SmBudget(blocks=5, static_smem=0, **H100)
K5_16 = sk.SmBudget(blocks=4, static_smem=26 * 512, **H100)
K5_32 = sk.SmBudget(blocks=3, static_smem=42 * 512, **H100)


def span_grid(minutes=5, hours=7, seed=3):
    """A 3 x 4 grid on a ``minutes`` raw clock over ``hours`` hours, as
    chip_smoke.wide_grid builds one: hourly fields (air temperature, RH,
    wind, precipitation, shortwave, longwave) linear in time between the
    hours, a dew point (the air temperature less a fifth of the RH's
    deficit) and direct shortwave (0.7 of the shortwave); a tenth of the
    air temperature and RH samples missing, so the segment lines search
    past them.  Returns (times, lats, lons, fields)."""
    rng = np.random.default_rng(seed)
    shp = (hours + 1, 3, 4)
    hr = np.arange(hours + 1)[:, None, None]
    hourly = {
        "tair": -3.0 + 0.8 * hr + rng.normal(0, 0.4, shp),
        "rhz": np.clip(85.0 + rng.normal(0, 10.0, shp), 40, 100),
        "vz": np.abs(rng.normal(3.0, 1.0, shp)),
        "prec": np.where(rng.random(shp) < 0.3, rng.uniform(0, 3, shp), 0.0),
        "sw": np.abs(rng.normal(60.0, 30.0, shp)),
        "lw": 290.0 + rng.normal(0, 5.0, shp)}
    n = hours * 60 // minutes + 1
    w = minutes * np.arange(n) / 60.0
    i = np.minimum(w.astype(np.int64), hours - 1)
    f = (w - i)[:, None, None]
    fields = {k: v[i] * (1.0 - f) + v[i + 1] * f for k, v in hourly.items()}
    fields["tdew"] = fields["tair"] - (100.0 - fields["rhz"]) / 5.0
    fields["sw_dir"] = 0.7 * fields["sw"]
    for name in ("tair", "rhz"):
        fields[name] = np.where(rng.random(fields[name].shape) < 0.1,
                                -9999.9, fields[name])
    times = utc("2019-12-02 00:00") + 60 * minutes * np.arange(n)
    lats, lons = np.linspace(60.0, 61.0, 3), np.linspace(24.0, 25.5, 4)
    return times, lats, lons, {k: np.asarray(v, np.float32)
                               for k, v in fields.items()}


def _mesh():
    """The JAX runs' mesh: one CPU device (the 256 points fill its
    lanes)."""
    return make_mesh(jax.devices()[:1])


def span_case(coupled=False, nlayers=None, n=P, device="cpu", with_jax=False,
              cend_lo=215, wlen=40, seed=5):
    """(JAX expander or None, port expander, JAX settings, cal, pts,
    state0 [JAX float32]) of the sub-hourly grid over ``n`` points from
    01:00 UTC, 30 s steps, ``CHUNK``-step chunks.  Coupled: each point's
    ``wlen``-step window ends at a step drawn from [``cend_lo``, T), every
    9th point uncoupled, every 9th from the 2nd at T-1, obs U(-3, 1) C (the
    control iterates); the window then spans two window chunks, and its
    first one both stages."""
    times, lats, lons, fields = span_grid()
    sim = times[0] + 3600 + 30 * np.arange(T, dtype=np.int64)
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False,
                             use_coupling=coupled,
                             **({"nlayers": nlayers} if nlayers else {}))
    cal = Calendar.from_epochs(sim)
    rng = np.random.default_rng(seed)
    plat, plon = rng.uniform(60.0, 61.0, n), rng.uniform(24.0, 25.5, n)
    pts = default_point_params(n)._replace(lat=plat, lon=plon)
    if coupled:
        cend = rng.integers(cend_lo, T, n)
        cend[::9] = -99
        cend[1::9] = T - 1
        pts = pts._replace(
            coupling_start=np.maximum(cend - (wlen - 1), 1).astype(np.int32),
            coupling_end=cend.astype(np.int32),
            coupling_tsurf=rng.uniform(-3.0, 1.0, n))
    jexp = (jprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                               _mesh(), chunk_t=CHUNK, max_gap_s=MAX_GAP_S)
            if with_jax else None)
    texp = tprod.GridExpander(times, lats, lons, fields, plat, plon, sim,
                              device, chunk_t=CHUNK, max_gap_s=MAX_GAP_S)
    raw0 = RawForcing(*(np.asarray(texp.first_host[k])[:, None]
                        for k in RawForcing._fields))
    state0 = Model(settings).init(raw0, cal, dtype=jnp.float32, pts=pts)
    return jexp, texp, settings, cal, pts, state0


def port_engine(case, device="cpu"):
    """(port Model, expander, pts, cal, state) of a ``span_case`` on
    ``device``."""
    _, texp, settings, cal, pts, state0 = case
    return (tmodel.Model(interop.settings(settings), device=device), texp,
            pts, cal, interop.state(state0, "cpu"))


def width(budget=K3_16, n_ch=len(CHANNELS), span=None):
    """``sk.stage_width`` of the case's grid (or ``span``) on ``budget``."""
    return sk.stage_width(n_ch, span or 27, budget)


@pytest.mark.parametrize("budget", [K3_16, K5_16, K5_32])
def test_stage_width_keeps_the_blocks_the_registers_allow(budget):
    """At every channel count and SPAN the segment lines of a block, with
    its static shared memory and the reserve, fit ``budget.blocks`` times
    in an SM (unless a single line does not) and a block's limit; the
    width is a power of two, no wider than needed for one stage of the
    whole SPAN, and a full stage of the next power of two would take the
    SM a block."""
    for n_ch in range(0, 11):
        for span in range(1, 80):
            w = sk.stage_width(n_ch, span, budget)
            assert w >= 1 and w & (w - 1) == 0, (n_ch, span, w)
            need = lambda x, s: (budget.static_smem + budget.reserved
                                 + sk.seg_bytes(n_ch, s, x))
            if w > 1:
                assert budget.blocks * need(w, span) <= budget.sm_smem
                assert need(w, span) - budget.reserved <= budget.block_smem
            if w < span:
                # a full stage of the next width would cost a block
                assert budget.blocks * need(2 * w, 2 * w) > budget.sm_smem
            else:
                assert w // 2 < span, (n_ch, span, w)


def test_stage_width_keeps_one_layout_within_the_span():
    """A SPAN within the width keeps one stage of the whole window: its
    lines take n_ch x SPAN KB a block, as before the width was chosen per
    launch (the hourly grid: SPAN 2 and 6-8 channels, 12-16 KB)."""
    for budget in (K3_16, K5_16, K5_32):
        for n_ch in (1, 6, 8, 10):
            for span in (1, 2, 3):
                w = sk.stage_width(n_ch, span, budget)
                assert w >= span, (n_ch, span, w)
                assert sk.seg_bytes(n_ch, span, w) == n_ch * span * 1024
    assert sk.seg_bytes(6, 2, width(span=2)) == 12 * 1024


def test_stage_width_is_monotone():
    """More channels never widen a stage; a longer SPAN never narrows it,
    nor shrinks the lines a block holds."""
    for budget in (K3_16, K5_16, K5_32):
        for span in range(1, 80):
            ws = [sk.stage_width(n, span, budget) for n in range(1, 11)]
            assert ws == sorted(ws, reverse=True), (span, ws)
        for n_ch in range(1, 11):
            ws = [sk.stage_width(n_ch, s, budget) for s in range(1, 80)]
            assert ws == sorted(ws), (n_ch, ws)
            b = [sk.seg_bytes(n_ch, s, w) for s, w in zip(range(1, 80), ws)]
            assert b == sorted(b), (n_ch, b)


@pytest.mark.parametrize("shape,want", [
    # (budget, channels, SPAN): 7s (8 channels, SPAN 53), 3f (SPAN 27) and
    # 3w (SPAN 21) at <16> and <32>, and the hourly grid (SPAN 2)
    ((K3_16, 8, 53), 4), ((K5_16, 8, 53), 4), ((K3_16, 8, 27), 4),
    ((K5_16, 8, 21), 4), ((K5_32, 8, 21), 4), ((K3_16, 6, 2), 2),
    ((K5_16, 6, 2), 2), ((K3_16, 1, 36), 32)])
def test_stage_width_at_the_smoke_shapes(shape, want):
    """The width at chip_smoke's shapes on an H100: a stage of 4 segments
    where a stage of 16 held one block an SM (7s: 128 KB a block), the
    whole window at SPAN 2."""
    budget, n_ch, span = shape
    assert sk.stage_width(n_ch, span, budget) == want


class _FakeLib:
    """``roadsurf_fused_info`` of an H100 build (K3 fused ``<16>``: 96
    registers, 5 blocks an SM; K5 fused ``<16>``: 128 and 4, its static
    snapshot), the blocks at a dynamic size as the occupancy call counts
    them, and the channel set of the FuseArgs at ``addr`` (1 where its
    grid has no dew point), without a card."""
    def __init__(self):
        self.calls = []

    def roadsurf_fused_info(self, addr, window, nlayers, depth, dyn, info):
        self.calls.append((window, nlayers, depth, dyn))
        fa = sk.FuseArgs.from_address(addr)
        b = K5_16 if window else K3_16
        regs = 128 if window else 96
        per = b.static_smem + dyn + b.reserved
        info[:] = [regs, b.static_smem, b.blocks,
                   min(b.blocks, b.sm_smem // per), b.sm_smem, b.block_smem,
                   b.reserved, int(fa.has_grid and not fa.g[1])]
        return 0


@pytest.mark.parametrize("kind", ["K3 fused", "K5 fused"])
def test_fused_launch_sets_the_width_from_the_card(kind, monkeypatch):
    """``fused_launch`` reads the instantiation's figures, sets
    ``FuseArgs.stage`` to the rule's width (or a forced one in its place,
    a power of two), and records the launch with the channel set the
    library reports for ``fa`` (its figures cached by the grid's
    channels): the 7s shape (8 channels, SPAN 53) takes 4 segments, 32 KB
    a block, and keeps the blocks the registers allow; a forced 16 takes
    128 KB and one block."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    lib, dev = _FakeLib(), torch.device("cuda", 0)
    fa = sk.FuseArgs(has_grid=1, span=53)
    for i, n in enumerate(sk.RAW_FIELDS):
        fa.g[i] = 8 if n in CHANNELS else None
    consts = sk.ScanConsts(L=15, use_depth=0)
    f = sk.fused_launch(lib, fa, kind, consts, dev)
    assert fa.stage == f.stage == 4 and f.smem == 8 * 4 * 1024
    assert f.blocks == f.blocks_regs == (4 if kind == "K5 fused" else 5)
    assert f.channel_set == 0
    assert sk.LAST_LAUNCH[kind] == f
    assert lib.calls[-1] == (kind == "K5 fused", 15, 0, f.smem)
    fa.g[sk.RAW_FIELDS.index("tdew")] = None
    assert sk.fused_launch(lib, fa, kind, consts, dev).channel_set == 1
    fa.g[sk.RAW_FIELDS.index("tdew")] = 8
    monkeypatch.setattr(sk, "stage_width", lambda *a: 16)
    f16 = sk.fused_launch(lib, fa, kind, consts, dev)
    assert fa.stage == 16 and f16.smem == 128 * 1024 and f16.blocks == 1
    monkeypatch.setattr(sk, "stage_width", lambda *a: 12)
    with pytest.raises(ValueError, match="power of two"):
        sk.fused_launch(lib, fa, kind, consts, dev)


def test_the_case_passes_a_stage():
    """The grid's SPAN at 256-step chunks passes one stage of segment
    lines, and the expander carries the 8 channels."""
    _, texp, settings, cal, *_ = span_case()
    assert texp.SPAN > width(K3_16) and texp.SPAN > width(K5_16), texp.SPAN
    assert tuple(n for n in RawForcing._fields
                 if n in texp.var_names) == CHANNELS
    times = span_grid()[0]
    sim = times[0] + 3600 + 30 * np.arange(T, dtype=np.int64)
    assert texp.SPAN == tprod.grid_span(times, sim, CHUNK)


@pytest.mark.parametrize("coupled", [False, True])
def test_fuse_args_take_any_span(coupled):
    """The engine keeps K3 fused and K5 fused at SPAN above the stage
    width, and ``fuse_args`` takes a chunk's and the window's arguments on
    CPU tensors, the grid's SPAN among them."""
    tm, texp, pts, cal, st = port_engine(span_case(coupled=coupled))
    eng = tprod._Engine(tm, texp, pts, cal, st, chunk_t=CHUNK)
    assert eng.fused and eng.window_fused
    src, _ = eng.kernel_inputs(CHUNK)
    fa = sk.fuse_args(src, torch.device("cpu"))
    assert fa.has_grid and fa.span == texp.SPAN > width()
    assert (fa.k0, fa.lo) == texp.window_rows(CHUNK)
    if coupled:
        _, (ws, we_b) = window_span(tm.settings, pts)
        span = wk.WindowSpan(ws, we_b, T, 6,
                             tm.settings.coupling_effect_reduction)
        forc = eng.window_input(span, 0, eng.P_pad)
        assert wk.is_fused(forc) and span.rows > forc.tc == CHUNK
        assert sk.fuse_args(forc, torch.device("cpu")).span == texp.SPAN


def _lines(col, d, k0, lo, KW, K, span, max_gap, stage, w):
    """csrc/scan_kernel.cu:grid_segments in numpy float32 for the segments
    of the stage of width ``w`` from ``stage`` on the window (k0, lo), each
    from its own segment alone: {s: (alpha, beta)} over the points of
    ``col`` [K, P]."""
    f32 = np.float32
    tr0 = d["tr0"]
    out = {}
    for s in range(stage, min(stage + w, span)):
        kg = k0 + s
        kl, klm1 = (min(max(kg - lo - j, 0), KW - 1) for j in (0, 1))
        t1 = np.full(col.shape[1], f32(-3e38))
        v1 = np.zeros(col.shape[1], f32)
        t2, v2 = np.full_like(t1, f32(3e38)), v1.copy()
        todo = np.ones(col.shape[1], bool)
        for k in range(klm1, -1, -1):
            hit = todo & (col[lo + k] > -9000.0)
            t1, v1 = np.where(hit, d["trw"][lo + k], t1), np.where(
                hit, col[lo + k], v1)
            todo &= ~hit
        todo[:] = True
        for k in range(kl, KW):
            hit = todo & (col[lo + k] > -9000.0)
            t2, v2 = np.where(hit, d["trw"][lo + k], t2), np.where(
                hit, col[lo + k], v2)
            todo &= ~hit
        gap = t2 - t1
        have = ((t1 > f32(-3e38) * f32(0.5)) & (t2 < f32(3e38) * f32(0.5))
                & (gap <= f32(max_gap)) & (0 < kg < K))
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            invg = np.where(gap > 0, f32(1.0) / gap, f32(0.0))
            b = np.where(have, (v2 - v1) * invg, f32(0.0))
            a = np.where(have, v1 + (tr0 - t1) * b, f32(-9999.9))
        out[s] = (a.astype(f32), b.astype(f32))
    return out


@pytest.mark.parametrize("t0", [0, 100, CHUNK])
def test_staged_lines_equal_window(t0):
    """K3 fused's grid stage in numpy, as the kernel runs it at the width
    the rule gives on an H100: the lines of the first stage before the
    first step, then each step's segment from the stage holding it, whose
    lines are computed (from their own segments alone) when a step enters
    it; each step's line or its exact-time valid sample equals the
    expander's window bit for bit, and every line of the chunk is computed
    once at most."""
    _staged_lines(t0, width())


@pytest.mark.parametrize("w", [1, 2, 8, 16, 32])
def test_staged_lines_equal_window_at_any_width(w):
    """The same at other stage widths (``--stage`` on the card, the cuda
    tests' second width): the bits never depend on the width."""
    _staged_lines(CHUNK // 2, w)


def _staged_lines(t0, w):
    """test_staged_lines_equal_window's check at chunk offset ``t0`` and
    stage width ``w``."""
    _, texp, *_ = span_case()
    d = {k: v.numpy() for k, v in texp.device_data.items() if k != "pv"}
    k0, lo = texp.window_rows(t0)
    KW, K, span = texp.KW, texp.K, texp.SPAN
    d["tr0"] = d["trel"][t0]
    win = texp.window_tm(t0, CHUNK)
    for name in ("tair", "vz", "sw", "lw", "sw_dir", "prec"):
        pv = texp.device_data["pv"][name].numpy()           # [nt, K, TP]
        col = pv.transpose(1, 0, 2).reshape(K, -1)
        args = (col, d, k0, lo, KW, K, span, texp.max_gap_s)
        s0 = min(max(int(d["pos"][t0]) - k0, 0), span - 1) & -w
        lines, entered = _lines(*args, s0, w), [s0]
        got = []
        for t in range(CHUNK):
            tg = t0 + t
            st = min(max(int(d["pos"][tg]) - k0, 0), span - 1)
            if st & -w != s0:
                s0 = st & -w
                lines = _lines(*args, s0, w)
                entered.append(s0)
            a, b = lines[st]
            res = a + (d["trel"][tg] - d["tr0"]) * b
            kg = k0 + st
            if d["tex"][tg] and kg < K:
                x = col[lo + min(max(kg - lo, 0), KW - 1)]
                res = np.where(x > -9000.0, x, res)
            got.append(res)
        want = getattr(win, name).transpose(0, 1).reshape(CHUNK, -1).numpy()
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
        assert entered == sorted(set(entered)), (name, entered)
        assert len(entered) >= 2 or w >= span, (name, entered)


@functools.lru_cache(maxsize=None)
def _window_call():
    """The (args, kwargs) the port's coupled run of the case on 128 points
    hands phase B (a fused window, on the CPU), and ``window_reference``'s
    results and statistics there with one stage of the whole window."""
    tm, texp, pts, cal, st = port_engine(span_case(coupled=True, n=128))
    kept, window = [], wk.window
    wk.window = lambda *a, **k: (kept.append((a, k)), window(*a, **k))[1]
    try:
        tprod.run_production_coupled(tm, texp, pts, cal, st, chunk_t=CHUNK,
                                     out_stride=6)
    finally:
        wk.window = window
    (args, kw), = kept
    assert wk.is_fused(args[2])
    one = {}
    res = wk.window_reference(*args, **kw, stats=one, stage=64)
    return args, kw, res, {k: int(v) for k, v in one.items()}


@pytest.mark.parametrize("w", [2, 4])
def test_window_line_statistics_at_a_narrower_width(w):
    """``window_reference``'s segment-line statistics of K5 fused at stage
    width ``w`` against one stage of the whole window: the same rows
    prepared; a lane enters a stage at least as often (a window chunk
    entered, or a stage within it) and computes at most ``w`` lines an
    entry, where one stage computes all SPAN an entry; the results do not
    depend on the width; the statistics need a width."""
    args, kw, a, one = _window_call()
    span = args[2].kernel_args()["span"]
    assert span > w
    narrow = {}
    b = wk.window_reference(*args, **kw, stats=narrow, stage=w)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    narrow = {k: int(v) for k, v in narrow.items()}
    assert one["window_lines"] == one["window_segments"] * span
    assert narrow["window_preps"] == one["window_preps"] > 0
    assert narrow["window_segments"] > one["window_segments"] > 0
    assert (narrow["window_segments"] <= narrow["window_lines"]
            <= narrow["window_segments"] * w)
    with pytest.raises(ValueError, match="stage width"):
        wk.window_reference(*args, **kw, stats={})


@functools.lru_cache(maxsize=None)
def _jax_run(coupled):
    """The JAX package's run of the case (its Pallas kernel in interpret
    mode) at output stride 1."""
    case = span_case(coupled=coupled, with_jax=True)
    jexp, _, settings, cal, pts, state0 = case
    run = jprod.run_production_coupled if coupled else jprod.run_production
    want = run(Model(settings), jexp, pts, cal, state0, mesh=_mesh(),
               chunk_t=CHUNK, out_stride=1, interpret=True)
    return case, want


def test_fused_run_equals_generic_and_jax(monkeypatch):
    """``run_production`` at SPAN above the stage width on the fused route
    (K3 fused's plain version here) equals the generic route (K1) bit for bit
    and the JAX package's run at its tolerances."""
    case, want = _jax_run(False)
    tm, texp, pts, cal, st = port_engine(case)
    runs = []
    for generic in (False, True):
        monkeypatch.setattr(tprod._Engine, "force_generic", generic)
        runs.append(tprod.run_production(tm, texp, pts, cal, st,
                                         chunk_t=CHUNK, out_stride=6))
    _assert_same(*runs)
    _assert_match(runs[0], want, 6)


def test_coupled_fused_window_equals_table_and_jax(monkeypatch):
    """``run_production_coupled`` at SPAN above the stage width: phase B
    through K5 fused (its plain version here, one call on a FusedWindow) equals the
    table route (``force_window_table``) bit for bit, and the JAX
    package's run at its tolerances; the control iterates."""
    case, want = _jax_run(True)
    tm, texp, pts, cal, st = port_engine(case)
    runs = []
    for table in (False, True):
        monkeypatch.setattr(tprod._Engine, "force_window_table", table)
        forcs, window = [], wk.window
        monkeypatch.setattr(wk, "window", lambda *a, **k: (
            forcs.append(a[2]), window(*a, **k))[1])
        metrics = tprod.RunMetrics()
        runs.append(tprod.run_production_coupled(
            tm, texp, pts, cal, st, chunk_t=CHUNK, out_stride=6,
            metrics=metrics))
        assert len(forcs) == 1 and wk.is_fused(forcs[0]) != table
        assert metrics.counters["coupling_reruns"] > 0
        monkeypatch.setattr(wk, "window", window)
    _assert_same(*runs)
    _assert_match(runs[0], want, 6)
