"""The coupling window's plain version (``ops.window_kernel.window_reference``,
K5's semantics: a program counter per point over the window) against the
JAX package's ``coupling.run_window_passes`` and the port's eager one, on
the same state after phase A and the same prepared window rows, float32 as
the kernel runs; the station-rank table against the prepared (identity)
table and point slices against one call, bit for bit; and, on the card,
K5 against its plain version.

The windows of the case cover the edges where a per-point formulation
could drift from the pass-major one (tests/test_torch_production_coupled
.py:204-219's offsets): windows ending at the run's last step (never
rewound), windows ending past it (end_i > we_b), a station whose forcing
turns invalid inside the window (its points fail mid-window), points
without obs and points with sky view active (the coefficient choice)."""
import copy
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import coupling as jcoupling
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import Prepared as JPrepared
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model as JModel
from roadsurf_tpu.state import PointParams as JPointParams
from roadsurf_tpu.state import State as JState
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import coupling as tcoupling
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.forcing import RawForcing
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.ops import window_kernel as wk

torch.set_num_threads(1)

#: the coupled runs' tolerances (tests/test_torch_production_coupled.py:128)
TOL = dict(rtol=2e-4, atol=2e-3)
NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


@functools.lru_cache(maxsize=None)
def _case(T=61, S=6, P=256, wlen=12, seed=3, depth=False, out_stride=1,
          device="cpu"):
    """S stations' synthetic forcing over T steps, P points in station
    order with per-point coupling windows of ``wlen`` steps ending at
    staggered steps, every 5th at T-1 and every 11th (from the 4th) past
    the run; obs below the air temperature at the window end, so the
    control iterates, none on every 7th point; sky view active on every
    6th (from the 2nd); station 1's air temperature invalid at step 41.
    Returns the port's engine on the station fast path, the window's
    inputs after phase A (run by the scan kernel's plain version) and the
    JAX package's objects for the same case."""
    extra = {"tsurf_output_depth": 0.03} if depth else {}
    jsettings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False,
                              use_coupling=True, **extra)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)
    tair = np.asarray(raw_st.tair).copy()
    tair[1, 40] = -9999.9
    raw_st = raw_st._replace(tair=tair)
    rng = np.random.default_rng(seed)
    st_idx = np.sort(rng.integers(0, S, P))
    end = rng.integers(30, T, P)
    end[::5] = T - 1
    end[3::11] = T + 4
    start = end - wlen + 1
    obs = (tair[st_idx, np.minimum(end, T - 1) - 1]
           - rng.uniform(0.5, 2.5, P))
    obs[::7] = -9999.9
    pts = default_point_params(P)._replace(
        coupling_start=start.astype(np.int32),
        coupling_end=end.astype(np.int32), coupling_tsurf=obs)
    sky = np.where(np.arange(P) % 6 == 1, 0.6, 1.0)

    tm = tmodel.Model(interop.settings(jsettings), device=device)
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": tm.settings, "params": tm.params, "hour": cal.hour,
           "t_total": T}
    exp = tprod.StationExpander(raw_st, st_idx, device, chunk_t=T,
                                prep_ctx=ctx)
    first = RawForcing(**{n: exp.first_host[n][:, None]
                          for n in RawForcing._fields})
    state0 = tm.init(first, cal, dtype=torch.float32, pts=pts)
    # the engine of the station channels (packing, phase A, the tables):
    # with init_len 1 no window row forces the obs, so the station-rank
    # channels hold for every point whatever its coupling window
    eng = tprod._Engine(tm, exp, default_point_params(P), cal, state0,
                        chunk_t=T)
    assert eng.fast
    _, (ws, we_b) = tcoupling.window_span(tm.settings, pts)
    tmp, scal, _ = sk.scan(eng.tmp0, eng.scal0, eng.chunk_forcing(0),
                           tm.cfg, tm.params, tm.grid, nsteps=ws - 1)
    span = wk.WindowSpan(ws, we_b, T, out_stride,
                         tm.settings.coupling_effect_reduction)
    dev = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=device)
    pts_dev = eng.pts_dev._replace(
        coupling_start=dev(pts.coupling_start, torch.int32),
        coupling_end=dev(pts.coupling_end, torch.int32),
        coupling_tsurf=dev(pts.coupling_tsurf, torch.float32),
        sky_view=dev(sky, torch.float32))
    wpts = wk.window_points(pts_dev, tm.settings)
    return dict(tm=tm, eng=eng, exp=exp, tmp=tmp, scal=scal, span=span,
                wpts=wpts, pts_dev=pts_dev, jsettings=jsettings,
                jpts=pts._replace(sky_view=sky), end=end, T=T)


def _run(c, table=None, lo=0, hi=None, out=None):
    eng, tm = c["eng"], c["tm"]
    hi = eng.P_pad if hi is None else hi
    tab = table or eng.window_table(c["span"], lo, hi)
    return wk.window(c["tmp"], c["scal"], tab, c["wpts"], tm.cfg, tm.params,
                     tm.grid, c["span"], lo=lo, out=out)


@functools.lru_cache(maxsize=None)
def _window():
    """(the case with the output depth and stride 7, its window on the
    station table): built once a process, read by every test here (the
    calls do not write their inputs)."""
    c = _case(depth=True, out_stride=7)
    return c, _run(c)


def _identity_table(c, lo=0, hi=None):
    """The table of the routes off the station fast path: the points'
    prepared window (``_Engine.prepare``), R = the points."""
    eng = copy.copy(c["eng"])
    eng.fast = False
    return eng.window_table(c["span"], lo, eng.P_pad if hi is None else hi)


def _eager(c, wchunk=16):
    """The port's eager window engine on the same inputs."""
    eng, tm, span, exp = c["eng"], c["tm"], c["span"], c["exp"]
    ws, we_b = span.ws, span.we_b
    wck = min(wchunk, we_b - ws + 1)
    st = sk.unpack_state(c["tmp"], c["scal"], tm.grid.nlayers, eng.template)
    valid_win = exp.prepared_window(ws - 1, we_b - ws + 2).valid
    return tcoupling.run_window_passes(
        st, lambda t0: exp.prepared_window(t0, wck), valid_win, ws, we_b,
        c["pts_dev"], tm.settings, tm.cfg, tm.grid, tm.params,
        out_stride=span.out_stride, wchunk=wck)


def _jax(c, wchunk=16):
    """The JAX package's run_window_passes on the same state and prepared
    window rows (as tests/test_coupling_segmented.py runs it, on the
    CPU)."""
    tm, span, exp = c["tm"], c["span"], c["exp"]
    ws, we_b = span.ws, span.we_b
    W = we_b - ws + 1
    wck = min(wchunk, W)
    W_pad = -(-W // wck) * wck
    st = sk.unpack_state(c["tmp"], c["scal"], tm.grid.nlayers,
                         c["eng"].template)
    jst = JState(*(jnp.asarray(x.numpy()) for x in st))
    wprep = JPrepared(*(jnp.asarray(x.numpy())
                        for x in exp.prepared_window(ws - 1, W_pad)))
    provider = lambda t0: jax.tree.map(
        lambda a: jax.lax.dynamic_slice_in_dim(a, t0 - (ws - 1), wck,
                                               axis=0), wprep)
    valid_win = jnp.asarray(
        exp.prepared_window(ws - 1, W + 1).valid.numpy())
    jm = JModel(c["jsettings"])
    jpts = JPointParams(*(np.asarray(x) for x in c["jpts"]))
    return jcoupling.run_window_passes(
        jst, provider, valid_win, ws, we_b, jpts, c["jsettings"], jm.cfg,
        jm.grid, jm.params, out_stride=span.out_stride, wchunk=wck)


def _same(a: wk.WindowOut, b: wk.WindowOut):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_window_matches_jax_run_window_passes():
    c, got = _window()
    want = _jax(c)
    P = got.rows.shape[2]
    assert int(got.reruns.max()) > 0
    # every point's rows: [n_out, 6, P] against [n_out, P, 6]
    np.testing.assert_allclose(got.rows.numpy(),
                               np.asarray(want.out).transpose(0, 2, 1),
                               **TOL)
    st = sk.unpack_state(got.tmp, got.scal, c["tm"].grid.nlayers,
                         c["eng"].template)
    for name in ("tmp", "tsurf_ave", "wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(want.state, name)),
                                   err_msg=name, **TOL)
    assert np.array_equal(st.failed.numpy(), np.asarray(want.state.failed))
    assert st.failed.any() and not st.failed.all()
    assert np.array_equal(got.cv_failed.numpy(), np.asarray(want.cv.failed))
    assert int(got.reruns.max()) == int(want.reruns)
    np.testing.assert_allclose(got.sw_corr.numpy(),
                               np.asarray(want.cv.sw_corr), **TOL)
    np.testing.assert_allclose(got.lw_corr.numpy(),
                               np.asarray(want.cv.lw_corr), **TOL)
    assert P == 256


def test_window_matches_eager_run_window_passes():
    """Against the port's eager engine: the same re-run count for every
    point (so the same pass count), the same corrections, failures and
    failed masks; the outputs at the coupled runs' tolerances."""
    c, got = _window()
    want = _eager(c)
    assert torch.equal(got.reruns, want.point_reruns)
    assert int(got.reruns.max()) == want.reruns > 0
    assert torch.equal(got.cv_failed, want.cv.failed)
    assert torch.equal(got.sw_corr, want.cv.sw_corr)
    assert torch.equal(got.lw_corr, want.cv.lw_corr)
    st = sk.unpack_state(got.tmp, got.scal, c["tm"].grid.nlayers,
                         c["eng"].template)
    assert torch.equal(st.failed, want.state.failed)
    np.testing.assert_allclose(got.rows.numpy(),
                               want.out.permute(0, 2, 1).numpy(), **TOL)
    # the points whose window ends at T-1 never rewind, and those past the
    # run end inside it (end_i > we_b)
    end = c["end"]
    assert not got.reruns[torch.as_tensor(end >= c["T"] - 1)].any()


def test_station_table_equals_identity_table_bitwise():
    """The station-rank prepared channels at each point's station (the
    station route's table) against the points' own prepared window (every
    other route's), through the whole window."""
    c, got = _window()
    _same(got, _run(c, table=_identity_table(c)))


def test_point_slices_equal_one_call_bitwise():
    c, one = _window()
    parts = None
    for lo, hi in ((0, 128), (128, 256)):
        parts = _run(c, table=_identity_table(c, lo, hi), lo=lo, hi=hi,
                     out=parts)
    _same(one, parts)


def test_window_slices():
    """The slices of a block's window: the station fast path's table (a
    view of the station channels) counts nothing, and K5 fused reads no
    table: one range at any budget; elsewhere equal slices of whole lanes
    within the budget, at most WINDOW_SLICES_MAX, of whole tiles where a
    slice holds one."""
    c, _ = _window()
    span = c["span"]
    run = lambda *engs: SimpleNamespace(
        engines=list(engs), mesh=SimpleNamespace(devices=["d"] * len(engs)))
    generic = copy.copy(c["eng"])
    generic.fast = False
    assert tprod.window_slices(run(c["eng"]), span, 0) == [[(0, 256)]]
    fused = copy.copy(generic)
    fused.window_fused = True
    assert tprod.window_slices(run(fused, generic), span, 0) == [
        [(0, 256)], [(0, 128), (128, 256)]]
    assert tprod.window_slices(run(generic), span, 0) == [[(0, 128),
                                                           (128, 256)]]
    table = 4 * sk.NCH * span.rows * 256
    assert tprod.window_slices(run(generic), span, table) == [[(0, 256)]]
    # two blocks on one device share the budget
    assert tprod.window_slices(run(generic, generic), span, table) == [
        [(0, 128), (128, 256)]] * 2
    # 1,048,576 points in 1024-point tiles: 25 GB of table in 4 GB slices
    # (7 of whole tiles), and at most WINDOW_SLICES_MAX however small
    big = SimpleNamespace(fast=False, window_fused=False, P_pad=1 << 20,
                          tile_geom=(1024, 1024))
    span_big = span._replace(ws=2521, we_b=2900, T=8881)
    for budget, n in ((4e9, 7), (0, tprod.WINDOW_SLICES_MAX)):
        sl, = tprod.window_slices(run(big), span_big, budget)
        assert len(sl) == n and sl[0][0] == 0 and sl[-1][1] == 1 << 20
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert all(lo % 1024 == 0 for lo, _ in sl)
        if budget:
            assert max(4 * sk.NCH * span_big.rows * (hi - lo)
                       for lo, hi in sl) <= budget


@pytest.mark.cuda
def test_window_kernel_matches_plain_on_the_card():
    """K5 against its plain version on the card, bit for bit, on both
    tables, with and without the output depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the window kernel runs only on "
                    "the card)")
    for depth in (False, True):
        c = _case(depth=depth, out_stride=7, device="cuda")
        tm = c["tm"]
        for table in (None, _identity_table(c)):
            tab = table or c["eng"].window_table(c["span"], 0, 256)
            args = (c["tmp"], c["scal"], tab, c["wpts"], tm.cfg, tm.params,
                    tm.grid, c["span"])
            got = wk.window_cuda(*args)
            want = wk.window_reference(*args)
            torch.cuda.synchronize()
            _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [None, 16])
@pytest.mark.parametrize("nlayers", [15, 20])
def test_fused_window_kernel_at_any_span_on_the_card(nlayers, stage,
                                                     monkeypatch):
    """K5 fused on the card at SPAN above the stage width (the sub-hourly
    grid of tests/test_torch_fused_span.py, coupled: the window spans two
    window chunks, the first one several stages of segment lines, and the
    control rewinds across them), at 15 and 20 layers and two widths (the
    rule's, and 16), against its plain version on the inputs the coupled
    run hands phase B, bit for bit: rows, state, corrections, failed
    masks, re-runs and steps; at the rule's width the blocks an SM are
    what the registers allow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the window kernel runs only on "
                    "the card)")
    from test_torch_fused_span import CHUNK, port_engine, span_case
    dev = torch.device("cuda", 0)
    tm, exp, pts, cal, st = port_engine(
        span_case(coupled=True, nlayers=nlayers, device=dev), device=dev)
    kept, window = [], wk.window

    def recorded(*a, **k):
        kept.append(((a[0].clone(), a[1].clone()) + a[2:], k))
        return window(*a, **k)
    monkeypatch.setattr(wk, "window", recorded)
    tprod.run_production_coupled(tm, exp, pts, cal, st, chunk_t=CHUNK,
                                 out_stride=6)
    (args, kw), = kept
    forc, span = args[2], args[-1]
    assert wk.is_fused(forc) and span.rows > forc.tc
    if stage:
        monkeypatch.setattr(sk, "stage_width", lambda *a: stage)
    got = wk.window_cuda(*args, **kw)
    f = sk.LAST_LAUNCH["K5 fused"]
    assert exp.SPAN > f.stage == (stage or f.stage)
    assert stage or f.blocks == f.blocks_regs, f
    want = wk.window_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int(want.reruns.max()) > 0
    _same(got, want)
