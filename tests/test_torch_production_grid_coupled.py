"""The port's coupled run over a grid forecast with station obs
(``run_production_coupled`` through a CompositeExpander: phases A and C
on the tile-major route, K3 with the in-kernel decay; phase B from the
composite's [wck, P] window) against the JAX package's
``run_production_coupled(interpret=True)``, float32 on both sides, at rtol
2e-4 / atol 2e-3 with equal failed masks (tests/test_production_grid.py:
216-318); and phase B's routes on the configurations K3 fused takes: K5
fused (``production.FusedWindow``, no table, one launch a block at any
budget) against the table route (``_Engine.force_window_table``), and the
table route's point slices against its one launch, bit for bit.  On the
CPU both routes run ``window_reference`` on the same eager table, so these
hold the routing and the fused window's arguments, not the kernel (the
``cuda`` case of tests/test_torch_window_kernel.py and chip_smoke.py 3w
and 7w do).  The inputs are tests/test_torch_production_grid.py's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu.model import Model

from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.coupling import window_span
from roadsurf_tpu_torch.config import MISSING
from roadsurf_tpu_torch.forcing import RawForcing, relax_anchors
from roadsurf_tpu_torch.io.synthetic import synthetic_raw
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.ops import window_kernel as wk
from test_torch_production_grid import (P, _assert_match, _assert_same,
                                       _jax_reference, _setup, utc)

torch.set_num_threads(1)

#: the configurations whose phase B K5 fused takes: a grid, a grid +
#: station composite, stations with sky view, the grid with relaxation
FUSED_CASES = ("grid", "composite", "station_sky", "grid_relax")


def _coupled_case(case):
    """(model, expander, pts, cal, state, anchors) of a coupled case over
    49 steps: the coupled points of ``_setup`` (the last valid obs of the
    merged forcing), their 15-step windows ending at steps 36-40, before
    the run's last (a window ending there never rewinds), and their obs
    targets 1.5 K below the obs, so the control iterates; ``grid_relax``
    turns relaxation on with anchors from the host forcing at per-point
    init lengths (tests/test_torch_fused_k3.py).  ``station_sky`` is
    ``_setup``'s without its missing samples (there every point fails
    within a few steps): seven stations' synthetic series, sky view 0.6
    and U(0, 25) degree horizons on every third point, obs targets below
    the air temperature at the window end.  ``station_sky_setup`` is
    ``_setup``'s stations with sky view as they are, missing samples
    included."""
    config = {"grid_relax": "grid",
              "station_sky_setup": "station_sky"}.get(case, case)
    _, exp, settings, cal, pts, state0 = _setup(
        config, T=49, use_coupling=True, with_jax=False)
    if case == "station_sky_setup":
        return (tmodel.Model(interop.settings(settings), device="cpu"), exp,
                pts, cal, interop.state(state0, "cpu"), None)
    if case == "station_sky":
        T = settings.sim_len
        raw_st, _ = synthetic_raw(7, T, dt=settings.dt, seed=13,
                                  start_epoch=utc("2019-12-02 00:00"),
                                  dtype=np.float32)
        st_idx = np.random.default_rng(9).integers(0, 7, P)
        st_idx[::83] = -1
        exp = tprod.StationExpander(raw_st, st_idx, "cpu", chunk_t=32)
        ok = st_idx >= 0
        tair = np.asarray(raw_st.tair)[np.where(ok, st_idx, 0), 40]
        pts = pts._replace(coupling_end=np.where(ok, 40, -99),
                           coupling_tsurf=np.where(ok, tair - 1.5, MISSING))
        raw0 = RawForcing(*(np.asarray(exp.first_host[n])[:, None]
                            for n in RawForcing._fields))
        state0 = Model(settings).init(raw0, cal, dtype=jnp.float32, pts=pts)
    obs = np.asarray(pts.coupling_tsurf)
    on = obs > -100.0
    end = np.where(on, 36 + np.arange(P) % 5, pts.coupling_end)
    pts = pts._replace(
        coupling_start=np.where(on, end - 14, end).astype(np.int32),
        coupling_end=end.astype(np.int32),
        coupling_tsurf=np.where(on, obs - 1.5, obs))
    anchors = None
    if case == "grid_relax":
        rng = np.random.default_rng(17)
        settings = dataclasses.replace(settings, use_relaxation=True)
        pts = pts._replace(
            init_len=rng.integers(1, 30, P).astype(np.int32),
            tair_relax=rng.uniform(-8, 2, P), vz_relax=rng.uniform(0, 8, P),
            rh_relax=rng.uniform(40, 100, P))
        vals = exp.host_at(np.arange(settings.sim_len), RawForcing._fields)
        anchors = relax_anchors(RawForcing(**vals), pts)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    return tm, exp, pts, cal, interop.state(state0, "cpu"), anchors


def _run(case, budget, monkeypatch, table=False):
    """A coupled run of ``case`` at the window budget ``budget``, phase B
    through the table route where ``table``; returns (result, metrics,
    the forcing of each window call)."""
    tm, exp, pts, cal, st, anchors = _coupled_case(case)
    monkeypatch.setattr(tprod._Engine, "force_window_table", table)
    forcs, window = [], wk.window
    monkeypatch.setattr(wk, "window", lambda *a, **k: (
        forcs.append(a[2]), window(*a, **k))[1])
    metrics = tprod.RunMetrics()
    res = tprod.run_production_coupled(
        tm, exp, pts, cal, st, anchors=anchors, chunk_t=32, out_stride=6,
        metrics=metrics, wcache_bytes=budget)
    assert metrics.counters["coupling_points"] > 0
    return res, metrics, forcs


@pytest.mark.parametrize("out_stride", [1, 6])
def test_port_coupled_grid_matches_jax(out_stride):
    """Grid forecast + station obs, coupled: phases A and C through the
    tile-major route with the in-kernel decay, phase B from the composite's
    [wck, P] window (tests/test_production_grid.py:216-318)."""
    (_, texp, settings, cal, pts, state0), want = _jax_reference(
        "composite", coupled=True)
    assert (np.asarray(pts.coupling_end) >= 1).sum() > 500
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    metrics = tprod.RunMetrics()
    got = tprod.run_production_coupled(
        tm, texp, pts, cal, interop.state(state0, "cpu"), chunk_t=32,
        out_stride=out_stride, metrics=metrics)
    assert metrics.counters["coupling_reruns"] > 0
    _assert_match(got, want, out_stride)


@pytest.mark.parametrize("config", ["composite", "station_sky",
                                    "station_sky_setup"])
def test_port_coupled_window_slices_equal_one_launch(config, monkeypatch):
    """Phase B over point slices (a window budget of 0: each slice
    prepares its own points' window, from the expander's block of them)
    against one launch of the whole block, bit for bit: the grid + station
    composite and the stations with sky view on the table route (the
    reference switch: their own route, K5 fused, reads no table and takes
    one launch at any budget), whose window table is the points' prepared
    window; the stations also on ``_setup``'s inputs as they are, whose
    missing samples each slice's window prepares."""
    runs = []
    for budget in (4e9, 0):
        res, metrics, forcs = _run(config, budget, monkeypatch, table=True)
        assert metrics.counters["coupling_window_cached"] == (budget > 0)
        assert (len(forcs) == 1) == (budget > 0)
        assert not any(wk.is_fused(f) for f in forcs)
        runs.append(res)
    _assert_same(*runs)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_window_route_equals_table_route(case, monkeypatch):
    """Phase B of a K3 fused route goes through a FusedWindow, one call a
    block, at a budget of 0 too (no table, no slices), and its run equals
    the table route's (``force_window_table``) bit for bit."""
    got, metrics, forcs = _run(case, 0, monkeypatch)
    assert metrics.counters["coupling_window_cached"] == 1
    assert metrics.counters["coupling_reruns"] > 0
    assert len(forcs) == 1 and isinstance(forcs[0], tprod.FusedWindow)
    want, _, forcs = _run(case, 4e9, monkeypatch, table=True)
    assert len(forcs) == 1 and not wk.is_fused(forcs[0])
    _assert_same(got, want)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_window_kernel_args(case):
    """K5 fused's arguments on every configuration: ``fuse_args`` takes
    them (dtypes, contiguity, devices) with null pointers exactly for the
    channels a part lacks; each window chunk's grid rows are
    ``grid.window_rows`` at its first row (chunks of the table route's
    length from global row ws - 1), the traffic friction the window's
    rows; ``table()`` is the whole block's eager table."""
    tm, exp, pts, cal, st, anchors = _coupled_case(case)
    eng = tprod._Engine(tm, exp, pts, cal, st, anchors=anchors, chunk_t=16)
    assert eng.window_fused
    _, (ws, we_b) = window_span(tm.settings, pts)
    span = wk.WindowSpan(ws, we_b, tm.settings.sim_len, 6,
                         tm.settings.coupling_effect_reduction)
    src = eng.window_input(span, 0, eng.P_pad)
    assert isinstance(src, tprod.FusedWindow) and wk.is_fused(src)
    fa = sk.fuse_args(src, torch.device("cpu"))
    grid, station, _ = eng.fused_parts
    for i, n in enumerate(sk.RAW_FIELDS):
        assert bool(fa.g[i]) == (grid is not None and n in grid.var_names)
        assert bool(fa.s[i]) == (station is not None)
    assert bool(fa.anc_t) == (anchors is not None)
    assert bool(fa.sun) == eng.enable_sky
    a = src.kernel_args()
    tc = min(16, we_b - ws + 1)
    assert a["wtc"] == src.tc == tc and span.rows > tc
    assert a["wrows"].dtype == torch.int32 and a["wrows"].is_contiguous()
    want = [grid.window_rows(ws - 1 + k) if grid is not None else (0, 0)
            for k in range(0, span.rows, tc)]
    assert a["wrows"].tolist() == [list(r) for r in want]
    assert torch.equal(a["trf"], eng.trf_dev[ws - 1:we_b + 1])
    assert a["trf"].is_contiguous() and a["trf"].dtype == torch.float32
    table, fidx, trf = src.table()
    assert table.shape == (span.rows, sk.NCH, eng.P_pad)
    assert torch.equal(fidx, torch.arange(eng.P_pad, dtype=torch.int32))
    assert torch.equal(trf, a["trf"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_window_kernel_matches_plain_on_the_card(case, monkeypatch):
    """K5 fused on the card against its plain version (``window_reference``
    on the window's eager table) on the inputs a coupled run hands phase B
    (16-step chunks: the window spans two window chunks), bit for bit:
    rows, state, corrections, failed masks, re-runs and steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the window kernel runs only on "
                    "the card)")
    dev = torch.device("cuda", 0)
    tm, exp, pts, cal, st, anchors = _coupled_case(case)
    kept, window = [], wk.window

    def recorded(*a, **k):
        kept.append(((a[0].clone(), a[1].clone()) + a[2:], k))
        return window(*a, **k)
    monkeypatch.setattr(wk, "window", recorded)
    tprod.run_production_coupled(
        tmodel.Model(tm.settings, device=dev),
        exp.block(0, exp.num_points, dev), pts, cal, st, anchors=anchors,
        chunk_t=16, out_stride=6)
    (args, kw), = kept
    assert wk.is_fused(args[2])
    got = wk.window_cuda(*args, **kw)
    want = wk.window_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int(want.reruns.max()) > 0
    for name, x, y in zip(got._fields, got, want):
        assert torch.equal(x, y), name
