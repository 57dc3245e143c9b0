"""The port's coupled production run (``run_production_coupled``: streamed
kernel phases A and C around the iteration-major window) against the JAX
package's, on the setups of tests/test_production.py:279-343 and
tests/test_production_edges.py:85-112; and the port's own routes against
each other: the slim kernel mode (K2, in-kernel coefficient decay) against
K1 fed forcing.cof_window channels, and the station-prepared phase-B window
provider against the generic per-point one, bit for bit (the counterparts
of tests/test_production_fused.py:74-136).  float32 on both sides; the
kernels run as their plain versions on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import production as jprod
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import RawForcing
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


def _coupled_setup(S=5, P=640, T=97, seed=23, ws=11, we=40):
    """tests/test_production.py:20-57 and :279-294 (relaxation and sky view
    off), with station-derived obs (the fast-path contract,
    tests/test_production_fused.py:79-85): per-point coupling window
    [ws, we], obs target below the station's air temperature at we so the
    control iterates; station 2 has no obs (never coupled)."""
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=False,
                             use_coupling=True)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)
    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::97] = -1                      # a few out-of-radius points
    ok = st_idx >= 0
    sidx = np.where(ok, st_idx, 0)
    raw_pt = RawForcing(*(
        np.where(ok[:, None], np.asarray(getattr(raw_st, n))[sidx],
                 -9999 if n == "prec_phase" else np.float32(-9999.9))
        for n in RawForcing._fields))
    rng5 = np.random.default_rng(5)
    obs_st = np.asarray(raw_st.tair)[:, we - 1] - rng5.uniform(0.5, 2.5, S)
    obs_st[2] = -9999.9
    pts = default_point_params(P)._replace(
        lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P),
        coupling_start=np.full(P, ws, np.int32),
        coupling_end=np.full(P, we, np.int32),
        coupling_tsurf=np.where(ok, obs_st[sidx], -9999.9))
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        init_len=np.full(S + 1, 1, np.int32),
        coupling_start=app(np.full(S, ws, np.int32), -99).astype(np.int32),
        coupling_end=app(np.full(S, we, np.int32), -99).astype(np.int32),
        coupling_tsurf=app(obs_st, -9999.9))
    ctx = {"st_pts": st_pts, "anchors": None, "settings": settings,
           "params": Model(settings).params, "hour": cal.hour,
           "t_total": T}
    return settings, raw_st, raw_pt, cal, pts, st_idx, ctx


def _padded(st_idx):
    P = len(st_idx)
    return np.pad(st_idx, (0, tprod.padded_points(P) - P),
                  constant_values=-1)


def _port_ctx(ctx):
    return dict(ctx, settings=interop.settings(ctx["settings"]),
                params=interop.params(ctx["params"]))


def _port_run(setup, chunk_t=32, out_stride=6, fast=True, slim=True,
              **kw):
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = setup
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    exp = tprod.StationExpander(raw_st, _padded(st_idx), "cpu",
                                chunk_t=chunk_t,
                                prep_ctx=_port_ctx(ctx) if fast else None,
                                slim=slim)
    metrics = tprod.RunMetrics()
    res = tprod.run_production_coupled(
        tm, exp, pts, cal, tm.init(raw_pt, cal, dtype=torch.float32,
                                   pts=pts),
        chunk_t=chunk_t, out_stride=out_stride, metrics=metrics, **kw)
    return res, metrics


def _assert_same(a, b):
    for name in NAMES:
        np.testing.assert_array_equal(a.fields[name], b.fields[name],
                                      err_msg=name)
    np.testing.assert_array_equal(a.state.tmp.numpy(), b.state.tmp.numpy())
    assert torch.equal(a.state.failed, b.state.failed)


@pytest.mark.parametrize("path", ["fast", "generic"])
@pytest.mark.parametrize("out_stride", [1, 6])
def test_port_coupled_matches_jax(out_stride, path):
    setup = _coupled_setup()
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = setup
    T = settings.sim_len
    model = Model(settings)
    mesh = make_mesh()
    jexp = jprod.StationExpander(
        raw_st, np.pad(st_idx, (0, jprod.padded_points(len(st_idx), mesh)
                                - len(st_idx)), constant_values=-1),
        mesh, chunk_t=32, prep_ctx=ctx if path == "fast" else None)
    want = jprod.run_production_coupled(
        model, jexp, pts, cal, model.init(raw_pt, cal, dtype=jnp.float32,
                                          pts=pts),
        mesh=mesh, chunk_t=32, out_stride=out_stride, inner_chunk_t=8,
        interpret=True)
    got, metrics = _port_run(setup, out_stride=out_stride,
                             fast=path == "fast")
    assert metrics.counters["coupling_reruns"] > 0
    assert metrics.counters["coupling_window_steps"] == 30
    assert np.array_equal(got.out_steps, np.arange(0, T, out_stride))
    assert np.array_equal(got.out_steps, want.out_steps)
    for name in NAMES:
        np.testing.assert_allclose(got.fields[name], want.fields[name],
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    assert np.array_equal(got.state.failed.numpy(),
                          np.asarray(want.state.failed))


def test_port_slim_matches_packed_bitwise():
    """K2 with the in-kernel decay against K1 fed cof_window channels, over
    the whole coupled run (tests/test_production_fused.py:74-102)."""
    setup = _coupled_setup()
    slim, m = _port_run(setup, slim=True)
    packed, _ = _port_run(setup, slim=False)
    assert m.counters["coupling_reruns"] > 0
    _assert_same(slim, packed)


def test_port_fast_provider_matches_generic_bitwise():
    """The station-prepared phase-B provider against the per-point prep,
    chunk by chunk over the window, then whole runs with the K1 route on
    both sides (tests/test_production_fused.py:105-136)."""
    setup = _coupled_setup()
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = setup
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    state0 = tm.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    engines = [tprod._Engine(tm, tprod.StationExpander(
        raw_st, _padded(st_idx), "cpu", chunk_t=32, prep_ctx=c), pts, cal,
        state0, chunk_t=32) for c in (_port_ctx(ctx), None)]
    fast, generic = engines
    for t0 in range(10, 42, 16):
        a = fast.expander.prepared_window(t0, 16)
        b = tprod.prepare_window(
            generic.expander.window(t0, 16), generic.pts_dev,
            generic.hour_dev[t0:t0 + 16], generic.settings, generic.params,
            t_offset=t0, t_total=generic.T, enable_skyview=False)
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), (t0, name)
    packed, _ = _port_run(setup, slim=False)
    gen, _ = _port_run(setup, fast=False)
    _assert_same(packed, gen)


def test_port_window_cache_is_transparent(monkeypatch):
    """The window's forcing table in one piece and in point slices (a
    budget of 0) give the same run, off the fast path (K3 fused's route,
    phase B on the window's eager table through the reference switch),
    whose table the budget holds (the fast path's is a view of the station
    channels, and K5 fused reads none)."""
    monkeypatch.setattr(tprod._Engine, "force_window_table", True)
    setup = _coupled_setup()
    on, m_on = _port_run(setup, fast=False)
    off, m_off = _port_run(setup, fast=False, wcache_bytes=0)
    assert m_on.counters["coupling_window_cached"] == 1
    assert m_off.counters["coupling_window_cached"] == 0
    _assert_same(on, off)


@pytest.mark.parametrize("check", ["coupling activity", "relax validity"])
def test_fast_contract_names_the_point(check):
    """A station fast-path expander whose points break a joint part of the
    contract (coupling activity: coupling_end and coupling_tsurf; relax
    validity: the three relaxation fields) raises the ValueError that names
    the point, its station row and the fields' values on both sides."""
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = _coupled_setup()
    bad = int(np.flatnonzero((st_idx >= 0) & (st_idx != 2))[3])
    if check == "coupling activity":
        obs = np.asarray(pts.coupling_tsurf).copy()
        obs[bad] = -9999.9                 # its station has obs
        pts = pts._replace(coupling_tsurf=obs)
        fields = ("coupling_end", "coupling_tsurf")
    else:
        fields = ("tair_relax", "vz_relax", "rh_relax")
        pts = pts._replace(**{
            n: np.where(np.arange(len(st_idx)) == bad, v,
                        np.asarray(getattr(pts, n), np.float64))
            for n, v in zip(fields, (1.0, 2.0, 80.0))})
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    exp = tprod.StationExpander(raw_st, _padded(st_idx), "cpu", chunk_t=32,
                                prep_ctx=_port_ctx(ctx))
    state0 = tm.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    with pytest.raises(ValueError) as err:
        tprod.run_production_coupled(tm, exp, pts, cal, state0, chunk_t=32)
    msg = str(err.value)
    assert f"at point {bad} ({check}:" in msg, msg
    assert f"st_pts[{st_idx[bad]}]" in msg, msg
    assert all(msg.count(n) == 2 for n in fields), msg


def test_port_no_window_falls_back():
    """No coupled point: the coupled run is the uncoupled stream
    (tests/test_production.py:326-343)."""
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = _coupled_setup()
    pts = pts._replace(coupling_tsurf=np.full(len(st_idx), -9999.9))
    ctx["st_pts"] = ctx["st_pts"]._replace(
        coupling_tsurf=np.full(len(ctx["st_pts"].lat), -9999.9))
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    state0 = tm.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    exp = tprod.StationExpander(raw_st, _padded(st_idx), "cpu", chunk_t=32,
                                prep_ctx=_port_ctx(ctx))
    metrics = tprod.RunMetrics()
    res = tprod.run_production_coupled(tm, exp, pts, cal, state0,
                                       chunk_t=32, out_stride=6,
                                       metrics=metrics)
    unc = tprod.run_production(tm, exp, pts, cal, state0, chunk_t=32,
                               out_stride=6)
    assert "coupling_reruns" not in metrics.counters
    _assert_same(res, unc)


@pytest.mark.parametrize("T,chunk_t,ws,we,out_stride", [
    (67, 16, 7, 23, 11),    # window straddles the 16-step chunk boundary
    (47, 32, 30, 45, 46),   # phase C is a 2-step stub; single late out row
])
def test_port_coupled_window_offsets(T, chunk_t, ws, we, out_stride):
    """tests/test_production_edges.py:85-112 (192 points, 4 stations):
    phase boundaries at chunk offsets, against the JAX per-point-PC
    engine, float32."""
    setup = _coupled_setup(S=4, P=192, T=T, seed=11, ws=ws, we=we)
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = setup
    final_pc, out_pc = Model(settings).run_coupled(
        RawForcing(*(np.asarray(x) for x in raw_pt)), pts, cal,
        out_stride=out_stride)
    out_pc = np.asarray(out_pc)
    got, metrics = _port_run(setup, chunk_t=chunk_t, out_stride=out_stride)
    assert metrics.counters["coupling_window_steps"] == min(we, T - 1) - ws + 1
    assert np.array_equal(got.out_steps, np.arange(0, T, out_stride))
    for fi, name in enumerate(NAMES):
        np.testing.assert_allclose(got.fields[name], out_pc[:, :, fi],
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    assert np.array_equal(got.state.failed.numpy(),
                          np.asarray(final_pc.failed))
