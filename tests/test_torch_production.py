"""The port's streamed station production engine against the JAX one
(``roadsurf_tpu.production.run_production``, Pallas kernel in interpret
mode): the fast path (station-level prepared channels, row gather) and the
generic path (per-point prep), on the same inputs, float32 on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import production as jprod
from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.forcing import RawForcing, relax_anchors
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod

torch.set_num_threads(1)


def _station_setup(S=5, P=1000, T=97, seed=11, use_relaxation=True):
    """tests/test_production.py:20-57 (sky view off: the port's engine
    does not run it yet)."""
    settings = ModelSettings(sim_len=T, dt=30.0,
                             use_relaxation=use_relaxation)
    model = Model(settings)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)

    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::97] = -1                      # a few out-of-radius points

    def expand(x, fill):
        v = np.asarray(x)[np.where(st_idx >= 0, st_idx, 0)]
        return np.where((st_idx >= 0)[:, None], v, fill)

    raw_pt = RawForcing(
        *(expand(getattr(raw_st, n), -9999 if n == "prec_phase"
                 else np.float32(-9999.9)) for n in RawForcing._fields))

    pts = default_point_params(P)
    pts = pts._replace(
        lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P))
    if use_relaxation:
        il = np.full(P, 25, np.int32)
        rows = np.arange(P)
        pts = pts._replace(
            init_len=il,
            tair_relax=np.asarray(raw_pt.tair)[rows, il] + 0.4,
            vz_relax=np.asarray(raw_pt.vz)[rows, il] + 0.1,
            rh_relax=np.asarray(raw_pt.rhz)[rows, il] - 2.0)
    return settings, model, raw_st, raw_pt, cal, pts, st_idx


def _station_prep_ctx(settings, model, raw_st, cal, pts):
    """tests/test_production.py:106-140: station-rank prep_ctx where every
    per-point value is st_pts[st_idx] (the fast-path contract)."""
    S = np.asarray(raw_st.tair).shape[0]
    rows = np.arange(S)
    il_st = np.full(S, int(np.asarray(pts.init_len)[0]), np.int32)
    raw_np = {n: np.asarray(getattr(raw_st, n)) for n in
              ("tair", "vz", "rhz")}
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    if settings.use_relaxation:
        il = il_st[0]
        st_pts1 = default_point_params(S + 1)._replace(
            init_len=app(il_st, il_st[0]).astype(np.int32),
            tair_relax=app(raw_np["tair"][rows, il] + 0.4, -9999.9),
            vz_relax=app(raw_np["vz"][rows, il] + 0.1, -9999.9),
            rh_relax=app(raw_np["rhz"][rows, il] - 2.0, -9999.9))
        vz_a = raw_np["vz"].copy()
        vz_a[:, 0] = np.maximum(vz_a[:, 0], 0.4)
        anch1 = (app(raw_np["tair"][rows, il - 1], -9999.9),
                 app(vz_a[rows, il - 1], -9999.9),
                 app(raw_np["rhz"][rows, il - 1], -9999.9))
    else:
        st_pts1 = default_point_params(S + 1)._replace(
            init_len=np.full(S + 1, int(np.asarray(pts.init_len)[0]),
                             np.int32))
        anch1 = None
    cs = np.asarray(pts.coupling_start)
    st_pts1 = st_pts1._replace(
        coupling_start=app(np.full(S, cs[0], np.int32), -99).astype(np.int32),
        coupling_end=app(np.full(S, np.asarray(pts.coupling_end)[0],
                                 np.int32), -99).astype(np.int32))
    return {"st_pts": st_pts1, "anchors": anch1, "settings": settings,
            "params": model.params, "hour": cal.hour,
            "t_total": settings.sim_len}


def _port_ctx(ctx):
    return dict(ctx, settings=interop.settings(ctx["settings"]),
                params=interop.params(ctx["params"]))


@pytest.mark.parametrize("path", ["fast", "generic"])
@pytest.mark.parametrize("chunk_t,out_stride", [(32, 6), (16, 7)])
def test_port_production_matches_jax(chunk_t, out_stride, path):
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup()
    T = settings.sim_len
    P = len(st_idx)
    mesh = make_mesh()
    p_pad = jprod.padded_points(P, mesh)
    assert p_pad == tprod.padded_points(P)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    ctx = (_station_prep_ctx(settings, model, raw_st, cal, pts)
           if path == "fast" else None)
    state0 = model.init(raw_pt, cal, dtype=jnp.float32)
    anchors = relax_anchors(raw_pt, pts)

    jexp = jprod.StationExpander(raw_st, st_idx_pad, mesh, chunk_t=chunk_t,
                                 prep_ctx=ctx, fused=False)
    assert (jexp.prep_data is not None) == (path == "fast")
    want = jprod.run_production(
        model, jexp, pts, cal, state0, anchors=anchors, mesh=mesh,
        chunk_t=chunk_t, out_stride=out_stride, inner_chunk_t=8,
        interpret=True)

    tmod = tmodel.Model(interop.settings(settings), device="cpu")
    texp = tprod.StationExpander(
        raw_st, st_idx_pad, "cpu", chunk_t=chunk_t,
        prep_ctx=_port_ctx(ctx) if ctx is not None else None)
    assert (texp.prep_data is not None) == (path == "fast")
    got = tprod.run_production(
        tmod, texp, pts, cal, interop.state(state0, device="cpu"),
        anchors=anchors, chunk_t=chunk_t, out_stride=out_stride)

    assert np.array_equal(got.out_steps, np.arange(0, T, out_stride))
    assert np.array_equal(got.out_steps, want.out_steps)
    np.testing.assert_allclose(got.fields["tsurf"], want.fields["tsurf"],
                               rtol=2e-5, atol=2e-4)
    for name in ("wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(got.fields[name], want.fields[name],
                                   rtol=2e-5, atol=2e-3, err_msg=name)
    np.testing.assert_allclose(got.state.tmp.numpy(),
                               np.asarray(want.state.tmp),
                               rtol=2e-5, atol=2e-4)
    assert np.array_equal(got.state.failed.numpy(),
                          np.asarray(want.state.failed))
    assert got.state.failed.numpy()[::97].all()   # out-of-radius points


def test_port_fast_path_matches_generic():
    """The port's two paths against each other, as
    tests/test_production.py:143-173 holds the JAX ones."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup()
    P = len(st_idx)
    st_idx_pad = np.pad(st_idx, (0, tprod.padded_points(P) - P),
                        constant_values=-1)
    ctx = _port_ctx(_station_prep_ctx(settings, model, raw_st, cal, pts))
    tmod = tmodel.Model(interop.settings(settings), device="cpu")
    state0 = tmod.init(raw_pt, cal, dtype=torch.float32)
    anchors = relax_anchors(raw_pt, pts)
    runs = {}
    for label, prep_ctx in (("generic", None), ("fast", ctx)):
        exp = tprod.StationExpander(raw_st, st_idx_pad, "cpu", chunk_t=32,
                                    prep_ctx=prep_ctx)
        runs[label] = tprod.run_production(
            tmod, exp, pts, cal, state0, anchors=anchors, chunk_t=32,
            out_stride=6)
    for name in runs["fast"].fields:
        np.testing.assert_allclose(
            runs["fast"].fields[name], runs["generic"].fields[name],
            rtol=2e-6, atol=2e-6, err_msg=name)
    np.testing.assert_allclose(runs["fast"].state.tmp.numpy(),
                               runs["generic"].state.tmp.numpy(),
                               rtol=2e-6, atol=2e-6)
    assert torch.equal(runs["fast"].state.failed,
                       runs["generic"].state.failed)


def test_port_production_matches_port_model_run():
    """The engine end to end against the port's plain Model.run (float32),
    the check chip_smoke.py repeats on the card."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = _station_setup(
        T=61)
    P = len(st_idx)
    st_idx_pad = np.pad(st_idx, (0, tprod.padded_points(P) - P),
                        constant_values=-1)
    ctx = _port_ctx(_station_prep_ctx(settings, model, raw_st, cal, pts))
    tmod = tmodel.Model(interop.settings(settings), device="cpu")
    final_ref, out_ref = tmod.run(raw_pt, pts, cal)
    exp = tprod.StationExpander(raw_st, st_idx_pad, "cpu", chunk_t=16,
                                prep_ctx=ctx)
    res = tprod.run_production(
        tmod, exp, pts, cal, tmod.init(raw_pt, cal, dtype=torch.float32),
        anchors=relax_anchors(raw_pt, pts), chunk_t=16, out_stride=7)
    want = np.arange(0, settings.sim_len, 7)
    assert np.array_equal(res.out_steps, want)
    np.testing.assert_allclose(res.fields["tsurf"],
                               out_ref.tsurf.numpy()[want],
                               rtol=2e-5, atol=2e-4)
    for name in ("wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(
            res.fields[name], getattr(out_ref, name).numpy()[want],
            rtol=2e-5, atol=2e-3, err_msg=name)
    assert torch.equal(res.state.failed, final_ref.failed)
