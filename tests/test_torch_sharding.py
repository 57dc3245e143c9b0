"""The port's point-block sharding (``parallel/sharding.py``, K4) and the
sharded production runs on CPU blocks (``devices=["cpu"] * n``):

 * ``scan_sharded`` on 1, 2, 4 and 8 blocks against one ``scan``, bit for
   bit, for K1, K2 with and without the decay and K3, and against the JAX
   package's ``pallas_scan_sharded(interpret=True)`` on its 8-device CPU mesh
   with the same packed inputs at the kernel tolerances
   (tests/test_pallas_step.py:47-65);
 * the divisibility errors, ``pad_points``, ``failure_stats``,
   ``check_missing_budget`` and the scan over ``shard_state`` /
   ``shard_prepared`` blocks against the JAX functions
   (tests/test_sharding.py);
 * ``run_production`` and ``run_production_coupled`` on 4 blocks against 1
   block, bit for bit: the station fast path, the grid, the composite and
   the station expander with sky view, a coupled case whose blocks have
   different windows, a point count whose padding fills a whole block; one
   station and one composite case against JAX's
   ``run_production(interpret=True)`` at rtol 2e-4 / atol 2e-3 with equal
   failed masks; ``drain="shard"`` in one process.

On the CPU every block is a multiple of 128 points, torch's vector body
covers whole blocks, and the n-block results equal the one-block ones bit for
bit with no exception.  The kernels run as their plain versions here; the
``cuda`` case holds the C++ sharded launch against one launch on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import production as jprod
from roadsurf_tpu.forcing import RawForcing, relax_anchors
from roadsurf_tpu.model import scan_steps
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.parallel import sharding as jsharding
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.forcing import Prepared
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.parallel import sharding
from roadsurf_tpu_torch.state import State

import test_torch_production as tp_station
import test_torch_production_coupled as tpc
import test_torch_production_grid as tp_grid
from test_torch_scan_kernel import (TM_IDS, TM_MODES, _assert_close, _inputs,
                                    _jax_packed, _tm_case)

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


def _shard_call(packed, kw, devices):
    """scan_sharded's per-block arguments from whole packed tensors."""
    tmp0, scal0, forc, trf, aux = sharding.shard_packed(
        *packed, devices, slim_trf=kw.get("slim_trf"),
        aux_rows=kw.get("aux_rows"))
    kw = dict(kw)
    if aux is not None:
        kw.update(slim_trf=trf, aux_rows=aux)
    return (tmp0, scal0, forc), kw


def _joined(results):
    """Per-block (tmp, scal, out) joined on the points axis."""
    return tuple(sharding.gather_blocks([r[k] for r in results])
                 for k in range(3))


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("mode,cofs", TM_MODES, ids=TM_IDS)
@pytest.mark.parametrize("tile", [False, True], ids=["pm", "tm"])
def test_scan_sharded_equals_one_scan(mode, cofs, tile, ndev):
    """K1, K2 (with and without the decay) and, tile-major at TP 128, K3:
    n blocks against one scan of the whole, bit for bit, on an offset chunk
    (1,024 points, 32 of 128 steps at global offset 40, stride 4)."""
    packed, kw, geo, tm = _tm_case(mode, cofs, nsteps=32)
    if tile:
        packed = (packed[0], packed[1], sk.to_tile_major(packed[2], 128))
    want = sk.scan(*packed, tm.cfg, tm.params, tm.grid, **geo, **kw)
    devices = ["cpu"] * ndev
    blocks, bkw = _shard_call(packed, kw, devices)
    assert all(t.shape[1] == 1024 // ndev for t in blocks[0])
    before = (sk.LAUNCHES_SHARDED, sk.LAUNCHES, sk.LAUNCHES_SLIM,
              sk.LAUNCHES_TM)
    got = sharding.scan_sharded(*blocks, tm.cfg, tm.params, tm.grid, devices,
                                **geo, **bkw)
    # CPU blocks take the plain version: no launch is counted
    assert (sk.LAUNCHES_SHARDED, sk.LAUNCHES, sk.LAUNCHES_SLIM,
            sk.LAUNCHES_TM) == before
    assert len(got) == ndev
    for g, w in zip(_joined(got), want):
        assert torch.equal(g, w)
    ref = sharding.scan_sharded_reference(*blocks, tm.cfg, tm.params,
                                          tm.grid, **geo, **bkw)
    for g, w in zip(_joined(ref), want):
        assert torch.equal(g, w)


def test_scan_sharded_matches_pallas_sharded():
    """tests/test_sharding.py:65-99 on both sides: K1 on 1,024 points x 32
    steps, stride 4, JAX over its 8-device mesh in interpret mode, the port
    over 8 CPU blocks, the same packed inputs."""
    model, tm, pts, prep, state = _inputs(sim_len=32, seed=7)
    mesh = jsharding.make_mesh()
    assert len(mesh.devices.ravel()) == 8
    jt, js, jout = jsharding.pallas_scan_sharded(
        *_jax_packed(prep, state, pts), model.cfg, model.params, model.grid,
        mesh, out_stride=4, chunk_t=16, interpret=True)
    devices = ["cpu"] * 8
    blocks = interop.packed_blocks(*_jax_packed(prep, state, pts), devices)
    assert blocks[3] is None and blocks[4] is None
    tt, ts, tout = _joined(sharding.scan_sharded(
        *blocks[:3], tm.cfg, tm.params, tm.grid, devices, out_stride=4))
    assert tout.shape == jout.shape
    _assert_close(tout, jout, tt, jt)
    assert np.array_equal(ts.numpy()[sk.R_FAILED],
                          np.asarray(js)[ps.R_FAILED])


def test_divisibility_errors():
    """The three errors of pallas_scan_sharded (sharding.py:97-113,
    :140-142), on whole tensors and on per-block lists."""
    packed, kw, geo, tm = _tm_case("k1", False, nsteps=8)
    args = (tm.cfg, tm.params, tm.grid)
    with pytest.raises(ValueError, match="must divide the devices"):
        sharding.shard_packed(*packed, ["cpu"] * 3)
    with pytest.raises(ValueError, match="kernel lane width"):
        sharding.shard_packed(*packed, ["cpu"] * 16)       # 64-point blocks
    f4 = sk.to_tile_major(packed[2], 512)
    with pytest.raises(ValueError, match="multiple of tile_p"):
        sharding.shard_packed(packed[0], packed[1], f4, ["cpu"] * 4)
    # per-block lists: a block too few, unequal blocks, a 64-point block
    blocks, _ = _shard_call(packed, {}, ["cpu"] * 4)
    with pytest.raises(ValueError, match="must divide the devices"):
        sharding.scan_sharded(*blocks, *args, ["cpu"] * 3, **geo)
    uneven = [[b[0][:, :128].contiguous()] + list(b[1:])
              if b is blocks[0] else b for b in blocks]
    with pytest.raises(ValueError, match="must divide the devices"):
        sharding.scan_sharded(*uneven, *args, ["cpu"] * 4, **geo)
    small = [[x.narrow(x.dim() - 1, 0, 64).contiguous() for x in b]
             for b in blocks]
    with pytest.raises(ValueError, match="kernel lane width"):
        sharding.scan_sharded(*small, *args, ["cpu"] * 4, **geo)
    with pytest.raises(ValueError, match="at least one device"):
        sharding.make_mesh([])


def test_pad_points_matches_jax():
    model, tm, pts, prep, state = _inputs(npoints=13, sim_len=16)
    want, n_want = jsharding.pad_points(state, 8)
    got, n_got = sharding.pad_points(interop.state(state, "cpu"), 8)
    assert n_got == n_want == 13
    assert isinstance(got, State)
    for name in State._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.tmp.shape[0] == 16
    # axis 1 (a [T, P] channel), and a leaf without that axis stays
    padded, n = sharding.pad_points({"a": np.ones((3, 5)), "t": np.ones(3)},
                                    4, axis=1)
    assert n == 5 and padded["a"].shape == (3, 8) and padded["t"].shape == (3,)


def test_failure_stats_and_budget_match_jax():
    mesh = jsharding.make_mesh()
    failed = np.zeros(16, bool)
    failed[[3, 9]] = True
    jf = jax.device_put(jnp.asarray(failed), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("points")))
    jcnt, jratio = jsharding.failure_stats(jf, mesh)
    blocks = [torch.tensor(failed[i:i + 2]) for i in range(0, 16, 2)]
    for arg in (blocks, torch.tensor(failed), failed):
        cnt, ratio = sharding.failure_stats(arg, ["cpu"] * 8)
        assert cnt == int(jcnt) == 2
        assert ratio == pytest.approx(float(jratio)) == 2 / 16
    for budget in (0.10, 0.50):
        assert (sharding.check_missing_budget(blocks, budget)
                == jsharding.check_missing_budget(jf, budget, mesh))
    assert sharding.check_missing_budget(blocks, 0.10) is True


def test_scan_over_sharded_blocks_matches_jax():
    """tests/test_sharding.py:27-49: the port's Model scan over the blocks
    of shard_state / shard_prepared equals its scan of the whole bit for
    bit, and JAX's sharded scan_steps at float32 round-off."""
    model, tm, pts, prep, state = _inputs(npoints=16, sim_len=61, seed=2)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    mesh = jsharding.make_mesh()
    fn = jax.jit(lambda st, pr, sw, lw: scan_steps(
        st, pr, sw, lw, obs, model.cfg, model.grid, model.params))
    jfinal, jout = fn(jsharding.shard_state(state, mesh),
                      jsharding.shard_prepared(prep, mesh), ones, ones)

    devices = ["cpu"] * 8
    tstate, tprep = interop.state(state, "cpu"), interop.prepared(prep, "cpu")
    st_b = sharding.shard_state(tstate, devices)
    pr_b = sharding.shard_prepared(tprep, devices)
    assert len(st_b) == len(pr_b) == 8
    assert isinstance(st_b[0], State) and isinstance(pr_b[0], Prepared)
    assert st_b[3].tmp.shape[0] == 2 and pr_b[3].tair.shape == (61, 2)
    assert pr_b[3].trf_fric.shape == (61,)            # [T]: replicated
    tobs = torch.tensor(np.asarray(pts.coupling_tsurf, np.float32))

    def run(st, pr, ob):
        one = torch.ones_like(pr.tair)
        return tmodel.scan_steps(st, pr, one, one, ob, tm.cfg, tm.grid,
                                 tm.params)
    whole_f, whole_o = run(tstate, tprep, tobs)
    parts = [run(s, p, tobs[2 * b:2 * b + 2])
             for b, (s, p) in enumerate(zip(st_b, pr_b))]
    tsurf = torch.cat([o.tsurf for _, o in parts], dim=1)
    tmp = torch.cat([f.tmp for f, _ in parts])
    # 2-point blocks run torch's scalar tail, the whole its vector body:
    # an exp or log may differ in the last bit, so the port's block scan
    # is held to the whole at float32 round-off here
    np.testing.assert_allclose(tsurf.numpy(), whole_o.tsurf.numpy(),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tmp.numpy(), whole_f.tmp.numpy(),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tsurf.numpy(), np.asarray(jout.tsurf),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(tmp.numpy(), np.asarray(jfinal.tmp),
                               rtol=2e-5, atol=2e-4)


# ---------------------------------------------------------------------------
# the sharded production runs
# ---------------------------------------------------------------------------

def _assert_same_run(a, b):
    assert np.array_equal(a.out_steps, b.out_steps)
    for name in NAMES:
        np.testing.assert_array_equal(a.fields[name], b.fields[name],
                                      err_msg=name)
    for name in State._fields:
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), \
            name
    assert a.point_range == b.point_range


def _station_runs(P, ndev, path="fast", coupled=False, T=61, **run_kw):
    """The station configuration of tests/test_torch_production.py over
    ``ndev`` CPU blocks: (result, the JAX-side pieces)."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = \
        tp_station._station_setup(P=P, T=T)
    p_pad = tprod.padded_points(P, ndev)
    st_idx_pad = np.pad(st_idx, (0, p_pad - P), constant_values=-1)
    ctx = (tp_station._station_prep_ctx(settings, model, raw_st, cal, pts)
           if path == "fast" else None)
    tmod = tmodel.Model(interop.settings(settings), device="cpu")
    state0 = tmod.init(raw_pt, cal, dtype=torch.float32)
    exp = tprod.StationExpander(
        raw_st, st_idx_pad, "cpu", chunk_t=16,
        prep_ctx=tp_station._port_ctx(ctx) if ctx else None)
    res = tprod.run_production(
        tmod, exp, pts, cal, state0, anchors=relax_anchors(raw_pt, pts),
        devices=["cpu"] * ndev, chunk_t=16, out_stride=7, **run_kw)
    return res, (settings, model, raw_st, raw_pt, cal, pts, st_idx, ctx)


@pytest.mark.parametrize("path", ["fast", "generic"])
def test_station_blocks_equal_one_block(path):
    """1,000 points on 4 blocks (256 each, the last with 232 real points and
    24 padded) against 1 block of 1,024, bit for bit."""
    one, _ = _station_runs(1000, 1, path)
    four, _ = _station_runs(1000, 4, path)
    assert one.point_range == four.point_range == (0, 1000)
    assert one.fields["tsurf"].shape == (9, 1000)
    _assert_same_run(four, one)
    assert four.state.failed.numpy()[::97].all()     # out-of-radius points


def test_padding_fills_a_whole_block():
    """600 points on 8 blocks pad to 1,024: blocks 5-7 hold padding alone
    (and block 4 88 real points); the result equals the one-block run of
    640 and drops every padded point."""
    one, _ = _station_runs(600, 1)
    eight, _ = _station_runs(600, 8)
    assert tprod.padded_points(600, 8) == 1024
    assert eight.fields["tsurf"].shape == (9, 600)
    assert eight.state.tmp.shape[0] == 600
    _assert_same_run(eight, one)


def test_station_blocks_match_jax():
    """The 4-block station fast path against JAX's run_production over its
    8-device mesh (interpret mode), at rtol 2e-4 / atol 2e-3 with equal
    failed masks."""
    got, (settings, model, raw_st, raw_pt, cal, pts, st_idx, ctx) = \
        _station_runs(1000, 4)
    mesh = jsharding.make_mesh()
    p_pad = jprod.padded_points(len(st_idx), mesh)
    assert p_pad == tprod.padded_points(len(st_idx), 8) == 1024
    jexp = jprod.StationExpander(
        raw_st, np.pad(st_idx, (0, p_pad - len(st_idx)), constant_values=-1),
        mesh, chunk_t=16, prep_ctx=ctx, fused=False)
    want = interop.production_result(jprod.run_production(
        model, jexp, pts, cal, model.init(raw_pt, cal, dtype=jnp.float32),
        anchors=relax_anchors(raw_pt, pts), mesh=mesh, chunk_t=16,
        out_stride=7, inner_chunk_t=8, interpret=True))
    assert isinstance(want, tprod.ProductionResult)
    assert want.point_range == got.point_range == (0, 1000)
    assert np.array_equal(got.out_steps, want.out_steps)
    for name in NAMES:
        np.testing.assert_allclose(got.fields[name], want.fields[name],
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    assert torch.equal(got.state.failed, want.state.failed)
    np.testing.assert_allclose(got.state.tmp.numpy(), want.state.tmp.numpy(),
                               rtol=2e-4, atol=2e-3)


def test_drain_shard_in_one_process():
    """drain="shard" in one process covers every point: the gather run's
    values with point_range (0, n_real)."""
    gather, _ = _station_runs(1000, 4)
    shard, _ = _station_runs(1000, 4, drain="shard")
    assert shard.point_range == (0, 1000)
    _assert_same_run(shard, gather)
    with pytest.raises(ValueError, match="drain must be"):
        _station_runs(1000, 4, drain="scatter")


@pytest.mark.parametrize("config,tile_p", [
    ("grid", 256), ("grid", 1024), ("composite", 1024),
    ("station_sky", 1024)])
def test_tile_major_blocks_equal_one_block(config, tile_p, monkeypatch):
    """The grid, the grid+station composite and the station expander with
    sky view (K3's route) on 4 blocks against 1, bit for bit, uncoupled and
    coupled (each point's window from its own last valid obs).  With
    TILE_P 256 the whole run's tiles are the blocks' (the grid's series are
    cut as views); with the default 1024 a block lays its own out anew."""
    monkeypatch.setattr(tprod, "TILE_P", tile_p)
    _, exp, settings, cal, pts, state0 = tp_grid._setup(
        config, T=49, use_coupling=True, with_jax=False)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    st = interop.state(state0, "cpu")
    assert (np.asarray(pts.coupling_end) > 0).any()
    for run in (tprod.run_production, tprod.run_production_coupled):
        one, four = (run(tm, exp, pts, cal, st, devices=["cpu"] * n,
                         chunk_t=32, out_stride=6) for n in (1, 4))
        _assert_same_run(four, one)
    eng = tprod._Blocks(tm, exp, pts, cal, st, devices=["cpu"] * 4,
                        chunk_t=32).engines[1]
    assert eng.tile_major and eng.tile_geom == (256 // min(tile_p, 256),
                                                min(tile_p, 256))
    assert eng.enable_sky == (config == "station_sky")


def _coupled_blocks_setup(P=1024, T=97):
    """tests/test_torch_production_coupled.py's station setup with a
    window of its own for every station, and every quarter of the points
    fed by its own stations: block 0 of 4 by station 2 alone, which has no
    obs (no coupled point), the others by stations whose windows start and
    end at different steps."""
    settings, raw_st, _, cal, _, _, ctx = tpc._coupled_setup(P=P, T=T)
    S = np.asarray(raw_st.tair).shape[0]
    ws_st = np.array([12, 8, 11, 15, 10], np.int32)
    we_st = np.array([30, 24, 40, 40, 36], np.int32)
    rng = np.random.default_rng(5)
    obs_st = (np.asarray(raw_st.tair)[np.arange(S), we_st - 1]
              - rng.uniform(0.5, 2.5, S))
    obs_st[2] = -9999.9
    choice = ((2,), (0,), (1, 3), (4, 0))
    st_idx = np.concatenate([rng.choice(c, P // 4) for c in choice])
    raw_pt = RawForcing(*(np.asarray(getattr(raw_st, n))[st_idx]
                          for n in RawForcing._fields))
    pts = default_point_params(P)._replace(
        lat=58.0 + rng.uniform(0, 6, P), lon=20.0 + rng.uniform(0, 10, P),
        coupling_start=ws_st[st_idx], coupling_end=we_st[st_idx],
        coupling_tsurf=obs_st[st_idx])
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    ctx = dict(ctx, st_pts=ctx["st_pts"]._replace(
        coupling_start=app(ws_st, -99).astype(np.int32),
        coupling_end=app(we_st, -99).astype(np.int32),
        coupling_tsurf=app(obs_st, -9999.9)))
    return settings, raw_st, raw_pt, cal, pts, st_idx, ctx


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "generic"])
def test_coupled_station_blocks_differ_in_windows(fast):
    """The coupled station run (fast: K2 with the in-kernel decay; generic:
    K3 over the per-point prep) on 4 blocks against 1, bit for bit, where
    block 0 has no coupled point and the others' windows start and end at
    different steps: every block steps the whole run's phase split, and
    the per-block pass narrowing of phase B changes nothing."""
    setup = _coupled_blocks_setup()
    runs = {n: tpc._port_run(setup, fast=fast, devices=["cpu"] * n)
            for n in (1, 4)}
    _assert_same_run(runs[4][0], runs[1][0])
    c1, c4 = runs[1][1].counters, runs[4][1].counters
    assert c1["coupling_reruns"] > 0 and c1["coupling_points"] == 768
    for name in ("coupling_window_steps", "coupling_points",
                 "coupling_failed", "coupling_succeeded"):
        assert c4[name] == c1[name], name
    assert c4["coupling_window_steps"] == 40 - 8 + 1
    assert c4["coupling_reruns"] == c1["coupling_reruns"]
    # a block passes over its own points' spans only: never more rows
    assert c4["coupling_window_rows"] < 4 * c1["coupling_window_rows"]
    assert (c4["blocks"], c1["blocks"]) == (4, 1)


def test_composite_blocks_match_jax():
    """The 4-block composite run against JAX's run over its 8-device mesh
    (interpret mode) at rtol 2e-4 / atol 2e-3 with equal failed masks."""
    (_, texp, settings, cal, pts, state0), want = tp_grid._jax_reference(
        "composite")
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    got = tprod.run_production(tm, texp, pts, cal,
                               interop.state(state0, "cpu"),
                               devices=["cpu"] * 4, chunk_t=32, out_stride=6)
    tp_grid._assert_match(got, want, 6)


def test_expander_blocks_hold_their_points():
    """An expander's block emits the whole's windows over its points, and
    its host-side values are the whole's rows."""
    _, exp, settings, cal, pts, _ = tp_grid._setup("composite", T=49,
                                                   with_jax=False)
    blk = exp.block(256, 512, "cpu")
    assert blk.num_points == 256 and blk.tile_geom == (1, 256)
    for t0 in (0, 17):
        whole, part = exp.window(t0, 32), blk.window(t0, 32)
        for n in whole._fields:
            assert torch.equal(getattr(part, n), getattr(whole, n)[:, 256:512])
    for n, v in exp.first_host.items():
        np.testing.assert_array_equal(blk.first_host[n], v[256:512])
    sel = np.arange(0, 49, 8)
    whole, part = exp.host_at(sel), blk.host_at(sel)
    for n in whole:
        np.testing.assert_array_equal(part[n], whole[n][256:512])


def test_host_shard_joins_contiguous_blocks():
    a, b = torch.arange(6.).reshape(2, 3), torch.arange(6., 12.).reshape(2, 3)
    loc, rng = tprod.host_shard([(b, (131, 134)), (a, (128, 131))], axis=-1)
    assert rng == (128, 134)
    np.testing.assert_array_equal(loc, np.concatenate([a, b], axis=1))
    with pytest.raises(ValueError, match="non-contiguous"):
        tprod.host_shard([(a, (0, 3)), (b, (4, 7))], axis=-1)


def test_padded_points_and_tile_geometry_over_blocks():
    mesh = jsharding.make_mesh()
    for n in (1, 1000, 1024, 1025, 5000):
        assert tprod.padded_points(n, 8) == jprod.padded_points(n, mesh)
    assert tprod.tile_geometry(8192, 8) == (8, 1024)
    assert tprod.tile_geometry(4096, 8) == (8, 512)
    assert tprod.tile_geometry(3072, 8) == (8, 384)
    assert tprod.tile_geometry(1024, 3) is None
    assert tprod.tile_geometry(1024 + 512, 8) is None     # 192-point blocks
    for n, ndev in ((8192, 8), (4096, 8), (3072, 8)):
        nt, tpw = tprod.tile_geometry(n, ndev)
        assert jprod.tile_geometry(n, mesh) == (nt, tpw // 128)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cofs", TM_MODES, ids=TM_IDS)
def test_sharded_launch_equals_one_launch_on_cuda(mode, cofs):
    """The C++ sharded launch (4 blocks of one card, each on its own
    stream) against one launch of the whole, bit for bit, point-major and
    tile-major; one sharded launch and four launches of the mode are
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    packed, kw, geo, tm = _tm_case(mode, cofs, npoints=4096)
    dev = torch.device("cuda", 0)
    cuda = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x
    kw = {k: cuda(v) for k, v in kw.items()}
    for tile in (False, True):
        forc = sk.to_tile_major(packed[2], 256) if tile else packed[2]
        whole = (cuda(packed[0]), cuda(packed[1]), cuda(forc))
        want = sk.scan(*whole, tm.cfg, tm.params, tm.grid, **geo, **kw)
        mesh = sharding.make_mesh([dev] * 4)
        blocks, bkw = _shard_call(whole, kw, mesh)
        before = (sk.LAUNCHES_SHARDED,
                  sk.LAUNCHES + sk.LAUNCHES_SLIM + sk.LAUNCHES_TM)
        got = sharding.scan_sharded(*blocks, tm.cfg, tm.params, tm.grid,
                                    mesh, **geo, **bkw)
        torch.cuda.synchronize()
        assert (sk.LAUNCHES_SHARDED,
                sk.LAUNCHES + sk.LAUNCHES_SLIM + sk.LAUNCHES_TM) == (
                    before[0] + 1, before[1] + 4)
        for g, w in zip(_joined(got), want):
            assert torch.equal(g.view(torch.int32),
                               w.cpu().view(torch.int32))
