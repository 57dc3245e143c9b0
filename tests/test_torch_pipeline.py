"""The streamed engine's pipelined dispatch (``production._Blocks.stream``,
the JAX engine's two-deep pipeline, roadsurf_tpu/production.py:1826-1856)
and K4's reused outputs (``parallel.sharding.scan_sharded(out=...)``).

``production.PIPELINE_DEPTH`` 2 (chunk k issued before chunk k-1 is drained)
against 1 (each chunk drained before the next is issued), bit for bit in
every output row, the steps, the final state and the failed mask: the
station routes (K2, K1 with ``slim=False``, the generic per-point prep), a
grid through K3 fused's plain version, a composite of two station networks
over a grid on K3 (the eager prep), a chunk length that does not divide the
run and chunks that hold no output row, two blocks, ``drain="shard"``, and
the coupled run with the window's ends inside chunks.  The order of the
host's work is logged (each sharded launch issued, each chunk drained): at
depth 2 chunk k-1 is drained only after chunk k is issued, and never more
than two chunks are pending.  A failed host copy of a chunk's rows fails
the run.  On the CPU the device copies
are synchronous and no event exists, but the same code runs in the same
order; the ``cuda`` case runs the copy streams, events and pinned buffers
on a card.
"""
import numpy as np
import pytest
import torch

from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.parallel import sharding
from roadsurf_tpu_torch.state import State

import test_torch_production_coupled as tpc
import test_torch_production_grid as tp_grid
import test_torch_station_order as tso
from test_torch_scan_kernel import TM_IDS, TM_MODES, _tm_case

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


def _assert_bitwise(got, want):
    """Two production results, bit for bit: steps, point range, every
    output row of every field, every leaf of the final state (the failed
    mask among them)."""
    assert np.array_equal(got.out_steps, want.out_steps)
    assert got.point_range == want.point_range
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    for name in NAMES:
        np.testing.assert_array_equal(bits(got.fields[name]),
                                      bits(want.fields[name]), err_msg=name)
    for name in State._fields:
        assert torch.equal(getattr(got.state, name),
                           getattr(want.state, name)), name


def _depths(monkeypatch, run):
    """``run()`` at PIPELINE_DEPTH 1 and at 2."""
    out = []
    for depth in (1, 2):
        monkeypatch.setattr(tprod, "PIPELINE_DEPTH", depth)
        out.append(run())
    return out


def _station_run(case, devices, chunk_t, out_stride, device="cpu", **kw):
    """``tests/test_torch_station_order._run`` on any device list."""
    P = len(case["st_idx"])
    p_pad = tprod.padded_points(P, len(devices))
    exp = tprod.StationExpander(
        case["raw_st"], np.pad(case["st_idx"], (0, p_pad - P),
                               constant_values=-1),
        device, chunk_t=chunk_t, prep_ctx=case["ctx"], slim=case["slim"])
    return tprod.run_production(
        case["tm"], exp, case["pts"], case["cal"], case["state0"],
        anchors=case["anchors"], devices=devices, chunk_t=chunk_t,
        out_stride=out_stride, **kw)


@pytest.mark.parametrize("chunk_t,out_stride", [(16, 7), (8, 20)],
                         ids=["t16-s7", "t8-s20"])
@pytest.mark.parametrize("route", ["k2", "k1", "generic"])
def test_station_routes_depth_2_equals_depth_1(route, chunk_t, out_stride,
                                               monkeypatch):
    """K2, K1 and the generic route, 512 points x 49 steps: chunk 16 does
    not divide 49 and its last chunk (step 48) holds no output row at
    stride 7; at chunk 8 and stride 20 every other chunk holds none."""
    case = tso._case(route)
    one, two = _depths(monkeypatch, lambda: _station_run(
        case, ["cpu"], chunk_t, out_stride))
    assert len(one.out_steps) == len(range(0, 49, out_stride))
    _assert_bitwise(two, one)


@pytest.mark.parametrize("drain", ["gather", "shard"])
def test_two_blocks_depth_2_equals_depth_1(drain, monkeypatch):
    """K2 on two blocks (each on its own, in station order), drained
    gathered and per process."""
    case = tso._case("k2", P=1000)
    one, two = _depths(monkeypatch, lambda: _station_run(
        case, ["cpu"] * 2, 16, 7, drain=drain))
    assert one.point_range == (0, 1000)
    _assert_bitwise(two, one)


@pytest.mark.parametrize("config", ["grid", "composite_2st"])
def test_tile_major_routes_depth_2_equals_depth_1(config, monkeypatch):
    """A grid through K3 fused (its plain version, the eager prep into
    scan_reference, on the CPU) and a grid under two station networks on
    K3: 1,024 points x 64 steps at chunk 24 (no divisor of 64), stride 5,
    on one block and on two."""
    _, exp, settings, cal, pts, state0 = tp_grid._setup(config,
                                                        with_jax=False)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    st = interop.state(state0, "cpu")
    for ndev in (1, 2):
        one, two = _depths(monkeypatch, lambda: tprod.run_production(
            tm, exp, pts, cal, st, devices=["cpu"] * ndev, chunk_t=24,
            out_stride=5))
        _assert_bitwise(two, one)


@pytest.mark.parametrize("fast", [True, False], ids=["k2", "generic"])
def test_coupled_depth_2_equals_depth_1(fast, monkeypatch):
    """run_production_coupled with the window [11, 40] across chunk
    boundaries at chunk 16 (phase A ends inside the first chunk, phase C
    starts inside the third), stride 6: phase A's stream drained before
    phase B reads the carry, phase B's rows through the same drain, phase C
    a pipeline of its own; the counters of both runs agree."""
    setup = tpc._coupled_setup()
    (one, m1), (two, m2) = _depths(monkeypatch, lambda: tpc._port_run(
        setup, chunk_t=16, out_stride=6, fast=fast))
    _assert_bitwise(two, one)
    for name in ("coupling_window_steps", "coupling_reruns",
                 "coupling_points", "coupling_failed", "stream_chunks",
                 "coupling_reruns_total", "coupling_window_point_steps",
                 "coupling_window_lane_steps", "stream_rows_bytes"):
        assert m1.counters[name] == m2.counters[name], name
    assert m2.counters["pipeline_depth"] == 2


@pytest.mark.parametrize("depth", [1, 2])
def test_issue_and_drain_order(depth, monkeypatch):
    """The host's work in order, logged: each sharded launch as it is
    issued (its first step) and each chunk as it is drained (the progress
    callback, in chunk order).  At depth 2 every chunk but the last is
    drained only after the next was issued, and never more than two chunks
    are pending; at depth 1 each is drained before the next is issued."""
    monkeypatch.setattr(tprod, "PIPELINE_DEPTH", depth)
    log = []
    launch = sharding.scan_sharded

    def logged(*a, **k):
        log.append(("issue", k["out_offset"]))
        return launch(*a, **k)

    class Drains:
        def update(self, steps):
            log.append(("drain", steps))

    monkeypatch.setattr(sharding, "scan_sharded", logged)
    case = tso._case("k2")
    _station_run(case, ["cpu"] * 2, 8, 20, progress=Drains())
    issues = [t0 for kind, t0 in log if kind == "issue"]
    assert issues == list(range(0, 49, 8))
    assert sum(n for kind, n in log if kind == "drain") == 49
    issued = drained = 0
    for kind, _ in log:
        if kind == "issue":
            issued += 1
        else:
            drained += 1
            if drained < len(issues):
                # the chunk drained is the one before the last issued
                assert issued == drained + depth - 1, log
        assert 0 <= issued - drained <= depth, log
    assert issued == drained == len(issues)


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("mode,cofs", TM_MODES, ids=TM_IDS)
def test_scan_sharded_out_equals_new(mode, cofs, ndev):
    """K4's wrapper writing into the caller's (tmp, scal, rows) sets equals
    the call that allocates them, bit for bit, and returns those tensors;
    the plain version takes the same argument."""
    packed, kw, geo, tm = _tm_case(mode, cofs, nsteps=32)
    devices = ["cpu"] * ndev
    tmp0, scal0, forc, trf, aux = sharding.shard_packed(
        *packed, devices, slim_trf=kw.get("slim_trf"),
        aux_rows=kw.get("aux_rows"))
    if aux is not None:
        kw = dict(kw, slim_trf=trf, aux_rows=aux)
    args = (tmp0, scal0, forc, tm.cfg, tm.params, tm.grid)
    want = sharding.scan_sharded(*args, devices, **geo, **kw)
    out = [tuple(torch.full_like(x, float("nan")) for x in r) for r in want]
    for call in (lambda: sharding.scan_sharded(*args, devices, out=out,
                                               **geo, **kw),
                 lambda: sharding.scan_sharded_reference(*args, out=out,
                                                         **geo, **kw)):
        got = call()
        for g, o, w in zip(got, out, want):
            for x, y, z in zip(g, o, w):
                assert x is y
                assert torch.equal(x.view(torch.int32), z.view(torch.int32))


def test_scan_sharded_out_is_checked():
    """Outputs the launch cannot take raise: a set too few, a wrong shape
    or type, a profile that is the launch's own tmp0."""
    packed, kw, geo, tm = _tm_case("k1", False, nsteps=8)
    blocks = sharding.shard_packed(*packed, ["cpu"] * 2)[:3]
    call = lambda out: sharding.scan_sharded(
        *blocks, tm.cfg, tm.params, tm.grid, ["cpu"] * 2, out=out, **geo)
    good = [tuple(torch.empty_like(x) for x in r) for r in call(None)]
    with pytest.raises(ValueError, match="2 blocks"):
        call(good[:1])
    with pytest.raises(ValueError, match="rows"):
        call([good[0], (good[1][0], good[1][1], good[1][2][:1])])
    with pytest.raises(ValueError, match="scal"):
        call([good[0], (good[1][0], good[1][1].double(), good[1][2])])
    with pytest.raises(ValueError, match="shares the storage"):
        call([(blocks[0][0], good[0][1], good[0][2]), good[1]])


@pytest.mark.cuda
def test_pipeline_on_cuda(monkeypatch):
    """On the card: copy streams, events and pinned staging buffers.  K2 and
    a grid through K3 fused on one block and on two blocks of the card
    (each on a stream of its own), depth 2 against depth 1, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    case = tso._case("k2")
    for devices in ([dev], [dev] * 2):
        one, two = _depths(monkeypatch, lambda: _station_run(
            case, devices, 16, 7, device=dev))
        _assert_bitwise(two, one)
    _, _, settings, cal, pts, state0 = tp_grid._setup("grid",
                                                      with_jax=False)
    times, lats, lons, fields, sim = tp_grid._grid_case(with_missing=False,
                                                        T=64)
    exp = tprod.GridExpander(times, lats, lons, fields, *tp_grid._points(),
                             sim, dev, chunk_t=32)
    tm = tmodel.Model(interop.settings(settings), device=dev)
    st = interop.state(state0, "cpu")
    for devices in ([dev], [dev] * 2):
        one, two = _depths(monkeypatch, lambda: tprod.run_production(
            tm, exp, pts, cal, st, devices=devices, chunk_t=24,
            out_stride=5))
        _assert_bitwise(two, one)


@pytest.mark.parametrize("depth", [1, 2])
def test_failed_row_copy_raises(depth, monkeypatch):
    """A host copy of a chunk's rows that fails (here the third) fails the
    run: its error is raised, nothing is returned."""
    monkeypatch.setattr(tprod, "PIPELINE_DEPTH", depth)
    put, calls = tprod._HostRows.put, []

    def failing(self, k, b, part):
        calls.append(k)
        if len(calls) == 3:
            raise RuntimeError("row copy failed")
        return put(self, k, b, part)

    monkeypatch.setattr(tprod._HostRows, "put", failing)
    with pytest.raises(RuntimeError, match="row copy failed"):
        _station_run(tso._case("k2"), ["cpu"], 16, 7)
