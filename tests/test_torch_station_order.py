"""Station blocks in station order: a run places each StationExpander block
through ``station_sorted``, which sorts its points by station (the JAX package's ``point_perm``,
roadsurf_tpu/production.py:289-346), the engine places every per-point array
in that order, and outputs and the final state come back in the caller's.

Each point's arithmetic is its own, so a run whose points come in another
order gives each point the same bits: here the station runs of
tests/test_torch_production.py with every point's initial profile made its
own, once in the caller's order and once shuffled, are equal bit for bit
through the shuffle, in every output row and the final state, on every
route a StationExpander takes (K2, K1 with ``slim=False``, K3 with sky view,
the generic per-point prep), coupled, on 1 and 2 blocks, and through
``drain="shard"`` files and checkpoints with a warm start.  On the CPU the
blocks are multiples of 128 points, torch's vector body covers every point,
and the results are bit for bit with no exception.
"""
import numpy as np
import pytest
import torch

from roadsurf_tpu.forcing import RawForcing, relax_anchors
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.io import writer
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.state import State

import test_torch_production as tp_station
import test_torch_production_coupled as tpc

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


def _take(x, idx):
    return np.asarray(x)[idx]


def _case(route, P=512, T=49, seed=3):
    """Inputs of one station run on ``route``: "k2" and "k1" (the fast
    path, slim or packed), "sky" (sky view 0.6 and horizons on every third
    point: the tile-major K3 route) or "generic" (no prep_ctx).  The
    initial profile differs from point to point, so no two points of a
    station compute alike."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = \
        tp_station._station_setup(P=P, T=T, seed=seed)
    ctx = (tp_station._port_ctx(tp_station._station_prep_ctx(
        settings, model, raw_st, cal, pts)) if route in ("k1", "k2")
        else None)
    rng = np.random.default_rng(seed)
    if route == "sky":
        hor = np.zeros((P, 360), np.float32)
        hor[::3] = rng.uniform(0, 25, (len(hor[::3]), 360))
        pts = pts._replace(sky_view=np.where(np.arange(P) % 3 == 0, 0.6, 1.0),
                           horizons=hor)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    state0 = tm.init(raw_pt, cal, dtype=torch.float32)
    state0 = state0._replace(tmp=state0.tmp + torch.tensor(
        rng.normal(0.0, 0.5, tuple(state0.tmp.shape)), dtype=torch.float32))
    anchors = relax_anchors(raw_pt, pts)
    return dict(tm=tm, raw_st=raw_st, cal=cal, pts=pts, st_idx=st_idx,
                state0=state0, anchors=anchors, ctx=ctx,
                slim=route != "k1")


def _shuffled(case, sigma):
    """``case`` with its points in the order ``sigma`` (point i of the
    result is point sigma[i] of the case)."""
    idx = torch.as_tensor(sigma)
    return dict(case, st_idx=case["st_idx"][sigma],
                pts=type(case["pts"])(*(_take(x, sigma)
                                        for x in case["pts"])),
                state0=State(*(x[idx] for x in case["state0"])),
                anchors=tuple(_take(a, sigma) for a in case["anchors"]))


def _run(case, ndev=1, coupled=False, chunk_t=16, out_stride=7, **kw):
    P = len(case["st_idx"])
    p_pad = tprod.padded_points(P, ndev)
    exp = tprod.StationExpander(
        case["raw_st"], np.pad(case["st_idx"], (0, p_pad - P),
                               constant_values=-1),
        "cpu", chunk_t=chunk_t, prep_ctx=case["ctx"], slim=case["slim"])
    run = (tprod.run_production_coupled if coupled
           else tprod.run_production)
    return run(case["tm"], exp, case["pts"], case["cal"], case["state0"],
               anchors=case.get("anchors"), devices=["cpu"] * ndev,
               chunk_t=chunk_t, out_stride=out_stride, **kw)


def _assert_mapped(shuf, base, sigma):
    """``shuf`` (the run of the points in the order ``sigma``) equals
    ``base`` mapped through ``sigma``, bit for bit."""
    assert np.array_equal(shuf.out_steps, base.out_steps)
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    for name in NAMES:
        np.testing.assert_array_equal(bits(shuf.fields[name]),
                                      bits(base.fields[name][:, sigma]),
                                      err_msg=name)
    idx = torch.as_tensor(sigma)
    for name in State._fields:
        g, w = getattr(shuf.state, name), getattr(base.state, name)[idx]
        assert torch.equal(g, w), name
    assert shuf.point_range == base.point_range


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("route", ["k2", "k1", "sky", "generic"])
def test_shuffled_station_run_equals_mapped(route, ndev):
    """A station run of shuffled points equals the caller-order run mapped
    through the shuffle, bit for bit, on each route and block count."""
    case = _case(route)
    sigma = np.random.default_rng(7).permutation(len(case["st_idx"]))
    base = _run(case, ndev)
    shuf = _run(_shuffled(case, sigma), ndev)
    _assert_mapped(shuf, base, sigma)
    assert base.state.failed.numpy()[::97].all()    # out-of-radius points


@pytest.mark.parametrize("fast", [True, False], ids=["k2", "generic"])
def test_shuffled_coupled_run_equals_mapped(fast):
    """run_production_coupled (phase A and C through the kernel, phase B
    in torch over the block in station order) on 2 blocks: shuffled
    against the caller's order mapped, bit for bit, with the same coupling
    counts."""
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = tpc._coupled_setup(
        P=512, T=73)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    state0 = tm.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    rng = np.random.default_rng(11)
    state0 = state0._replace(tmp=state0.tmp + torch.tensor(
        rng.normal(0.0, 0.5, tuple(state0.tmp.shape)), dtype=torch.float32))
    case = dict(tm=tm, raw_st=raw_st, cal=cal, pts=pts, st_idx=st_idx,
                state0=state0, anchors=(), slim=True,
                ctx=tpc._port_ctx(ctx) if fast else None)
    sigma = rng.permutation(len(st_idx))
    runs = {}
    for label, c in (("base", case), ("shuf", _shuffled(case, sigma))):
        metrics = tprod.RunMetrics()
        c = dict(c, anchors=None)
        runs[label] = (_run(c, 2, coupled=True, chunk_t=32, out_stride=6,
                            metrics=metrics), metrics.counters)
    _assert_mapped(runs["shuf"][0], runs["base"][0], sigma)
    cb, cs = runs["base"][1], runs["shuf"][1]
    assert cb["coupling_reruns"] > 0 and cb["coupling_points"] > 0
    for name in ("coupling_points", "coupling_failed", "coupling_succeeded",
                 "coupling_reruns", "coupling_window_steps"):
        assert cs[name] == cb[name], name


def test_shuffled_shards_and_checkpoints(tmp_path):
    """drain="shard" on 2 blocks: the shuffled run's shard file and
    checkpoint, merged and restored, equal the caller-order run mapped
    through the shuffle; a warm start from the restored state (which the
    engine sorts again) equals the caller-order warm start, mapped."""
    case = _case("k2", T=33)
    P = len(case["st_idx"])
    sigma = np.random.default_rng(13).permutation(P)
    ids = 1000 + np.arange(P)
    base = _run(case, 2)
    shuf_case = _shuffled(case, sigma)
    shuf = _run(shuf_case, 2, drain="shard")
    assert shuf.point_range == (0, P)
    writer.write_shard_npz(tmp_path / "shard.npz", shuf.point_range,
                           shuf.out_steps, shuf.fields)
    writer.save_checkpoint(tmp_path / "ckpt.npz", shuf.state, ids[sigma],
                           0)
    steps, fields, _ = writer.merge_shards([tmp_path / "shard.npz"])
    template = State(*(torch.zeros_like(x) for x in shuf.state))
    restored = writer.restore_state(tmp_path / "ckpt.npz", ids[sigma],
                                    template)
    _assert_mapped(tprod.ProductionResult(
        state=restored, out_steps=steps, fields=fields,
        point_steps_per_s=0.0, point_range=(0, P)), base, sigma)
    warm_base = _run(dict(case, state0=base.state), 2)
    warm_shuf = _run(dict(shuf_case, state0=restored), 2)
    _assert_mapped(warm_shuf, warm_base, sigma)


def test_sort_stays_inside_blocks():
    """On 4 blocks each engine's expander is its block's points sorted by
    station (out-of-radius points, and padding, last) with a stable sort:
    a permutation of the block's own points, never another block's; the
    block's station index, mask and packed state are placed in that order.
    A caller whose points already are in station order gives the identity,
    and no permutation is kept."""
    case = _case("k2", P=1000, T=33)
    P, ndev = len(case["st_idx"]), 4
    p_pad = tprod.padded_points(P, ndev)
    st_pad = np.pad(case["st_idx"], (0, p_pad - P), constant_values=-1)
    exp = tprod.StationExpander(case["raw_st"], st_pad, "cpu", chunk_t=16,
                                prep_ctx=case["ctx"])
    run = tprod._Blocks(case["tm"], exp, case["pts"], case["cal"],
                        case["state0"], anchors=case["anchors"],
                        devices=["cpu"] * ndev, chunk_t=16)
    S = np.asarray(case["raw_st"].tair).shape[0]
    whole = tprod._Engine(case["tm"], exp, case["pts"], case["cal"],
                          case["state0"], anchors=case["anchors"],
                          chunk_t=16)
    assert whole.perm is None and getattr(exp, "point_perm", None) is None
    for eng, (lo, hi) in zip(run.engines, run.ranges):
        perm = eng.expander.point_perm.numpy()
        assert sorted(perm) == list(range(hi - lo))
        key = np.where(st_pad >= 0, st_pad, S)[lo:hi]
        np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
        assert np.all(np.diff(key[perm]) >= 0)
        np.testing.assert_array_equal(
            eng.expander.st_idx.numpy(),
            np.where(st_pad >= 0, st_pad, 0)[lo:hi][perm])
        np.testing.assert_array_equal(eng.expander.ok.numpy(),
                                      (st_pad >= 0)[lo:hi][perm])
        np.testing.assert_array_equal(
            eng.expander.prep_data["sidx"].numpy(),
            np.where(st_pad >= 0, st_pad, S)[lo:hi][perm])
        assert torch.equal(eng.scal0, whole.scal0[:, lo:hi][:, perm])
        assert torch.equal(eng.tmp0, whole.tmp0[:, lo:hi][:, perm])
        assert torch.equal(eng.to_caller(eng.scal0, 1),
                           whole.scal0[:, lo:hi])
    # padding (the last 24 points) is marked failed wherever it sorts to
    last = run.engines[-1]
    failed = last.to_caller(last.scal0, 1)[sk.R_FAILED]
    assert bool(failed[232:].all()) and not bool(failed[:232].any())
    # a caller already in station order: every block is the identity
    order = np.argsort(np.where(st_pad >= 0, st_pad, S), kind="stable")
    sexp = tprod.StationExpander(case["raw_st"], st_pad[order], "cpu",
                                 chunk_t=16, prep_ctx=case["ctx"])
    for lo in range(0, p_pad, p_pad // ndev):
        blk = tprod.station_sorted(sexp.block(lo, lo + p_pad // ndev, "cpu"))
        assert blk.point_perm is None and blk.point_inv is None


def test_composite_keeps_caller_order():
    """A CompositeExpander's blocks cut its station part in the caller's
    order (its grid parts are laid out in it), and ``station_sorted``
    leaves them so; a sorted station block is refused as a part."""
    case = _case("generic", T=33)
    exp = tprod.StationExpander(case["raw_st"], case["st_idx"], "cpu",
                                chunk_t=16)
    comp = tprod.CompositeExpander([exp, exp])
    blk = tprod.station_sorted(comp.block(128, 384, "cpu"))
    for part in blk.parts:
        assert getattr(part, "point_perm", None) is None
        assert torch.equal(part.st_idx, exp.st_idx[128:384])
    assert getattr(exp.block(128, 384, "cpu"), "point_perm", None) is None
    sorted_blk = tprod.station_sorted(exp.block(128, 384, "cpu"))
    assert sorted_blk.point_perm is not None
    with pytest.raises(ValueError, match="permutation"):
        tprod.CompositeExpander([sorted_blk])
    whole = exp.window(0, 16)
    part = sorted_blk.window(0, 16)
    perm = sorted_blk.point_perm
    for n in RawForcing._fields:
        assert torch.equal(getattr(part, n),
                           getattr(whole, n)[:, 128:384][:, perm])
