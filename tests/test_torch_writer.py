"""The port's output writers and checkpoints (``roadsurf_tpu_torch/io/
writer.py``) against the JAX package's (``roadsurf_tpu/io/writer.py``): the
same files from the same values, shards and checkpoints that either package
reads back, and a library-level warm-start cycle (run, checkpoint, restore,
run on) on both sides at the production tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu import production as jprod
from roadsurf_tpu.forcing import relax_anchors
from roadsurf_tpu.io import writer as jwriter
from roadsurf_tpu.parallel.sharding import make_mesh
from roadsurf_tpu.state import State as JState
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.io import writer as twriter
from roadsurf_tpu_torch.state import State

import test_torch_production as tp_station

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


def _fields(seed=3, n_out=5, P=12):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(0, 3, (n_out, P)).astype(np.float32)
            for n in NAMES}


def _state(seed, P=12, L=17):
    """A State of numpy leaves with every dtype the checkpoint holds."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 2, s).astype(np.float32)
    return JState(tmp=f(P, L), tsurf_ave=f(P), wat=f(P), snow=f(P), ice=f(P),
                  ice2=f(P), dep=f(P), q2melt=f(P), t4melt=f(P),
                  very_cold=rng.random(P) < 0.5, evap=f(P), blcond=f(P),
                  albedo=f(P), failed=rng.random(P) < 0.2)


def _same_files(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("stride", [1, 2])
def test_forecast_json_is_the_jax_writers_file(tmp_path, stride):
    f = _fields()
    epochs = 1575244800 + 1800 * np.arange(5)
    ids, lats, lons = 100 + np.arange(12), 60 + np.arange(12.0), \
        24 + 0.5 * np.arange(12)
    args = (ids, lats, lons, epochs, f["tsurf"], f["wat"], f["snow"],
            f["ice"], f["dep"])
    jwriter.write_forecast_json(tmp_path / "j.json", *args,
                                output_stride=stride)
    # tensors go through the port's writer as they are
    targs = args[:4] + tuple(torch.tensor(x) for x in args[4:])
    twriter.write_forecast_json(tmp_path / "t.json", *targs,
                                output_stride=stride)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    tair, tdew = _fields(4)["tsurf"], _fields(5)["tsurf"]
    jwriter.write_forecast_json_extended(
        tmp_path / "je.json", ids, lats, lons, epochs, f, tair, tdew, stride)
    twriter.write_forecast_json_extended(
        tmp_path / "te.json", ids, lats, lons, epochs,
        {k: torch.tensor(v) for k, v in f.items()}, tair, tdew, stride)
    assert (tmp_path / "te.json").read_bytes() == \
        (tmp_path / "je.json").read_bytes()
    assert twriter.format_times(epochs[:2]) == jwriter.format_times(epochs[:2])


def test_forecast_grid_is_the_jax_writers_file(tmp_path):
    keep = np.zeros((4, 5), bool)
    keep.ravel()[[0, 2, 3, 7, 8, 9, 11, 13, 14, 16, 18, 19]] = True
    f = _fields()
    tair, tdew = _fields(4)["tsurf"], _fields(5)["tsurf"]
    epochs = 1575244800 + 1800 * np.arange(5)
    args = (np.linspace(60, 61, 4), np.linspace(24, 26, 5), keep, epochs)
    jwriter.write_forecast_grid(tmp_path / "j.npz", *args, f, tair, tdew, 2)
    twriter.write_forecast_grid(
        tmp_path / "t.npz", *args, {k: torch.tensor(v) for k, v in f.items()},
        torch.tensor(tair), tdew, 2)
    _same_files(tmp_path / "t.npz", tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as z:
        assert z["tsurf"].shape == (3, 4, 5)
        assert (z["tsurf"][:, ~keep] == np.float32(-9999.9)).all()


def test_shards_merge_under_either_package(tmp_path):
    """One shard written by the port, the next by the JAX package: both
    packages' merge_shards give the same whole; gaps and disagreeing steps
    are refused by the port as by the JAX package."""
    f = _fields(P=12)
    steps = np.arange(0, 50, 10)
    cut = lambda lo, hi: {k: v[:, lo:hi] for k, v in f.items()}
    twriter.write_shard_npz(tmp_path / "s0.npz", (0, 5), steps,
                            {k: torch.tensor(v) for k, v in cut(0, 5).items()},
                            epochs=1000 + steps)
    jwriter.write_shard_npz(tmp_path / "s1.npz", (5, 12), steps, cut(5, 12),
                            epochs=1000 + steps)
    # the same shard from either writer is the same file
    jwriter.write_shard_npz(tmp_path / "s0j.npz", (0, 5), steps, cut(0, 5),
                            epochs=1000 + steps)
    _same_files(tmp_path / "s0.npz", tmp_path / "s0j.npz")
    paths = [tmp_path / "s1.npz", tmp_path / "s0.npz"]
    for merge in (twriter.merge_shards, jwriter.merge_shards):
        got_steps, got, epochs = merge(paths)
        np.testing.assert_array_equal(got_steps, steps)
        np.testing.assert_array_equal(epochs, 1000 + steps)
        assert sorted(got) == sorted(NAMES)
        for k in NAMES:
            np.testing.assert_array_equal(got[k], f[k], err_msg=k)
    # an empty range anchored at the end (a padding-only process) merges
    twriter.write_shard_npz(tmp_path / "s2.npz", (12, 12), steps,
                            cut(12, 12), epochs=1000 + steps)
    assert twriter.merge_shards(paths + [tmp_path / "s2.npz"])[1][
        "tsurf"].shape == (5, 12)
    twriter.write_shard_npz(tmp_path / "gap.npz", (6, 12), steps, cut(6, 12),
                            epochs=1000 + steps)
    with pytest.raises(ValueError, match="do not tile"):
        twriter.merge_shards([tmp_path / "s0.npz", tmp_path / "gap.npz"])
    twriter.write_shard_npz(tmp_path / "late.npz", (5, 12), steps + 1,
                            cut(5, 12), epochs=1000 + steps)
    with pytest.raises(ValueError, match="steps disagree"):
        twriter.merge_shards([tmp_path / "s0.npz", tmp_path / "late.npz"])


@pytest.mark.parametrize("writer_side", ["port", "jax"])
def test_checkpoint_round_trip_through_the_other_package(tmp_path,
                                                         writer_side):
    """A checkpoint saved by one package restores under the other with
    equal arrays; points missing from it keep the template."""
    saved, template = _state(1), _state(2, P=14)
    ids = 500 + np.arange(12)
    want_ids = np.concatenate([ids[::-1], [7, 9]])      # two not in the file
    path = tmp_path / "ck.npz"
    if writer_side == "port":
        twriter.save_checkpoint(path, interop.state(saved, "cpu"), ids, 1234)
        got = jwriter.restore_state(path, want_ids, JState(
            *(jnp.asarray(x) for x in template)))
        fields, got_ids, epoch = jwriter.load_checkpoint(path)
    else:
        jwriter.save_checkpoint(path, saved, ids, 1234)
        got = twriter.restore_state(path, want_ids,
                                    interop.state(template, "cpu"))
        assert all(isinstance(x, torch.Tensor) for x in got)
        fields, got_ids, epoch = twriter.load_checkpoint(path)
    assert epoch == 1234
    np.testing.assert_array_equal(got_ids, ids)
    for name in JState._fields:
        g = interop.to_numpy(getattr(got, name))
        s, t = getattr(saved, name), getattr(template, name)
        assert g.dtype == t.dtype, name
        np.testing.assert_array_equal(g[:12], s[::-1], err_msg=name)
        np.testing.assert_array_equal(g[12:], t[12:], err_msg=name)
        np.testing.assert_array_equal(fields[name], s, err_msg=name)
    # both writers give the same file
    other = tmp_path / "other.npz"
    if writer_side == "port":
        jwriter.save_checkpoint(other, saved, ids, 1234)
    else:
        twriter.save_checkpoint(other, interop.state(saved, "cpu"), ids, 1234)
    _same_files(path, other)
    # a numpy template comes back as numpy
    back = twriter.restore_state(path, want_ids, template)
    assert all(isinstance(x, np.ndarray) for x in back)


def test_restore_from_an_empty_checkpoint(tmp_path):
    """The checkpoint of a process whose blocks hold only padding has no
    points; restoring it gives the template back, tensor or numpy, and the
    JAX package reads the file as the port does."""
    path = str(tmp_path / "empty.npz")
    empty = State(*(torch.as_tensor(x[:0]) for x in _state(1)))
    twriter.save_checkpoint(path, empty, [], 1234)
    fields, ids, epoch = jwriter.load_checkpoint(path)
    assert len(ids) == 0 and epoch == 1234 and fields["tmp"].shape == (0, 17)
    template = _state(2)
    back = twriter.restore_state(path, 100 + np.arange(12), template)
    for got, want in zip(back, template):
        np.testing.assert_array_equal(got, want)
    ttemplate = State(*(torch.as_tensor(x) for x in template))
    back = twriter.restore_state(path, 100 + np.arange(12), ttemplate)
    assert all(torch.equal(g, w) for g, w in zip(back, ttemplate))


def test_warm_start_cycle_matches_jax(tmp_path):
    """Run, checkpoint, restore onto a cold template (with a few points
    missing from the checkpoint), run on: the port's cycle against the JAX
    package's, each with its own writer, at rtol 2e-4 / atol 2e-3 with
    equal failed masks; and the JAX package's checkpoint of the port's
    first state restores to the same warm state, so the port's run from it
    is its own second run bit for bit."""
    settings, model, raw_st, raw_pt, cal, pts, st_idx = \
        tp_station._station_setup(P=250, T=33)
    P = len(st_idx)
    ids = 9000 + np.arange(P)
    known = np.ones(P, bool)
    known[5::40] = False                      # absent from the checkpoint
    mesh = make_mesh()
    anchors = relax_anchors(raw_pt, pts)
    kw = dict(anchors=anchors, chunk_t=16, out_stride=8)

    def jax_run(state):
        p_pad = jprod.padded_points(P, mesh)
        exp = jprod.StationExpander(
            raw_st, np.pad(st_idx, (0, p_pad - P), constant_values=-1), mesh,
            chunk_t=16)
        return jprod.run_production(model, exp, pts, cal, state, mesh=mesh,
                                    inner_chunk_t=8, interpret=True, **kw)

    tmod = tmodel.Model(interop.settings(settings), device="cpu")

    def port_run(state):
        p_pad = tprod.padded_points(P, 2)
        exp = tprod.StationExpander(
            raw_st, np.pad(st_idx, (0, p_pad - P), constant_values=-1),
            "cpu", chunk_t=16)
        return tprod.run_production(tmod, exp, pts, cal, state,
                                    devices=["cpu"] * 2, **kw)

    cold_j = model.init(raw_pt, cal, dtype=jnp.float32)
    cold_t = tmod.init(raw_pt, cal, dtype=torch.float32)
    first_j, first_t = jax_run(cold_j), port_run(cold_t)
    jwriter.save_checkpoint(tmp_path / "j.npz", JState(
        *(np.asarray(x)[known] for x in first_j.state)), ids[known], 99)
    twriter.save_checkpoint(tmp_path / "t.npz", State(
        *(x[torch.tensor(known)] for x in first_t.state)), ids[known], 99)
    warm_j = jwriter.restore_state(tmp_path / "j.npz", ids, cold_j)
    warm_t = twriter.restore_state(tmp_path / "t.npz", ids, cold_t)
    for name in State._fields:
        got = getattr(warm_t, name)
        assert torch.equal(got[torch.tensor(~known)],
                           getattr(cold_t, name)[torch.tensor(~known)])
        assert torch.equal(got[torch.tensor(known)],
                           getattr(first_t.state, name)[torch.tensor(known)])
    second_j, second_t = jax_run(warm_j), port_run(warm_t)
    assert not np.array_equal(second_t.fields["tsurf"],
                              first_t.fields["tsurf"])
    for name in NAMES:
        np.testing.assert_allclose(second_t.fields[name],
                                   second_j.fields[name], rtol=2e-4,
                                   atol=2e-3, err_msg=name)
    np.testing.assert_allclose(second_t.state.tmp.numpy(),
                               np.asarray(second_j.state.tmp), rtol=2e-4,
                               atol=2e-3)
    assert np.array_equal(second_t.state.failed.numpy(),
                          np.asarray(second_j.state.failed))
    # the JAX package's checkpoint of the port's own first state restores
    # to the same warm state, so the run from it is the same run
    jwriter.save_checkpoint(tmp_path / "tj.npz", interop.to_numpy(
        State(*(x[torch.tensor(known)] for x in first_t.state)), JState),
        ids[known], 99)
    again = port_run(twriter.restore_state(tmp_path / "tj.npz", ids, cold_t))
    for name in NAMES:
        np.testing.assert_array_equal(again.fields[name],
                                      second_t.fields[name], err_msg=name)


def test_failure_summary_and_nan_detection():
    """observability.failure_summary names a shard's global range;
    detect_nan_points marks the points the JAX package's marks."""
    import io

    from roadsurf_tpu import observability as jobs
    from roadsurf_tpu_torch import observability as tobs
    failed = np.zeros(10, bool)
    failed[[2, 7]] = True
    lats, lons = 60 + np.arange(10.0), 24 + np.arange(10.0)
    bufs = [io.StringIO(), io.StringIO(), io.StringIO()]
    assert jobs.failure_summary(failed, lats, lons, stream=bufs[0]) == 2
    assert tobs.failure_summary(torch.tensor(failed), lats, lons,
                                stream=bufs[1]) == 2
    assert bufs[1].getvalue() == bufs[0].getvalue()
    assert tobs.failure_summary(failed, stream=bufs[2],
                                point_range=(512, 522)) == 2
    assert bufs[2].getvalue() == \
        "2/10 points failed in points [512, 522)\n"
    assert tobs.failure_summary(np.zeros(4, bool), stream=bufs[2]) == 0
    st = _state(6)
    st = st._replace(failed=np.zeros(12, bool))
    st.tmp[3, 4] = np.nan
    st.wat[8] = np.inf
    st.t4melt[5] = np.nan                  # not one of the checked fields
    jst, jbad = jobs.detect_nan_points(JState(*(jnp.asarray(x) for x in st)))
    tst, tbad = tobs.detect_nan_points(interop.state(st, "cpu"))
    assert tbad.tolist() == np.asarray(jbad).tolist()
    assert tbad.nonzero().flatten().tolist() == [3, 8]
    assert tst.failed.tolist() == np.asarray(jst.failed).tolist()
