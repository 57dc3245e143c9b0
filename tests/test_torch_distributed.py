"""The port's forecast over two real processes (``parallel/distributed.py``
over ``torch.distributed`` with the gloo backend), on the CPU: each process
owns two CPU blocks of the station forecast, drains only its own columns
(``drain="shard"``), writes its shard and a per-shard checkpoint, and joins
the failed-count reduction.  The parent merges the shards and holds them to
the one-process run, bit for bit, and to the JAX package's run at the
production tolerances (the cases of tests/_mp_worker.py:72-145).

The runner CLI's branch of several processes (the cases of
tests/test_distributed.py:69-160): two processes drive ``runner.run`` on
example2's operational config, coupled, with ``--device cpu``; each writes
its output shard and checkpoint; the shards merged through the
``merge-shards`` subcommand equal a one-process run.

The file is its own worker: the tests start it with
``python test_torch_distributed.py <port> <nproc> <rank> <outdir>`` (or
``runner <port> <nproc> <rank> <outdir>`` for the runner's); the worker
imports nothing of JAX.  Inputs come from numpy seeds and the example
generators, so parent and workers build the same.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

P_REAL, S, T = 1000, 6, 49
CHUNK_T, OUT_STRIDE = 16, 8
NPROC, BLOCKS = 2, 2
NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
LABELS = ("generic", "fast")
START_EPOCH = 1575244800             # synthetic_raw's 2019-12-02T00:00Z


def _case():
    """The station case of tests/_mp_worker.py:80-107, on 1,000 points (the
    4 blocks pad them to 1,024: the last block of the second process holds
    24 padded points), some out of every station's radius (they fail, in
    both processes' ranges)."""
    from roadsurf_tpu_torch.config import ModelSettings
    from roadsurf_tpu_torch.forcing import RawForcing
    from roadsurf_tpu_torch.io.synthetic import synthetic_raw
    from roadsurf_tpu_torch.state import default_point_params
    settings = ModelSettings(sim_len=T, dt=30.0)
    raw_st, cal = synthetic_raw(S, T, seed=9, scenario="winter_mix",
                                dtype=np.float32)
    st_idx = (np.arange(P_REAL) * 7) % S
    st_idx[::97] = -1
    ok = st_idx >= 0
    raw_pt = RawForcing(*(
        np.where(ok[:, None], np.asarray(getattr(raw_st, n))[
            np.where(ok, st_idx, 0)],
            -9999 if n == "prec_phase" else np.float32(-9999.9))
        for n in RawForcing._fields))
    return dict(settings=settings, raw_st=raw_st, cal=cal, st_idx=st_idx,
                raw_pt=raw_pt, pts=default_point_params(P_REAL),
                st_pts=default_point_params(S + 1),
                point_ids=100000 + np.arange(P_REAL))


def _port_run(case, label, nblocks_total, devices, drain):
    """The port's run of ``case`` (``label``: the generic per-point route or
    the station-level fast path) on ``devices``; the expander is built at
    the point count padded to all processes' blocks."""
    from roadsurf_tpu_torch import production
    from roadsurf_tpu_torch.model import Model
    model = Model(case["settings"], device="cpu")
    p_pad = production.padded_points(P_REAL, nblocks_total)
    st_idx = np.pad(case["st_idx"], (0, p_pad - P_REAL), constant_values=-1)
    ctx = ({"st_pts": case["st_pts"], "anchors": None,
            "settings": case["settings"], "params": model.params,
            "hour": case["cal"].hour, "t_total": T}
           if label == "fast" else None)
    exp = production.StationExpander(case["raw_st"], st_idx, "cpu",
                                     chunk_t=CHUNK_T, prep_ctx=ctx)
    state0 = model.init(case["raw_pt"], case["cal"], dtype=torch.float32)
    return production.run_production(
        model, exp, case["pts"], case["cal"], state0, devices=devices,
        chunk_t=CHUNK_T, out_stride=OUT_STRIDE, drain=drain)


def worker(port: int, nproc: int, rank: int, outdir: str):
    from roadsurf_tpu_torch.io.writer import save_checkpoint, write_shard_npz
    from roadsurf_tpu_torch.parallel import distributed, sharding
    outdir = pathlib.Path(outdir)
    distributed.initialize(f"127.0.0.1:{port}", nproc, rank)
    assert distributed.process_count() == nproc
    assert distributed.process_index() == rank
    case = _case()
    devices = ["cpu"] * BLOCKS
    stats = {"host_range": distributed.host_point_range(P_REAL)}
    # a run of several processes has no gather drain
    try:
        _port_run(case, "fast", nproc * BLOCKS, devices, "gather")
    except ValueError as e:
        stats["gather_error"] = str(e)
    for label in LABELS:
        res = _port_run(case, label, nproc * BLOCKS, devices, "shard")
        lo, hi = res.point_range
        write_shard_npz(outdir / f"{label}_{rank}.npz", res.point_range,
                        res.out_steps, res.fields,
                        epochs=START_EPOCH + 30 * res.out_steps)
        save_checkpoint(outdir / f"ckpt_{label}_{rank}.npz", res.state,
                        case["point_ids"][lo:hi], START_EPOCH + 30 * T)
        failed = res.state.failed
        count, ratio = sharding.failure_stats(failed)
        stats[label] = {
            "range": [lo, hi], "local_failed": int(failed.sum()),
            "count": count, "ratio": ratio,
            "over_budget": sharding.check_missing_budget(failed, 0.001),
            # only rank 1's bit is set: every rank must still see it
            "any_rank1": distributed.host_any(
                torch.tensor([rank == 1])),
            "any_none": distributed.host_any(np.zeros(3, bool))}
    (outdir / f"stats_{rank}.json").write_text(json.dumps(stats))
    distributed.shutdown()
    print(f"MP_OK {rank}", flush=True)


def runner_worker(port: int, nproc: int, rank: int, outdir: str):
    """One process of the runner's run of several: the kernel engine on
    one CPU block, its shard and checkpoint written by the runner."""
    from roadsurf_tpu_torch import runner
    from roadsurf_tpu_torch.parallel import distributed
    distributed.initialize(f"127.0.0.1:{port}", nproc, rank)
    # mixed verbosity on purpose (the common rank-0-only-logs pattern)
    runner.run(os.path.join(outdir, "cfg.json"), "20191202T0000",
               output_path=os.path.join(outdir, "mp_out.npz"),
               checkpoint_out=os.path.join(outdir, "mp_ck.npz"),
               verbose=(rank == 0), device="cpu", engine="kernel")
    distributed.shutdown()
    print(f"MP_RUNNER_OK {rank}", flush=True)


def _spawn(mode_args, outdir, timeout=240):
    """Start the NPROC workers of this file (``mode_args`` before the port)
    on a free port; fail on a worker that fails."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    me = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(me))
    env = dict(os.environ)
    env["PYTHONPATH"] = (repo + os.pathsep + env.get("PYTHONPATH", "")
                         ).rstrip(os.pathsep)
    procs = [subprocess.Popen(
        [sys.executable, me, *mode_args, str(port), str(NPROC), str(i),
         str(outdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(NPROC)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    return outs


# ---------------------------------------------------------------------------
# the parent's tests
# ---------------------------------------------------------------------------

_RUN = {}


def _workers(tmp_path_factory):
    """Start the two workers once; returns (outdir, [stats per rank])."""
    if "out" in _RUN:
        return _RUN["out"]
    outdir = tmp_path_factory.mktemp("mp")
    for i, out in enumerate(_spawn([], outdir)):
        assert f"MP_OK {i}" in out, f"worker {i} output:\n{out}"
    stats = [json.loads((outdir / f"stats_{i}.json").read_text())
             for i in range(NPROC)]
    _RUN["out"] = (outdir, stats)
    return _RUN["out"]


def _one_process(label):
    key = ("one", label)
    if key not in _RUN:
        _RUN[key] = _port_run(_case(), label, NPROC * BLOCKS,
                              ["cpu"] * (NPROC * BLOCKS), "gather")
    return _RUN[key]


def test_shard_ranges_tile_the_points(tmp_path_factory):
    """Each process's point_range is its half of the padded blocks cut to
    the real points, and the halves tile [0, 1000) exactly."""
    _, stats = _workers(tmp_path_factory)
    assert [s["host_range"] for s in stats] == [[0, 500], [500, 1000]]
    for label in LABELS:
        assert [s[label]["range"] for s in stats] == [[0, 512], [512, 1000]]
    for s in stats:
        assert "drain='shard'" in s["gather_error"]


def test_merged_shards_equal_one_process_run(tmp_path_factory):
    """The merged shards of the two processes against the one-process run
    over the same four blocks, bit for bit, for the generic route and the
    station fast path."""
    from roadsurf_tpu_torch.io.writer import merge_shards
    outdir, _ = _workers(tmp_path_factory)
    for label in LABELS:
        steps, fields, epochs = merge_shards(
            sorted(outdir.glob(f"{label}_*.npz")))
        one = _one_process(label)
        np.testing.assert_array_equal(steps, one.out_steps)
        np.testing.assert_array_equal(epochs, START_EPOCH + 30 * steps)
        np.testing.assert_array_equal(steps, np.arange(0, T, OUT_STRIDE))
        for n in NAMES:
            assert fields[n].shape == (len(steps), P_REAL)
            np.testing.assert_array_equal(fields[n], one.fields[n],
                                          err_msg=f"{label} {n}")


def test_merged_shards_match_jax(tmp_path_factory):
    """The merged shards against the JAX package's run of the same inputs
    over its 8-device mesh (interpret mode) at rtol 2e-4 / atol 2e-3."""
    import jax.numpy as jnp
    from roadsurf_tpu import production as jprod
    from roadsurf_tpu.config import ModelSettings
    from roadsurf_tpu.model import Model
    from roadsurf_tpu.parallel.sharding import make_mesh
    from roadsurf_tpu_torch.io.writer import merge_shards
    outdir, _ = _workers(tmp_path_factory)
    case = _case()
    model = Model(ModelSettings(sim_len=T, dt=30.0))
    mesh = make_mesh()
    p_pad = jprod.padded_points(P_REAL, mesh)
    jexp = jprod.StationExpander(
        case["raw_st"], np.pad(case["st_idx"], (0, p_pad - P_REAL),
                               constant_values=-1), mesh, chunk_t=CHUNK_T)
    want = jprod.run_production(
        model, jexp, case["pts"], case["cal"],
        model.init(case["raw_pt"], case["cal"], dtype=jnp.float32),
        mesh=mesh, chunk_t=CHUNK_T, out_stride=OUT_STRIDE, interpret=True)
    for label in LABELS:
        steps, fields, _ = merge_shards(sorted(outdir.glob(f"{label}_*.npz")))
        np.testing.assert_array_equal(steps, want.out_steps)
        for n in NAMES:
            np.testing.assert_allclose(fields[n], want.fields[n], rtol=2e-4,
                                       atol=2e-3, err_msg=f"{label} {n}")


def test_failed_count_reduction_sees_both_ranks(tmp_path_factory):
    """failure_stats sums the failed points over the processes: both ranks
    report the same global count, the sum of their own, and each rank's is
    above zero; host_any gives every rank the same answer."""
    _, stats = _workers(tmp_path_factory)
    for label in LABELS:
        local = [s[label]["local_failed"] for s in stats]
        assert all(n > 0 for n in local)
        one = _one_process(label)
        assert sum(local) == int(one.state.failed.sum())
        for s in stats:
            assert s[label]["count"] == sum(local)
            assert s[label]["ratio"] == sum(local) / P_REAL
            assert s[label]["over_budget"] is True
            assert s[label]["any_rank1"] is True
            assert s[label]["any_none"] is False


def test_per_shard_checkpoints_restore_the_final_state(tmp_path_factory):
    """Restoring the two per-shard checkpoints in turn gives the
    one-process run's final state; a point in neither keeps the template."""
    from roadsurf_tpu_torch.io.writer import load_checkpoint, restore_state
    from roadsurf_tpu_torch.state import State
    outdir, _ = _workers(tmp_path_factory)
    case = _case()
    one = _one_process("fast")
    ids = np.concatenate([case["point_ids"], [7]])       # id 7: in no shard
    template = State(*(torch.cat([torch.zeros_like(x), torch.zeros_like(x[:1])])
                       for x in one.state))
    state = template
    for rank in range(NPROC):
        path = outdir / f"ckpt_fast_{rank}.npz"
        _, ck_ids, _ = load_checkpoint(path)
        assert len(ck_ids) == (512, 488)[rank]
        state = restore_state(path, ids, state)
    for name in State._fields:
        got, want = getattr(state, name), getattr(one.state, name)
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got[:P_REAL], want), name
        assert torch.equal(got[P_REAL:], getattr(template, name)[P_REAL:])


def test_single_process_helpers():
    """Outside a process group: one process, index 0, the whole range; the
    reductions are the local values; make_global cuts a host-local tree
    into this process's blocks."""
    from roadsurf_tpu_torch.parallel import distributed
    from roadsurf_tpu_torch.state import default_point_params
    distributed.initialize(None, 1, 0)                   # no-op
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.host_point_range(1000) == (0, 1000)
    assert distributed.sum_over_processes([3, 4]) == [3, 4]
    assert distributed.host_any([torch.zeros(2), torch.tensor([0., 1.])])
    assert not distributed.host_any(np.zeros(4))
    pts = default_point_params(8)._replace(lat=np.arange(8.0))
    blocks = distributed.make_global(pts, ["cpu"] * 4)
    assert len(blocks) == 4 and type(blocks[0]) is type(pts)
    assert blocks[2].lat.tolist() == [4.0, 5.0]
    assert blocks[2].horizons.shape == (2, 360)
    rows = distributed.make_global({"x": np.arange(12.0).reshape(3, 4),
                                    "t": np.arange(3.0)}, ["cpu"] * 2, axis=1)
    assert rows[1]["x"].tolist() == [[2., 3.], [6., 7.], [10., 11.]]
    assert rows[1]["t"].tolist() == [0., 1., 2.]
    np.testing.assert_array_equal(
        distributed.gather_to_host([b.lat for b in blocks]), np.arange(8.0))
    distributed.shutdown()                               # no-op


def test_multiprocess_runner_shards(tmp_path):
    """The runner's run of several processes end to end
    (tests/test_distributed.py:69-160): two gloo processes run example2's
    operational config (NWP grid + ASCII station obs, coupled, a window
    inside the analysis) with ``--device cpu``; each writes its output
    shard and per-shard checkpoint; the shards merged through the
    ``merge-shards`` subcommand, and the checkpoints restored in turn,
    equal a one-process run (one block of the same padded points), bit for
    bit."""
    import importlib.util
    from roadsurf_tpu_torch import runner
    from roadsurf_tpu_torch.io import writer
    from roadsurf_tpu_torch.io.sources import read_json_tolerant
    from roadsurf_tpu_torch.observability import RunMetrics
    ex2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "examples", "example2")
    spec = importlib.util.spec_from_file_location(
        "ex2_gen", os.path.join(ex2, "make_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.main(["--analysis", "2", "--forecast", "2", "--ny", "6", "--nx", "8",
              "--outdir", str(tmp_path)])
    # 12 x 16 points: 128 in the first process's block, 64 in the second's
    cfg = read_json_tolerant(os.path.join(ex2, "grid_config.json"))
    cfg["time"]["analysis"] = 1
    cfg["time"]["forecast"] = 1
    cfg["time"]["coupling_minutes"] = 30
    cfg["model"]["DTSecs"] = 120
    cfg["model"]["use_coupling"] = 1
    cfg["points"].pop("mask")
    cfg["input"][0]["path"] = str(tmp_path / "forecast_grid.npz")
    cfg["input"][1]["path"] = str(tmp_path / "road_station.txt")
    cfg["output"]["filename"] = str(tmp_path / "unused.npz")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))

    m = RunMetrics()
    ref_state, ref = runner.run(
        str(tmp_path / "cfg.json"), "20191202T0000",
        output_path=str(tmp_path / "ref.npz"), verbose=False, device="cpu",
        engine="kernel", metrics=m)
    assert m.counters["coupling_points"] > 0
    for i, out in enumerate(_spawn(["runner"], tmp_path)):
        assert f"MP_RUNNER_OK {i}" in out, f"worker {i} output:\n{out}"

    shards = sorted(str(f) for f in tmp_path.glob("mp_out.npz.shard*.npz"))
    assert len(shards) == NPROC, shards
    merged = tmp_path / "merged.npz"
    runner.main(["merge-shards", str(merged)] + shards)
    z = np.load(merged)
    np.testing.assert_array_equal(z["steps"], ref["steps"])
    for n in NAMES:
        assert z[n].shape == ref[n].shape
        np.testing.assert_array_equal(z[n], ref[n], err_msg=n)
    cks = sorted(tmp_path.glob("mp_ck.npz.shard*"))
    assert len(cks) == NPROC, cks
    assert [len(writer.load_checkpoint(str(c))[1]) for c in cks] == [128, 64]
    from roadsurf_tpu_torch.state import State
    ids = list(range(1, ref["tsurf"].shape[1] + 1))
    state = State(*(torch.zeros_like(x) for x in ref_state))
    for ck in cks:
        state = writer.restore_state(str(ck), ids, state)
    for name in State._fields:
        assert torch.equal(getattr(state, name), getattr(ref_state, name)), \
            name


if __name__ == "__main__":
    if sys.argv[1] == "runner":
        runner_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                      sys.argv[5])
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
