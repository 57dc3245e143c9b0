"""The port's runner through its kernel engine (``run_production_config``)
on the CPU, where the wrapper runs the kernel's plain version
(``scan_reference``), against the JAX package's kernel engine
(``--engine pallas``, Pallas in interpret mode) at rtol 2e-4 / atol 2e-3
with equal failed masks, and against the port's own scan engine at the JAX
tests' tolerances: the cases of tests/test_examples.py:64 (example1's full
feature set: sky view, coupling, relaxation), tests/test_production.py:215
(grid points over example1's stations) and :346 (the warm-start cycle).
Also: one run at two chunk lengths, bit for bit, on the station route (K2)
and the grid + station route (K3 fused); and the auto chunk length, the JAX
runner's whatever the grid's SPAN."""
import json
import os

import numpy as np
import pytest
import torch

from roadsurf_tpu import runner as jrunner
from roadsurf_tpu.io.sources import read_json_tolerant
from roadsurf_tpu_torch import runner as trunner
from roadsurf_tpu_torch.observability import RunMetrics

import test_io
from test_examples import EXAMPLES, load_script
from test_torch_runner import host

torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=2e-4, atol=2e-3)
NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


def port_kernel(cfg_path, t=None, **kw):
    kw.setdefault("verbose", False)
    return trunner.run(str(cfg_path), t, device="cpu", engine="kernel", **kw)


def hold_kernel(port, jax_, tol=KERNEL_TOL):
    """The port's kernel engine against the JAX package's: the same output
    steps, fields at ``tol``, equal failed masks."""
    (ps, pf), (js, jf) = port, jax_
    np.testing.assert_array_equal(pf["steps"], np.asarray(jf["steps"]))
    for n in NAMES:
        np.testing.assert_allclose(pf[n], np.asarray(jf[n]), **tol,
                                   err_msg=n)
    np.testing.assert_array_equal(host(ps.failed), np.asarray(js.failed))


def hold_scan(kernel, scan, tol):
    """A kernel-engine run against the same package's scan engine at its
    output steps."""
    (ks, kf), (ss, sf) = kernel, scan
    steps = kf["steps"]
    for n in ("tsurf", "wat", "snow", "ice", "dep"):
        np.testing.assert_allclose(kf[n], np.asarray(sf[n])[steps], **tol,
                                   err_msg=n)
    np.testing.assert_array_equal(host(ks.failed), host(ss.failed))


def _example1(tmp_path, **model):
    gen = load_script(os.path.join(EXAMPLES, "example1", "make_data.py"),
                      "ex1_make_data")
    gen.main(["--stations", "3", "--analysis", "2", "--forecast", "2",
              "--outdir", str(tmp_path)])
    cfg = read_json_tolerant(
        os.path.join(EXAMPLES, "example1", "example_config.json"))
    cfg["time"]["analysis"] = 2
    cfg["time"]["forecast"] = 1
    cfg["model"]["DTSecs"] = 120
    cfg["model"].update(model)
    for src in cfg["input"]:
        src["path"] = str(tmp_path / os.path.basename(src["path"]))
    cfg["parameters"]["sky_view_file"] = str(tmp_path / "skyview.txt")
    cfg["parameters"]["local_horizon_file"] = str(tmp_path / "horizons.txt")
    del cfg["output"]["filename"]
    return cfg


def _write(tmp_path, cfg, name="cfg.json"):
    p = tmp_path / name
    p.write_text(json.dumps(cfg))
    return p


def test_example1_kernel_engine_parity(tmp_path):
    """example1's full feature set (station JSON, sky view + horizons,
    coupling, relaxation: K3 fused around the coupling window) through the
    port's kernel engine == the JAX package's, and == the port's scan
    engine.  A 60-minute coupling window, so that it falls inside the
    two-hour analysis and the points couple."""
    cfg = _example1(tmp_path)
    cfg["time"]["coupling_minutes"] = 60
    cfgp = _write(tmp_path, cfg)
    m = RunMetrics()
    port = port_kernel(cfgp, "20191202T0000", metrics=m)
    assert m.counters["coupling_points"] > 0
    hold_kernel(port, jrunner.run(str(cfgp), "20191202T0000", verbose=False,
                                  engine="pallas"))
    hold_scan(port, trunner.run(str(cfgp), "20191202T0000", verbose=False,
                                device="cpu", engine="scan"), KERNEL_TOL)


def test_runner_engine_parity(tmp_path):
    """tests/test_production.py:215: example1's stations on a 4 x 5 point
    grid, uncoupled, no sky view (the station-rank prep: K2)."""
    cfg = _example1(tmp_path, use_coupling=0)
    cfg["time"]["analysis"] = 1
    cfg["points"] = {"grid": {"bbox": [60.1, 24.8, 61.0, 26.1],
                              "ny": 4, "nx": 5}}
    cfg["parameters"].pop("sky_view_file")
    cfg["parameters"].pop("local_horizon_file")
    cfgp = _write(tmp_path, cfg)
    port = port_kernel(cfgp, "20191202T0000")
    steps = port[1]["steps"]
    assert steps[0] == 0 and len(steps) > 2
    hold_kernel(port, jrunner.run(str(cfgp), "20191202T0000", verbose=False,
                                  engine="pallas"))
    hold_scan(port, trunner.run(str(cfgp), "20191202T0000", verbose=False,
                                device="cpu", engine="scan"),
              dict(rtol=1e-4, atol=5e-3))


def test_production_warm_start_cycle(tmp_path):
    """tests/test_production.py:346: checkpoint_out -> checkpoint_in across
    two runs of the kernel engine, against the JAX package's kernel engine
    and the port's scan engine; the warm start changes the early
    trajectory."""
    fc, ob, _ = test_io._write_full_inputs(tmp_path)
    cfgp = test_io._write_config(tmp_path, fc, ob, tmp_path / "o1.json")
    ck = {k: str(tmp_path / f"ck_{k}.npz") for k in ("port", "jax", "scan")}
    port = port_kernel(cfgp, checkpoint_out=ck["port"])
    hold_kernel(port, jrunner.run(str(cfgp), checkpoint_out=ck["jax"],
                                  verbose=False, engine="pallas"))
    scan = trunner.run(str(cfgp), checkpoint_out=ck["scan"], verbose=False,
                       device="cpu", engine="scan")
    zp, zj, zs = (np.load(ck[k]) for k in ("port", "jax", "scan"))
    assert list(zp["point_ids"]) == list(zj["point_ids"]) == [7, 8]
    np.testing.assert_allclose(zp["tmp"], zj["tmp"], **KERNEL_TOL)
    np.testing.assert_allclose(zp["tmp"], zs["tmp"], rtol=1e-4, atol=5e-3)

    # cycle 2 from each checkpoint
    port2 = port_kernel(cfgp, checkpoint_in=ck["port"])
    hold_kernel(port2, jrunner.run(str(cfgp), checkpoint_in=ck["jax"],
                                   verbose=False, engine="pallas"))
    scan2 = trunner.run(str(cfgp), checkpoint_in=ck["scan"], verbose=False,
                        device="cpu", engine="scan")
    hold_scan(port2, scan2, dict(rtol=1e-4, atol=5e-3))
    np.testing.assert_allclose(host(port2[0].tmp), host(scan2[0].tmp),
                               rtol=1e-4, atol=5e-3)
    assert not np.allclose(port2[1]["tsurf"][0], port[1]["tsurf"][0])


def _grid_station_config(tmp_path):
    """example2's NWP grid under its ASCII station obs on a 6 x 8 point
    grid (a GridExpander overlaid by a StationExpander: K3 fused)."""
    gen = load_script(os.path.join(EXAMPLES, "example2", "make_data.py"),
                      "ex2_make_data")
    gen.main(["--analysis", "2", "--forecast", "2", "--ny", "6", "--nx", "8",
              "--outdir", str(tmp_path)])
    cfg = read_json_tolerant(
        os.path.join(EXAMPLES, "example2", "grid_config.json"))
    cfg["time"]["analysis"] = 1
    cfg["time"]["forecast"] = 1
    cfg["model"]["DTSecs"] = 120
    cfg["points"]["grid"]["ny"] = 6
    cfg["points"]["grid"]["nx"] = 8
    cfg["points"].pop("mask")
    cfg["input"][0]["path"] = str(tmp_path / "forecast_grid.npz")
    cfg["input"][1]["path"] = str(tmp_path / "road_station.txt")
    cfg["output"]["filename"] = str(tmp_path / "out.npz")
    return _write(tmp_path, cfg)


@pytest.mark.parametrize("route", ["station_K2", "station_sky_K3_fused",
                                   "grid_station_K3_fused"])
def test_results_do_not_depend_on_the_chunk_length(tmp_path, route,
                                                   capsys):
    """One config at two chunk lengths and the auto length: the same output
    rows, final state and written file -- the kernel carries the state
    across chunks.  Bit for bit on the station routes, whose forcing is a
    function of the global step alone.  The grid's time interpolation
    evaluates each segment's line from the chunk's first step
    (``GridExpander.segments``, as the JAX package does: the float32
    cancellation stays at window scale), so its float32 forcing may differ
    by an ulp between chunk lengths; that route is held at the kernel
    tolerances with equal failed masks."""
    if route == "grid_station_K3_fused":
        cfgp, note = _grid_station_config(tmp_path), "K3 fused"
    else:
        cfg = _example1(tmp_path, use_coupling=0)
        if route == "station_K2":
            cfg["parameters"].pop("sky_view_file")
            cfg["parameters"].pop("local_horizon_file")
        cfg["output"]["filename"] = str(tmp_path / "out.json")
        cfgp = _write(tmp_path, cfg)
        note = ("slim kernel mode K2" if route == "station_K2"
                else "K3 fused")
    ext = ".json" if route.startswith("station") else ".npz"
    runs = []
    for chunk_t in (16, 40, 0):
        runs.append(port_kernel(
            cfgp, "20191202T0000", chunk_t=chunk_t, verbose=True,
            output_path=str(tmp_path / f"out_{chunk_t}{ext}")))
        assert note in capsys.readouterr().err
    s0, f0 = runs[0]
    for s, f in runs[1:]:
        np.testing.assert_array_equal(f["steps"], f0["steps"])
        np.testing.assert_array_equal(s.failed, s0.failed)
        if ext == ".npz":
            hold_kernel((s, f), (s0, f0))
            continue
        for n in NAMES:
            np.testing.assert_array_equal(f[n], f0[n], err_msg=n)
        for a, b in zip(s, s0):
            assert torch.equal(a, b)
    if ext == ".json":
        files = [tmp_path / f"out_{c}{ext}" for c in (16, 40, 0)]
        assert len({f.read_bytes() for f in files}) == 1


def test_auto_chunk_is_the_jax_runners_whatever_the_grid_span():
    """The runner's auto chunk is the JAX runner's,
    ``production.auto_chunk_t`` of the point count
    (roadsurf_tpu/runner.py:457-458), whatever a grid source's clock: a
    small run's chunk over an hourly grid at dt 120 s is the cap, 1,024
    steps, whose window holds 36 segments (K3 fused and K5 fused take any
    SPAN); and grid_span is the expander's own SPAN."""
    from roadsurf_tpu_torch import production
    from roadsurf_tpu_torch.ops.scan_kernel import stage_width
    from test_torch_fused_span import K3_16
    t0 = 1575244800
    times = t0 + 3600 * np.arange(50)
    sim = t0 + 120 * np.arange(1201)                  # 40 h
    for n in (1, 128, 65536, 1048576, 10 ** 9):
        assert trunner.auto_chunk_t(n) == production.auto_chunk_t(n)
    c = trunner.auto_chunk_t(128)
    assert c == production.CHUNK_CAP == 1024
    assert production.grid_span(times, sim, c) == 36
    # above the stage width of its one channel on an H100
    assert production.grid_span(times, sim, c) > stage_width(1, 36, K3_16)
    rng = np.random.default_rng(0)
    lats, lons = np.linspace(60, 61, 3), np.linspace(24, 25, 4)
    fields = {"tair": rng.normal(0, 1, (50, 3, 4))}
    for chunk_t in (16, 64, 256, 1024):
        g = production.GridExpander(times, lats, lons, fields,
                                    np.full(128, 60.5), np.full(128, 24.5),
                                    sim, "cpu", chunk_t=chunk_t)
        assert g.SPAN == production.grid_span(times, sim, chunk_t)
