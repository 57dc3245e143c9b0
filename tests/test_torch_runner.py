"""The port's runner (``roadsurf_tpu_torch.runner``), scan engine on the
CPU, against the JAX package's runner on the same configs, files and
``-t`` time: both float64, held at 1e-9, with equal failed masks; the
files each writes (forecast JSON, grid npz, checkpoints) read back through
either package's reader, equal in keys, point ids and times, and in values
at the same bar.

The cases are those of tests/test_examples.py:25-143 (example1 with its
warm-started second cycle, example2's grid with the ASCII and the
expression mask), tests/test_io.py:198-258 (end to end, coupled, warm
start, missing budget) and tests/test_points.py:64 (grid point mode over
stations)."""
import json
import os

import numpy as np
import pytest
import torch

from roadsurf_tpu import runner as jrunner
from roadsurf_tpu.io import writer as jwriter
from roadsurf_tpu.io.sources import read_json_tolerant
from roadsurf_tpu_torch import runner as trunner
from roadsurf_tpu_torch.io import writer as twriter

from test_examples import EXAMPLES, load_script
from test_io import _write_config, _write_full_inputs

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-9)
NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")
STATE = ("tmp", "tsurf_ave", "wat", "snow", "ice", "ice2", "dep", "q2melt",
         "t4melt", "very_cold", "evap", "blcond", "albedo", "failed")


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both(cfg_path, tmp_path, t=None, tol=TOL, **kw):
    """Run ``cfg_path`` through the port (CPU, scan engine) and the JAX
    runner, each writing its own files; hold the fields and the final state
    at ``tol`` with equal failed masks.  ``kw`` takes ``output``,
    ``checkpoint_in`` and ``checkpoint_out`` as ``{"port": path, "jax":
    path}`` pairs.  Returns ((port state, fields), (jax state, fields))."""
    per = lambda side: {name: v[side] for name, v in kw.items()}
    kp, kj = per("port"), per("jax")
    port = trunner.run(str(cfg_path), t, output_path=kp.get("output"),
                       checkpoint_in=kp.get("checkpoint_in"),
                       checkpoint_out=kp.get("checkpoint_out"),
                       verbose=False, device="cpu")
    jax_ = jrunner.run(str(cfg_path), t, output_path=kj.get("output"),
                       checkpoint_in=kj.get("checkpoint_in"),
                       checkpoint_out=kj.get("checkpoint_out"),
                       verbose=False, engine="scan")
    (ps, pf), (js, jf) = port, jax_
    assert set(pf) == set(jf)
    for n in pf:
        np.testing.assert_allclose(pf[n], np.asarray(jf[n]), **tol,
                                   err_msg=n)
    for n in STATE:
        np.testing.assert_allclose(host(getattr(ps, n)),
                                   np.asarray(getattr(js, n)), **tol,
                                   err_msg=n)
    np.testing.assert_array_equal(host(ps.failed), np.asarray(js.failed))
    return port, jax_


def same_json(port_path, jax_path, tol=TOL):
    """Two forecast JSON files: equal records, ids, locations and times;
    values at ``tol``."""
    dp, dj = (json.loads(open(p).read()) for p in (port_path, jax_path))
    assert len(dp) == len(dj)
    for rp, rj in zip(dp, dj):
        assert set(rp) == set(rj)
        assert (rp["statId"], rp["lat"], rp["lon"], rp["time"]) == (
            rj["statId"], rj["lat"], rj["lon"], rj["time"])
        for k in rp:
            if k not in ("statId", "lat", "lon", "time"):
                np.testing.assert_allclose(rp[k], rj[k], **tol, err_msg=k)
    return dp


def same_npz(port_path, jax_path, tol=TOL):
    zp, zj = np.load(port_path), np.load(jax_path)
    assert set(zp.files) == set(zj.files)
    for k in zp.files:
        assert zp[k].shape == zj[k].shape, k
        if zp[k].dtype.kind in "iub":
            np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)
        else:
            np.testing.assert_allclose(zp[k], zj[k], **tol, err_msg=k)
    return zp


def same_checkpoint(port_path, jax_path, tol=TOL):
    """Each checkpoint through both packages' readers: the same arrays
    whoever reads; the two files' states at ``tol``."""
    for path in (port_path, jax_path):
        fp, ip, ep = twriter.load_checkpoint(path)
        fj, ij, ej = jwriter.load_checkpoint(path)
        assert set(fp) == set(fj) and ep == ej
        np.testing.assert_array_equal(ip, ij)
        for k in fp:
            np.testing.assert_array_equal(fp[k], fj[k], err_msg=k)
    fp, ip, ep = twriter.load_checkpoint(port_path)
    fj, ij, ej = jwriter.load_checkpoint(jax_path)
    assert list(ip) == list(ij) and ep == ej and set(fp) == set(fj)
    for k in fp:
        np.testing.assert_allclose(fp[k], fj[k], **tol, err_msg=k)
    return ip


def pair(tmp_path, name):
    return {"port": str(tmp_path / f"port_{name}"),
            "jax": str(tmp_path / f"jax_{name}")}


# ---------------------------------------------------------------------------
# the shipped examples (tests/test_examples.py:25-143)
# ---------------------------------------------------------------------------

def _example1_config(tmp_path, dt=120):
    gen = load_script(os.path.join(EXAMPLES, "example1", "make_data.py"),
                      "ex1_make_data")
    gen.main(["--stations", "3", "--analysis", "4", "--forecast", "4",
              "--outdir", str(tmp_path)])
    cfg = read_json_tolerant(
        os.path.join(EXAMPLES, "example1", "example_config.json"))
    cfg["time"]["analysis"] = 4
    cfg["time"]["forecast"] = 2
    cfg["model"]["DTSecs"] = dt
    for src in cfg["input"]:
        src["path"] = str(tmp_path / os.path.basename(src["path"]))
    cfg["parameters"]["sky_view_file"] = str(tmp_path / "skyview.txt")
    cfg["parameters"]["local_horizon_file"] = str(tmp_path / "horizons.txt")
    cfg["output"]["filename"] = str(tmp_path / "unused.json")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg_path


def test_example1_end_to_end(tmp_path):
    """example1's full feature set (station JSON, sky view and horizons,
    coupling, relaxation), then a warm-started second cycle one hour later
    from each package's checkpoint, read by the other package too."""
    cfg_path = _example1_config(tmp_path)
    out, ck = pair(tmp_path, "out.json"), pair(tmp_path, "state.npz")
    both(cfg_path, tmp_path, "20191202T0000", output=out, checkpoint_out=ck)
    doc = same_json(out["port"], out["jax"])
    assert len(doc) == 3
    for st in doc:
        n = len(st["time"])
        assert n >= 4
        for key in ("RoadTemperature", "Water", "Snow", "Ice", "Deposit"):
            assert np.isfinite(np.asarray(st[key], float)).all()
        assert -40 < st["RoadTemperature"][-1] < 30
    assert list(same_checkpoint(ck["port"], ck["jax"])) == [1001, 1002, 1003]

    # the second cycle, each package warm-started from its own checkpoint;
    # then the port from the JAX package's and the JAX package from the
    # port's: the same result at the bar
    out2 = pair(tmp_path, "out2.json")
    (ps, pf), _ = both(cfg_path, tmp_path, "20191202T0100", output=out2,
                       checkpoint_in=ck)
    same_json(out2["port"], out2["jax"])
    _, crossed = both(cfg_path, tmp_path, "20191202T0100",
                      checkpoint_in={"port": ck["jax"], "jax": ck["port"]})
    for n in NAMES:
        np.testing.assert_allclose(crossed[1][n], pf[n], **TOL, err_msg=n)


@pytest.mark.parametrize("mask", ["ascii", "expression"])
def test_example2_grid_end_to_end(tmp_path, mask):
    """example2: NWP grid + ASCII station obs on a masked point grid, the
    gridded output (the querydata writer's nine parameters)."""
    gen = load_script(os.path.join(EXAMPLES, "example2", "make_data.py"),
                      "ex2_make_data")
    gen.main(["--analysis", "2", "--forecast", "2", "--ny", "6", "--nx", "8",
              "--outdir", str(tmp_path)])
    cfg = read_json_tolerant(
        os.path.join(EXAMPLES, "example2", "grid_config.json"))
    cfg["time"]["analysis"] = 2
    cfg["time"]["forecast"] = 2
    cfg["model"]["DTSecs"] = 120
    cfg["points"]["grid"]["ny"] = 6
    cfg["points"]["grid"]["nx"] = 8
    cfg["points"]["mask"] = (
        {"path": str(tmp_path / "road_mask.txt"), "include": "1"}
        if mask == "ascii" else
        {"path": str(tmp_path / "static_grid.npz"),
         "enable": "elevation < 120 && !missing(landcover)"})
    cfg["input"][0]["path"] = str(tmp_path / "forecast_grid.npz")
    cfg["input"][1]["path"] = str(tmp_path / "road_station.txt")
    cfg["output"]["filename"] = str(tmp_path / "unused.npz")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = pair(tmp_path, "out.npz")
    both(cfg_path, tmp_path, "20191202T0000", output=out)
    z = same_npz(out["port"], out["jax"])
    for key in ("tsurf", "tair", "tdew", "tdew_deficit", "snow", "water",
                "ice", "deposit", "ice2"):
        assert z[key].shape == (z["times"].shape[0], 6, 8)
    keep = z["mask"].astype(bool)
    assert keep.any() and not keep.all()
    assert np.isfinite(z["tsurf"][:, keep]).all()


# ---------------------------------------------------------------------------
# tests/test_io.py:198-258 and tests/test_points.py:64
# ---------------------------------------------------------------------------

def test_runner_end_to_end(tmp_path):
    fc, ob, _ = _write_full_inputs(tmp_path)
    out = pair(tmp_path, "out.json")
    cfgp = _write_config(tmp_path, fc, ob, tmp_path / "unused.json")
    both(cfgp, tmp_path, output=out)
    doc = same_json(out["port"], out["jax"])
    assert len(doc) == 2 and doc[0]["statId"] == 7
    assert len(doc[0]["time"]) == len(doc[0]["RoadTemperature"]) == 7
    ts = np.array(doc[0]["RoadTemperature"])
    assert np.all(ts > -30) and np.all(ts < 20)
    assert "Ice2" not in doc[0]


def test_runner_coupled_end_to_end(tmp_path):
    fc, ob, _ = _write_full_inputs(tmp_path)
    out = pair(tmp_path, "outc.json")
    cfgp = _write_config(tmp_path, fc, ob, tmp_path / "unused.json",
                         use_coupling=1, coupling_minutes=30)
    both(cfgp, tmp_path, output=out)
    doc = same_json(out["port"], out["jax"])
    assert len(doc) == 2
    assert np.all(np.isfinite(doc[0]["RoadTemperature"]))


def test_runner_warm_start_cycle(tmp_path):
    fc, ob, _ = _write_full_inputs(tmp_path)
    cfgp = _write_config(tmp_path, fc, ob, tmp_path / "unused.json")
    ck = pair(tmp_path, "state.npz")
    (_, f1), _ = both(cfgp, tmp_path, checkpoint_out=ck)
    ids = same_checkpoint(ck["port"], ck["jax"])
    assert list(ids) == [7, 8]
    assert twriter.load_checkpoint(ck["port"])[0]["tmp"].shape[1] == 17
    (_, f2), _ = both(cfgp, tmp_path, checkpoint_in=ck)
    assert not np.allclose(f1["tsurf"][0], f2["tsurf"][0])


def test_runner_missing_budget(tmp_path):
    fc, ob, _ = _write_full_inputs(tmp_path)
    doc = json.loads(fc.read_text())
    doc[0]["Humidity"] = [200.0] * len(doc[0]["Humidity"])   # out of range
    fc.write_text(json.dumps(doc))
    cfgp = _write_config(tmp_path, fc, ob, tmp_path / "out.json")
    cfg = json.loads(cfgp.read_text())
    cfg["missing_limit"] = 40
    cfgp.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="exceeds missing_limit"):
        trunner.run(str(cfgp), verbose=False, device="cpu")
    # within the budget both packages fail the same point
    cfg["missing_limit"] = 60
    cfgp.write_text(json.dumps(cfg))
    (ps, _), _ = both(cfgp, tmp_path)
    assert host(ps.failed).tolist() == [True, False]


def test_runner_grid_mode(tmp_path):
    fc, ob, _ = _write_full_inputs(tmp_path)
    cfgp = _write_config(tmp_path, fc, ob, tmp_path / "unused.json")
    cfg = json.loads(cfgp.read_text())
    cfg["points"] = {"grid": {"bbox": [60.05, 24.4, 60.09, 24.6],
                              "ny": 2, "nx": 2}, "max_radius_km": 30.0}
    cfgp.write_text(json.dumps(cfg))
    out = pair(tmp_path, "out.json")
    both(cfgp, tmp_path, output=out)
    doc = same_json(out["port"], out["jax"])
    assert len(doc) == 4
    assert all(np.isfinite(r["RoadTemperature"]).all() for r in doc)
