"""The port's runner on gridded sources, and its surroundings: the cases of
tests/test_gridsource.py:283-340 (grid source to gridded output, the
missing points section, a grid forecast overlaid by station observations)
through the port's scan engine against the JAX package's at 1e-9 with the
files compared; the cases of tests/test_aux.py (``RunMetrics``, the
extended writer, the example1 config and its sky-view files through both
packages' parsers); and the runner's device and engine rules, the console
entry and ``profile_trace``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from roadsurf_tpu.config import ModelSettings as JSettings
from roadsurf_tpu.config import PhysicsParams as JParams
from roadsurf_tpu.io import skyview as jsky
from roadsurf_tpu.io import sources as jsrc
from roadsurf_tpu.io import writer as jwriter
from roadsurf_tpu.observability import RunMetrics as JRunMetrics
from roadsurf_tpu_torch import production
from roadsurf_tpu_torch import runner as trunner
from roadsurf_tpu_torch.config import ModelSettings, PhysicsParams
from roadsurf_tpu_torch.io import skyview as tsky
from roadsurf_tpu_torch.io import sources as tsrc
from roadsurf_tpu_torch.io import writer as twriter
from roadsurf_tpu_torch.observability import RunMetrics, profile_trace

from test_gridsource import _write_grid_npz, utc
from test_torch_runner import both, pair, same_json, same_npz

torch.set_num_threads(1)

EX1 = os.path.join(os.path.dirname(__file__), "..", "examples", "example1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# tests/test_gridsource.py:283-340
# ---------------------------------------------------------------------------

def test_runner_grid_source_to_grid_output(tmp_path):
    t0 = utc("2019-12-02 00:00")
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, t0, nhours=7)
    cfg = {
        "time": {"analysis": 2, "forecast": 4, "now": "20191202T0200"},
        "model": {"use_coupling": 0, "use_relaxation": 0, "DTSecs": 60.0},
        "output": {"step": 60, "filename": str(tmp_path / "unused.npz")},
        "points": {"grid": {"bbox": [60.0, 24.0, 61.0, 25.5],
                            "ny": 3, "nx": 4}},
        "input": [{"name": "FC", "path": str(fc), "type": "grid",
                   "source": "forecast"}],
    }
    cfgp = tmp_path / "config.json"
    cfgp.write_text(json.dumps(cfg))
    out = pair(tmp_path, "out.npz")
    (ps, _), _ = both(cfgp, tmp_path, output=out)
    assert not ps.failed.any()
    z = same_npz(out["port"], out["jax"])
    assert z["tsurf"].shape == (7, 3, 4)
    for name in ("tsurf", "tair", "tdew", "tdew_deficit", "snow", "water",
                 "ice", "deposit", "ice2"):
        assert name in z.files
    assert np.all(z["tsurf"] > -30) and np.all(z["tsurf"] < 20)
    np.testing.assert_allclose(z["tdew_deficit"], z["tsurf"] - z["tdew"],
                               atol=1e-5)
    assert z["mask"].all()


@pytest.mark.parametrize("engine", ["scan", "kernel"])
def test_runner_grid_source_requires_points(tmp_path, engine):
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, utc("2019-12-02 00:00"))
    cfg = {"time": {"analysis": 1, "forecast": 1, "now": "20191202T0100"},
           "model": {"DTSecs": 60.0},
           "input": [{"path": str(fc), "type": "grid"}]}
    cfgp = tmp_path / "config.json"
    cfgp.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="points"):
        trunner.run(str(cfgp), verbose=False, device="cpu", engine=engine)


def test_runner_grid_source_overlay_with_station_obs(tmp_path):
    """Grid forecast + station observations overlay-merged at latlon keys
    (DataManager.cpp:67-77), relaxation anchored on the obs."""
    t0 = utc("2019-12-02 00:00")
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, t0, nhours=7)
    ob = tmp_path / "obs.json"
    import time as timelib
    ob.write_text(json.dumps([{
        "statId": 1, "lat": 60.5, "lon": 24.75,
        "time": [timelib.strftime("%Y-%m-%d %H:%M",
                                  timelib.gmtime(t0 + 3600 * k))
                 for k in range(3)],
        "Temperature 2m": [-6.0, -5.5, -5.0],
        "RoadTemperature": [-7.0, -6.5, -6.0]}]))
    cfg = {
        "time": {"analysis": 2, "forecast": 4, "now": "20191202T0200"},
        "model": {"use_coupling": 0, "use_relaxation": 1, "DTSecs": 60.0},
        "output": {"step": 60, "filename": str(tmp_path / "unused.json")},
        "points": {"coordinates": [[60.5, 24.75], [60.9, 25.2]],
                   "max_radius_km": 30.0},
        "input": [
            {"name": "FC", "path": str(fc), "type": "grid",
             "source": "forecast"},
            {"name": "OBS", "path": str(ob), "type": "json",
             "source": "observations"},
        ],
    }
    cfgp = tmp_path / "config.json"
    cfgp.write_text(json.dumps(cfg))
    out = pair(tmp_path, "out.json")
    both(cfgp, tmp_path, output=out)
    doc = same_json(out["port"], out["jax"])
    assert len(doc) == 2
    assert np.all(np.isfinite(doc[0]["RoadTemperature"]))
    assert not np.allclose(doc[0]["RoadTemperature"],
                           doc[1]["RoadTemperature"])


# ---------------------------------------------------------------------------
# tests/test_aux.py
# ---------------------------------------------------------------------------

def test_run_metrics(capsys):
    for cls in (RunMetrics, JRunMetrics):
        m = cls()
        with m.phase("stream"):
            pass
        m.count("points", 8)
        assert "stream" in m.phases
    # the JAX class's rate over one phase; the port's RunMetrics has none
    assert m.point_steps_per_s(100, 10, "stream") > 0
    assert m.point_steps_per_s(100, 10, "never") is None
    m = RunMetrics()
    m.phases["stream"] = 2.0
    m.count("points", 8)
    m.report(stream=sys.stdout)
    doc = json.loads(capsys.readouterr().out)
    assert doc == {"phases_s": {"stream": 2.0}, "counters": {"points": 8}}


def test_extended_writer_is_the_jax_writers_file(tmp_path):
    T, P = 6, 2
    rng = np.random.default_rng(0)
    fields = {k: rng.normal(0, 1, (T, P)) for k in
              ("tsurf", "wat", "snow", "ice", "ice2", "dep")}
    tair = rng.normal(0, 1, (T, P))
    args = ([1, 2], [60.0, 61.0], [24.0, 25.0],
            1575244800 + np.arange(T) * 60, fields, tair, tair - 2.0)
    twriter.write_forecast_json_extended(str(tmp_path / "p.json"), *args,
                                         output_stride=2)
    jwriter.write_forecast_json_extended(str(tmp_path / "j.json"), *args,
                                         output_stride=2)
    assert (tmp_path / "p.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()
    doc = json.loads((tmp_path / "p.json").read_text())
    assert set(doc[0]) >= {"RoadTemperature", "Temperature2m", "DewPoint",
                           "DewPointDeficit", "Snow", "Water", "Ice",
                           "Deposit", "Ice2"}
    assert len(doc[0]["time"]) == 3


def test_example1_config_parses():
    """The example1 config and its sky-view files through both packages'
    parsers (tests/test_aux.py:66-82, on the repo's copies)."""
    cfg = tsrc.read_json_tolerant(os.path.join(EX1, "example_config.json"))
    assert cfg == jsrc.read_json_tolerant(
        os.path.join(EX1, "example_config.json"))
    s, js = ModelSettings.from_json(cfg), JSettings.from_json(cfg)
    assert s.use_coupling and s.use_relaxation and s.dt == 30.0
    assert dataclass_dict(s) == dataclass_dict(js)
    p = PhysicsParams.from_json(s, cfg.get("parameters", {}))
    jp = JParams.from_json(js, cfg.get("parameters", {}))
    assert p.emiss == 0.95 and dataclass_dict(p) == dataclass_dict(jp)
    ids = [1001, 1002, 1003]
    files = (os.path.join(EX1, "skyview.txt"),
             os.path.join(EX1, "horizons.txt"))
    svf, hor = tsky.sky_variables(ids, *files)
    jsvf, jhor = jsky.sky_variables(ids, *files)
    np.testing.assert_array_equal(svf, jsvf)
    np.testing.assert_array_equal(hor, jhor)
    assert hor.shape == (3, 360)
    assert len(cfg["input"]) == 2
    assert cfg["input"][1]["source"] == "observations"


def dataclass_dict(x):
    import dataclasses
    return dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# devices, engines, the console entry, profile traces
# ---------------------------------------------------------------------------

def test_engines_follow_the_named_device():
    assert trunner._resolve_engine("auto", "cuda") == "kernel"
    assert trunner._resolve_engine("auto", torch.device("cuda", 0)) == \
        "kernel"
    assert trunner._resolve_engine("auto", "cpu") == "scan"
    for dev in ("cuda", "cpu"):
        assert trunner._resolve_engine("pallas", dev) == "kernel"
        assert trunner._resolve_engine("kernel", dev) == "kernel"
        assert trunner._resolve_engine("scan", dev) == "scan"
    with pytest.raises(ValueError, match="unknown engine"):
        trunner._resolve_engine("xla", "cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_default_device_raises_without_a_card(tmp_path):
    """The default device is the card; without one, run() and the CLI
    raise instead of running on the CPU."""
    cfgp = tmp_path / "config.json"
    cfgp.write_text("{}")
    for engine in ("auto", "scan", "kernel"):
        with pytest.raises(RuntimeError, match="no.*CUDA|CUDA device"):
            trunner.run(str(cfgp), verbose=False, engine=engine)
    with pytest.raises(RuntimeError, match="--device cpu"):
        trunner.main(["-c", str(cfgp)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        trunner.check_device("cuda")
    assert trunner.check_device("cpu") == torch.device("cpu")


def test_console_entry_runs_the_config(tmp_path):
    """``python -m roadsurf_tpu_torch.runner`` with its flags, in a process
    of its own: exit code 0, and the file it writes is the in-process
    run's; the pyproject entry names the same main."""
    t0 = utc("2019-12-02 00:00")
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, t0, nhours=3)
    cfg = {"time": {"analysis": 1, "forecast": 1},
           "model": {"use_relaxation": 0, "DTSecs": 300.0},
           "points": {"coordinates": [[60.2, 24.5], [60.7, 25.1]]},
           "input": [{"path": str(fc), "type": "grid"}]}
    cfgp = tmp_path / "config.json"
    cfgp.write_text(json.dumps(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = (REPO + os.pathsep + env.get("PYTHONPATH", "")
                         ).rstrip(os.pathsep)
    res = subprocess.run(
        [sys.executable, "-m", "roadsurf_tpu_torch.runner", "-c", str(cfgp),
         "-t", "20191202T0100", "-o", str(tmp_path / "cli.json"),
         "--device", "cpu", "--engine", "pallas", "--chunk-t", "8"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    trunner.run(str(cfgp), "20191202T0100",
                output_path=str(tmp_path / "lib.json"), verbose=False,
                device="cpu", engine="kernel", chunk_t=8)
    assert (tmp_path / "cli.json").read_bytes() == (
        tmp_path / "lib.json").read_bytes()
    toml = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'roadsurf-tpu-torch = "roadsurf_tpu_torch.runner:main"' in toml


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).add_(1.0)
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    with profile_trace(None):
        pass


def test_auto_chunk_t_rule():
    """chunk_t x P held near the target, within [floor, cap], a multiple
    of 8 (production.py:110-121's rule)."""
    target = production.CHUNK_TARGET_POINT_STEPS
    for p in (1, 128, 1000, 65536, 262144, 1048576, 4194304, 10 ** 8):
        c = production.auto_chunk_t(p)
        assert c % 8 == 0
        assert production.CHUNK_FLOOR <= c <= production.CHUNK_CAP
        want = min(production.CHUNK_CAP,
                   max(production.CHUNK_FLOOR, target // p))
        assert want - 8 < c <= want
    assert production.auto_chunk_t(1) == production.CHUNK_CAP
    assert production.auto_chunk_t(10 ** 9) == production.CHUNK_FLOOR
