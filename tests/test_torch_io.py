"""The port's host data plane (``roadsurf_tpu_torch.io``: interp, native,
sources, skyview, gridsource's GridSource, masks, points, driver, smartmet)
against the JAX package's modules on the same files and arrays.  Both are
host numpy (and the same native library), so the bar is bitwise.

The cases are those of tests/test_io.py:22-135 and :260 (interpolation,
sources, overlay, sky-view files, ASCII), tests/test_points.py:20-63,
tests/test_native.py (the five; the ones that need the built library skip
when it cannot be built, as those do), tests/test_smartmet.py (a local
http.server) and tests/test_gridsource.py:161-281 (GridSource, directory
merge, latest valid time, RH clamp, masks), each checked on its own terms
and against the JAX package; and the example generators' inputs through
both packages' DataHandler and read_input derivation."""
import http.server
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from roadsurf_tpu.config import ModelSettings as JSettings
from roadsurf_tpu.io import driver as jdriver
from roadsurf_tpu.io import gridsource as jgs
from roadsurf_tpu.io import interp as jinterp
from roadsurf_tpu.io import masks as jmasks
from roadsurf_tpu.io import native as jnative
from roadsurf_tpu.io import points as jpoints
from roadsurf_tpu.io import skyview as jsky
from roadsurf_tpu.io import smartmet as jsm
from roadsurf_tpu.io import sources as jsrc
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch.io import driver as tdriver
from roadsurf_tpu_torch.io import gridsource as tgs
from roadsurf_tpu_torch.io import interp as tinterp
from roadsurf_tpu_torch.io import masks as tmasks
from roadsurf_tpu_torch.io import native as tnative
from roadsurf_tpu_torch.io import points as tpoints
from roadsurf_tpu_torch.io import skyview as tsky
from roadsurf_tpu_torch.io import smartmet as tsm
from roadsurf_tpu_torch.io import sources as tsrc

from test_gridsource import _write_grid_npz, utc
from test_io import _make_station_json

torch.set_num_threads(1)

MISSING = -9999.9
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
LIB = tnative.load(build_if_missing=True)
needs_lib = pytest.mark.skipif(LIB is None,
                               reason="native library build unavailable")


def same(got, want, what=""):
    """Bitwise equality of nested results: arrays (dtype too), dicts,
    sequences, NamedTuples, StationData, scalars."""
    if hasattr(want, "_fields"):                        # NamedTuple
        assert type(got).__name__ == type(want).__name__, what
        for name in want._fields:
            same(getattr(got, name), getattr(want, name), f"{what}.{name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            same(got[k], want[k], f"{what}[{k}]")
    elif hasattr(want, "values") and hasattr(want, "point_id"):
        assert (got.point_id, got.lat, got.lon) == (
            want.point_id, want.lat, want.lon), what
        same(got.values, want.values, f"{what}.values")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# interpolation (tests/test_io.py:22-84)
# ---------------------------------------------------------------------------

H = 3600
SERIES_CASES = [
    ("linear_and_exact", [utc("2019-12-02 00:00") + H * k for k in range(3)],
     [utc("2019-12-02 00:00") + 60 * m for m in (0, 30, 60, 105, 120,
                                                  150)],
     {"tair": [0.0, 2.0, 4.0]}),
    ("missing_endpoint", [0, H, 2 * H], [1800, 5400],
     {"tair": [0.0, MISSING, 4.0]}),
    ("prec_phase_next", [0, H], [0, 600, 3599], {"prec_phase": [1.0, 3.0]}),
    ("before_start", [H, 2 * H], [0, 1800, H], {"sw": [5.0, 7.0]}),
    ("lw_net_threshold", [0, H], [0, 1800, H],
     {"lw_net": [-500.0, -900.0], "tair": [-150.0, 1.0]}),
]


@pytest.mark.parametrize("case", SERIES_CASES, ids=[c[0] for c in SERIES_CASES])
def test_interpolate_series_matches_jax(case):
    _, raw_t, sim_t, vals = case
    args = (np.asarray(raw_t, np.int64), np.asarray(sim_t, np.int64),
            {k: np.asarray(v) for k, v in vals.items()})
    got = tinterp.interpolate_series(*args)
    same(got, jinterp.interpolate_series(*args))
    if case[0] == "linear_and_exact":
        np.testing.assert_allclose(got["tair"][:5], [0.0, 1.0, 2.0, 3.5, 4.0])
        assert got["tair"][5] == MISSING
    if case[0] == "prec_phase_next":
        np.testing.assert_array_equal(got["prec_phase"], [1.0, 3.0, 3.0])


def test_interpolation_random_series_matches_jax():
    """A seeded station block with scattered missing values and a points
    axis, every variable, through both packages."""
    rng = np.random.default_rng(5)
    raw_t = np.sort(rng.choice(np.arange(0, 40 * H, 600), 60,
                               replace=False)).astype(np.int64)
    sim_t = np.arange(-H, 41 * H, 450, dtype=np.int64)
    vals = {}
    for name in tsrc.VAR_NAMES:
        v = rng.normal(0.0, 50.0, (4, len(raw_t)))
        v[rng.random(v.shape) < 0.2] = MISSING
        vals[name] = v
    same(tinterp.interpolate_series(raw_t, sim_t, vals),
         jinterp.interpolate_series(raw_t, sim_t, vals))
    for row in range(4):
        same(tinterp.interpolate_gap_capped(raw_t, sim_t, vals["tair"][row],
                                            max_gap_minutes=60.0),
             jinterp.interpolate_gap_capped(raw_t, sim_t, vals["tair"][row],
                                            max_gap_minutes=60.0))


def test_gap_capped_interpolation():
    """RoadSurfSource interpolation (tests/test_io.py:50-66)."""
    raw_t = np.array([0, 1 * H, 2 * H, 6 * H, 7 * H])
    vals = np.array([0.0, MISSING, 4.0, 12.0, 14.0])
    sim_t = np.array([-H // 2, 0, H, H + 1800, 4 * H, 6 * H + 1800])
    out = tinterp.interpolate_gap_capped(raw_t, sim_t, vals,
                                         max_gap_minutes=180.0)
    same(out, jinterp.interpolate_gap_capped(raw_t, sim_t, vals,
                                             max_gap_minutes=180.0))
    assert out[0] == MISSING and out[1] == 0.0 and out[4] == MISSING
    np.testing.assert_allclose(out[[2, 3, 5]], [2.0, 3.0, 13.0])
    same(tinterp.interpolate_gap_capped(np.zeros(0, np.int64), sim_t,
                                        np.zeros(0)),
         jinterp.interpolate_gap_capped(np.zeros(0, np.int64), sim_t,
                                        np.zeros(0)))


# ---------------------------------------------------------------------------
# sources (tests/test_io.py:69-135, :260)
# ---------------------------------------------------------------------------

def test_roadsurf_source_gap_cap(tmp_path):
    times = ["2019-12-02T00:00", "2019-12-02T01:00", "2019-12-02T06:00"]
    path = tmp_path / "prev.json"
    path.write_text(json.dumps([{"statId": 7, "lat": 60.0, "lon": 25.0,
                                 "time": times,
                                 "RoadTemperature": [1.0, 2.0, 12.0]}]))
    t0 = utc("2019-12-02 00:00")
    sim = np.array([t0, t0 + 1800, t0 + 3 * H, t0 + 6 * H])
    got = tsrc.RoadSurfSource(str(path), sim).stations()
    same(got, jsrc.RoadSurfSource(str(path), sim).stations())
    v = got[0].values["tsurf_obs"]
    np.testing.assert_allclose(v[[0, 1, 3]], [1.0, 1.5, 12.0])
    assert v[2] == MISSING


def test_json_source_overlay(tmp_path):
    t0 = utc("2019-12-02 00:00")
    hours = [t0 + H * k for k in range(4)]
    fc, ob = tmp_path / "fc.json", tmp_path / "obs.json"
    _make_station_json(fc, 7, 60.0, 25.0, hours,
                       [[1.0, 2.0, 3.0, 4.0], [80, 80, 80, 80]],
                       ["Temperature 2m", "Humidity"])
    _make_station_json(ob, 7, 60.0, 25.0, hours[:2], [[-5.0, -4.0]],
                       ["Temperature 2m"])
    sim_t = np.arange(t0, t0 + 3 * H + 1, 1800, dtype=np.int64)
    merged = []
    for src in (tsrc, jsrc):
        h = src.DataHandler([src.JsonSource(str(fc), sim_t),
                             src.JsonSource(str(ob), sim_t,
                                            is_observation=True)])
        merged.append(h.merged(len(sim_t)))
    (raw, obs_tair), want = merged
    same(raw, want[0])
    same(obs_tair, want[1])
    assert raw.tair[0, 0] == -5.0 and raw.tair[0, 2] == -4.0
    assert raw.tair[0, 4] == 3.0
    assert obs_tair[0, 0] == -5.0 and obs_tair[0, 4] < -9000
    # the Tdew <-> RH completion filled the dew point from RH
    assert np.all(raw.tdew[0, :2] > -100.0)


def test_skyview_files(tmp_path):
    sv, hz = tmp_path / "sv.txt", tmp_path / "hz.txt"
    sv.write_text("100 p100 60.0 25.0 0.850\n")
    hz.write_text("100 p100 60.0 25.0 " + " ".join(["5.0"] * 360) + "\n")
    svf, hor = tsky.sky_variables([100, 200], str(sv), str(hz))
    same((svf, hor), jsky.sky_variables([100, 200], str(sv), str(hz)))
    assert svf[0] == 0.85 and svf[1] == 1.0
    assert hor[0, 17] == 5.0 and hor[1, 17] == 0.0
    same(tsky.sky_variables([1, 2]), jsky.sky_variables([1, 2]))


ASCII_ROWS = ("19 12 02 00  -3.5  85.0  4.0  0.0  3  0.0  290.0  -4.2\n"
              "19 12 02 01  -3.0  86.0  4.2  0.5  3  0.0  291.0  -3.9\n")


@pytest.mark.parametrize("native_on", [True, False],
                         ids=["native", "python"])
def test_ascii_source(tmp_path, monkeypatch, native_on):
    """tests/test_io.py:260, through the native parser and the Python
    fallback of each package."""
    if native_on and LIB is None:
        pytest.skip("native library build unavailable")
    if not native_on:
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "load",
                                lambda build_if_missing=False: None)
    p = tmp_path / "obs.txt"
    p.write_text("# header\n" + ASCII_ROWS + "garbage line\n")
    t0 = utc("2019-12-02 00:00")
    sim_t = np.arange(t0, t0 + 3601, 1800, dtype=np.int64)
    src = tsrc.AsciiSource(str(p), sim_t, point_id=5, lat=60.0, lon=25.0)
    same(src.stations(), jsrc.AsciiSource(str(p), sim_t, point_id=5,
                                          lat=60.0, lon=25.0).stations())
    st = src.stations()[0]
    np.testing.assert_allclose(st.values["tair"], [-3.5, -3.25, -3.0])
    np.testing.assert_allclose(st.values["tsurf_obs"], [-4.2, -4.05, -3.9])
    assert src.is_observation


def test_read_json_tolerant_and_parse_times(tmp_path):
    p = tmp_path / "c.json"
    p.write_text('// head\n{"a": "x // not a comment", // tail\n'
                 ' "b": [1, 2], "c": "say \\"//\\" ok"}\n')
    same(tsrc.read_json_tolerant(str(p)), jsrc.read_json_tolerant(str(p)))
    assert tsrc.read_json_tolerant(str(p))["a"] == "x // not a comment"
    stamps = ["2019-12-02 00:00", " 2019-12-02 01:30 ", "2020-02-29 23:59"]
    same(tsrc.parse_times(stamps), jsrc.parse_times(stamps))
    same(tsrc.parse_times([]), jsrc.parse_times([]))
    with pytest.raises(ValueError):
        tsrc.parse_times(["2019-12-02"])


def test_create_source_types(tmp_path):
    sim = np.arange(0, 3600, 600, dtype=np.int64)
    with pytest.raises(ValueError, match="Unknown input type"):
        tsrc.create_source({"type": "nope", "path": "x"}, sim)
    p = tmp_path / "fc.npz"
    _write_grid_npz(p, 0)
    src = tsrc.create_source({"type": "file", "path": str(p),
                              "source": "observations"}, sim)
    assert isinstance(src, tgs.GridSource) and src.is_observation
    assert src.stations() == []


# ---------------------------------------------------------------------------
# the example generators' inputs through the DataHandler and read_input
# ---------------------------------------------------------------------------

def _example1_handler(tmp_path, src, stations=3):
    gen = load_script(os.path.join(EXAMPLES, "example1", "make_data.py"),
                      "ex1_make_data")
    gen.main(["--stations", str(stations), "--analysis", "3", "--forecast",
              "2", "--outdir", str(tmp_path)])
    cfg = src.read_json_tolerant(
        os.path.join(EXAMPLES, "example1", "example_config.json"))
    for s in cfg["input"]:
        s["path"] = str(tmp_path / os.path.basename(s["path"]))
    t0 = utc("2019-12-01 21:00")
    sim = t0 + 60 * np.arange(5 * 60 + 1)
    return cfg, sim, src.DataHandler.from_config(cfg, sim)


@pytest.mark.parametrize("relax,coupling", [(1, 1), (0, 1), (1, 0)])
def test_example1_handler_and_read_input(tmp_path, relax, coupling):
    """example1's station JSON through both packages: the merged [P, T]
    forcing, the observation tair, the station locations, and
    derive_point_params (relaxation anchors, coupling window, obs
    blanking) with the sky-view files."""
    cfg, sim, th = _example1_handler(tmp_path, tsrc)
    _, _, jh = _example1_handler(tmp_path, jsrc)
    assert th.point_ids() == jh.point_ids() == [1001, 1002, 1003]
    assert th.locations() == jh.locations()
    (raw, obs), (jraw, jobs) = th.merged(len(sim)), jh.merged(len(sim))
    same(raw, jraw)
    same(obs, jobs)
    svf, hor = tsky.sky_variables(th.point_ids(),
                                  str(tmp_path / "skyview.txt"),
                                  str(tmp_path / "horizons.txt"))
    assert (svf < 1.0).sum() == 2
    settings = dict(sim_len=len(sim), dt=60.0, use_relaxation=bool(relax),
                    use_coupling=bool(coupling), coupling_minutes=60)
    tset = interop.settings(JSettings(**settings))
    pts, blanked = tdriver.derive_point_params(
        raw, tset, obs_tair=obs, lat=[1.0, 2.0, 3.0], sky_view=svf,
        horizons=hor)
    jpts, jblanked = jdriver.derive_point_params(
        jraw, JSettings(**settings), obs_tair=jobs, lat=[1.0, 2.0, 3.0],
        sky_view=svf, horizons=hor)
    same(tuple(pts), tuple(jpts))
    same(blanked, jblanked)
    if coupling:
        assert (np.asarray(pts.coupling_end) >= 1).all()
    same(tdriver.latest_obs_index(obs), jdriver.latest_obs_index(jobs))
    i0 = np.array([-1, 0, 30, 200, 299])
    obs_v = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    same(tdriver.coupling_window_from_last(i0, obs_v, tset),
         jdriver.coupling_window_from_last(i0, obs_v, JSettings(**settings)))


def test_example2_handler_at_points(tmp_path):
    """example2's grid + ASCII station inputs, queried at points through
    both packages (DataManager::GetWeather semantics): grid extraction,
    time interpolation and the station radius overlay."""
    gen = load_script(os.path.join(EXAMPLES, "example2", "make_data.py"),
                      "ex2_make_data")
    gen.main(["--analysis", "2", "--forecast", "2", "--ny", "6", "--nx", "8",
              "--outdir", str(tmp_path)])
    cfg = jsrc.read_json_tolerant(
        os.path.join(EXAMPLES, "example2", "grid_config.json"))
    cfg["input"][0]["path"] = str(tmp_path / "forecast_grid.npz")
    cfg["input"][1]["path"] = str(tmp_path / "road_station.txt")
    sim = utc("2019-12-01 22:00") + 60 * np.arange(4 * 60 + 1)
    rng = np.random.default_rng(2)
    plat, plon = rng.uniform(59.7, 61.1, 40), rng.uniform(23.9, 26.6, 40)
    got = tsrc.DataHandler.from_config(cfg, sim)
    want = jsrc.DataHandler.from_config(cfg, sim)
    assert got.has_grid_source() and not got.point_ids()
    for radius in (20.0, 80.0):
        same(got.merged_at_points(plat, plon, len(sim), radius),
             want.merged_at_points(plat, plon, len(sim), radius))


# ---------------------------------------------------------------------------
# points (tests/test_points.py:20-63)
# ---------------------------------------------------------------------------

def test_haversine():
    d = tpoints.haversine_km(60.17, 24.94, 61.50, 23.79)
    assert 150 < float(d) < 175
    rng = np.random.default_rng(1)
    a = rng.uniform(-80, 80, (4, 50))
    same(tpoints.haversine_km(*a), jpoints.haversine_km(*a))


POINT_CONFIGS = [
    ("stations", {}),
    ("coordinate", {"points": {"latlon": [60.0, 25.0]}}),
    ("coordinates", {"points": {"coordinates": [[60, 25], [61, 26]]}}),
    ("grid", {"points": {"grid": {"bbox": [60, 20, 62, 24], "ny": 3,
                                  "nx": 5}}}),
]


@pytest.mark.parametrize("case", POINT_CONFIGS,
                         ids=[c[0] for c in POINT_CONFIGS])
def test_parse_points_modes(case):
    mode, cfg = case
    got = tpoints.parse_points_full(cfg)
    want = jpoints.parse_points_full(cfg)
    assert got.mode == want.mode == mode
    for name in ("lats", "lons", "grid_lats", "grid_lons", "keep"):
        same(getattr(got, name), getattr(want, name), name)
    same(tpoints.parse_points(cfg), jpoints.parse_points(cfg))
    if mode == "grid":
        assert len(got.lats) == 15
        assert got.lats.min() == 60 and got.lats.max() == 62
    with pytest.raises(ValueError, match="Unrecognized"):
        tpoints.parse_points_full({"points": {"nope": 1}})


def test_ascii_mask(tmp_path):
    p = tmp_path / "mask.txt"
    p.write_text("10101\n01010\n11111\n")
    m = tpoints.read_ascii_mask(str(p), 3, 5, "1")
    same(m, jpoints.read_ascii_mask(str(p), 3, 5, "1"))
    assert m.sum() == 3 + 2 + 5
    cfg = {"points": {"grid": {"bbox": [60, 20, 62, 24], "ny": 3, "nx": 5,
                               "mask": {"path": str(p), "include": "1"}}}}
    mode, la, lo = tpoints.parse_points(cfg)
    same((mode, la, lo), jpoints.parse_points(cfg))
    assert len(la) == 10


@pytest.mark.parametrize("n_stations", [3, 40], ids=["brute", "kdtree"])
def test_nearest_station_mapping(n_stations):
    """tests/test_points.py:50-63, and a station count that takes the
    KD-tree (>= 8 stations) against the JAX package's."""
    raw, cal = synthetic_raw(n_stations, 10, seed=1)
    raw = type(raw)(*(np.asarray(x) for x in raw))
    if n_stations == 3:
        st_lats = np.array([60.0, 61.0, 62.0])
        st_lons = np.array([25.0, 25.0, 25.0])
        lats = np.array([61.01, 60.99, 70.0])
        lons = np.array([25.0, 25.0, 25.0])
    else:
        rng = np.random.default_rng(4)
        st_lats, st_lons = rng.uniform(59, 66, 40), rng.uniform(20, 30, 40)
        lats, lons = rng.uniform(58, 67, 500), rng.uniform(19, 31, 500)
    mapped, idx = tpoints.nearest_station_forcing(
        raw, st_lats, st_lons, lats, lons, max_radius_km=30.0)
    jmapped, jidx = jpoints.nearest_station_forcing(
        raw, st_lats, st_lons, lats, lons, max_radius_km=30.0)
    same(idx, jidx)
    same(tuple(mapped), tuple(jmapped))
    same(tpoints.nearest_station_index(st_lats, st_lons, lats, lons, 30.0),
         jpoints.nearest_station_index(st_lats, st_lons, lats, lons, 30.0))
    if n_stations == 3:
        assert list(idx) == [1, 1, -1]
        np.testing.assert_array_equal(mapped.tair[0], raw.tair[1])
        assert np.all(mapped.tair[2] < -9000)
    else:
        assert (idx >= 0).any() and (idx < 0).any()


# ---------------------------------------------------------------------------
# the native library (tests/test_native.py), port binding vs numpy and vs
# the JAX package's binding
# ---------------------------------------------------------------------------

def test_native_binding_contract(monkeypatch):
    """The JAX binding's behaviour (native.py:29-60): a missing library
    gives None without a build, and a failed build latches with one retry
    for build_if_missing."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", False)
    monkeypatch.setattr(tnative, "_retry_left", 1)
    monkeypatch.setattr(tnative, "_LIB_PATH", "/nonexistent/lib.so")
    monkeypatch.setattr(tnative, "_NATIVE_DIR", "/nonexistent")
    assert tnative.load() is None                   # unbuilt: no build tried
    assert tnative.load(build_if_missing=True) is None    # make fails
    assert tnative._load_failed and tnative._retry_left == 1
    assert tnative.load(build_if_missing=True) is None    # the one retry
    assert tnative._retry_left == 0
    assert tnative.load(build_if_missing=True) is None    # latched
    assert tnative._retry_left == 0


@needs_lib
def test_native_interpolate_matches_numpy():
    rng = np.random.default_rng(0)
    nst = 37
    sim_times = np.arange(0, 86400, 300, dtype=np.int64)
    offsets, raws, va, vb, vp = [0], [], [], [], []
    for s in range(nst):
        n = int(rng.integers(5, 50))
        t = np.sort(rng.choice(np.arange(0, 90000, 600), size=n,
                               replace=False)).astype(np.int64)
        a = rng.normal(0, 10, n)
        a[rng.random(n) < 0.15] = MISSING
        raws.append(t)
        va.append(a)
        vb.append(rng.normal(0, 10, n))
        vp.append(rng.integers(0, 7, n).astype(np.float64))
        offsets.append(offsets[-1] + n)
    args = (np.asarray(offsets, np.int64), np.concatenate(raws), sim_times,
            np.stack([np.concatenate(va), np.concatenate(vb),
                      np.concatenate(vp)]))
    kw = dict(miss_thresh=np.array([-100.0, -100.0, -100.0]),
              nearest_next=np.array([0, 0, 1], np.int32), nthreads=4)
    out = tnative.interpolate_columns(*args, **kw)
    same(out, jnative.interpolate_columns(*args, **kw))
    for s in range(nst):
        ref = tinterp.interpolate_series(
            raws[s], sim_times, {"a": va[s], "b": vb[s],
                                 "prec_phase": vp[s]})
        for k, name in enumerate(("a", "b", "prec_phase")):
            np.testing.assert_allclose(out[s, k], ref[name], rtol=1e-12,
                                       err_msg=f"station {s} {name}")


@needs_lib
def test_native_parse_ascii_obs():
    text = (b"# comment line\n" + ASCII_ROWS.encode()
            + b"2019 12 02 02  -2.5  87.0  4.4  1.0  2  10.0  292.0  -3.6\n"
            + b"not a data line\n")
    epochs, vals = tnative.parse_ascii_obs(text)
    same((epochs, vals), jnative.parse_ascii_obs(text))
    import calendar
    assert len(epochs) == 3
    assert epochs[0] == calendar.timegm((2019, 12, 2, 0, 0, 0))
    np.testing.assert_allclose(vals[0], [-3.5, -3.0, -2.5])
    np.testing.assert_allclose(vals[7], [-4.2, -3.9, -3.6])


@needs_lib
def test_batch_interpolate_stations_matches_fallback(monkeypatch):
    rng = np.random.default_rng(3)
    sim_times = np.arange(0, 7200, 300, dtype=np.int64)
    series = []
    for s in range(9):
        if s == 4:
            series.append((np.zeros(0, np.int64), {}))
            continue
        n = int(rng.integers(3, 12))
        t = np.sort(rng.choice(np.arange(0, 9000, 60), size=n,
                               replace=False)).astype(np.int64)
        vals = {"tair": rng.normal(0, 5, n), "rhz": rng.uniform(40, 100, n),
                "prec_phase": rng.integers(0, 7, n).astype(np.float64)}
        if s % 2:
            vals["lw_net"] = rng.normal(-500, 100, n)
        vals["tair"][rng.random(n) < 0.3] = MISSING
        series.append((t, vals))
    got = tsrc.batch_interpolate_stations(series, sim_times)
    same(got, jsrc.batch_interpolate_stations(series, sim_times))
    with monkeypatch.context() as m:
        for mod in (tnative, jnative):
            m.setattr(mod, "load", lambda build_if_missing=False: None)
        ref = tsrc.batch_interpolate_stations(series, sim_times)
        same(ref, jsrc.batch_interpolate_stations(series, sim_times))
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        assert set(g) == set(tsrc.VAR_NAMES)
        for k in tsrc.VAR_NAMES:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-12, err_msg=k)


@needs_lib
@pytest.mark.parametrize("shape", [(13, 17), (1, 9), (9, 1), (1, 1)],
                         ids=["13x17", "1x9", "9x1", "1x1"])
def test_native_grid_extract_matches_numpy(monkeypatch, shape):
    """rs_grid_at_points (bilinear and nearest corner, ascending and
    descending latitudes, missing values, degenerate grids) against each
    package's numpy path, and the port's extraction against the JAX
    package's with the library on and off, bit for bit."""
    rng = np.random.default_rng(11)
    ny, nx = shape
    R, P = 5, 301
    for descending in ((False, True) if ny > 1 else (False,)):
        lats = np.linspace(60.0, 62.0, ny)
        if descending:
            lats = lats[::-1].copy()
        lons = np.linspace(24.0, 27.0, nx)
        field = rng.normal(-3.0, 4.0, (R, ny, nx))
        if ny > 1 and nx > 1:
            field[rng.random((R, ny, nx)) < 0.2] = MISSING
            field[1, 3, 4] = np.nan
        plat = (rng.uniform(59.5, 62.5, P) if ny > 1
                else np.full(P, 60.0))
        plon = (rng.uniform(23.5, 27.5, P) if nx > 1
                else np.full(P, 24.0))
        for fn, mode in (("bilinear_at_points", 0),
                         ("nearest_corner_at_points", 1)):
            nat = tgs._native_extract(field, lats, lons, plat, plon, mode)
            same(nat, jgs._native_extract(field, lats, lons, plat, plon,
                                          mode))
            same(getattr(tgs, fn)(field, lats, lons, plat, plon), nat)
            with monkeypatch.context() as m:
                for mod in (tnative, jnative):
                    m.setattr(mod, "load",
                              lambda build_if_missing=False: None)
                want = getattr(tgs, fn)(field, lats, lons, plat, plon)
                same(want, getattr(jgs, fn)(field, lats, lons, plat, plon))
            np.testing.assert_array_equal(nat <= -9000.0, want <= -9000.0)
            np.testing.assert_allclose(nat, want, rtol=1e-13, atol=1e-11)


# ---------------------------------------------------------------------------
# SmartMet (tests/test_smartmet.py) against a local server
# ---------------------------------------------------------------------------

T0 = utc("2019-12-02 00:00")


def _smartmet_rows():
    import time as timelib
    rows = []
    for sid, lat in ((101, 60.1), (102, 61.2)):
        for k in range(4):
            rows.append({
                "fmisid": sid, "latitude": lat, "longitude": 24.5,
                "time": timelib.strftime("%Y%m%dT%H%M%S",
                                         timelib.gmtime(T0 + H * k)),
                "t2m": -2.0 + k + (sid - 101), "rh": 85.0,
                "ws_10min": 3.5, "troad": -3.0 + 0.5 * k,
                "dp": None if k == 1 else -4.0})
    return rows


class _Handler(http.server.BaseHTTPRequestHandler):
    paths = []

    def do_GET(self):
        _Handler.paths.append(self.path)
        body = json.dumps(_smartmet_rows()).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def server():
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{httpd.server_port}"
    httpd.shutdown()


def test_smartmet_time_format():
    for mod in (tsm, jsm):
        assert mod.format_smartmet_time(T0) == "20191202T0000"
        assert mod.format_smartmet_time(T0, -10) == "20191201T2350"
        assert mod.parse_iso_time("20191202T010000") == T0 + H
        assert mod.parse_iso_time("2019-12-02T01:00:00") == T0 + H
    with pytest.raises(ValueError, match="Unparseable"):
        tsm.parse_iso_time("yesterday")


@pytest.mark.parametrize("query", ["keyword", "fmisid", "lonlat"])
def test_smartmet_fetch_and_parse(server, query):
    sim_t = np.arange(T0, T0 + 3 * H + 1, 1800, dtype=np.int64)
    cfg = {"host": server, "plugin": "timeseries",
           "producer": "observations_fmi", "airtemperature": "t2m",
           "humidity": "rh", "windspeed": "ws_10min",
           "roadtemperature": "troad", "dewpoint": "dp",
           query: {"keyword": "roads", "fmisid": [101, 102],
                   "lonlat": [24.5, 60.1]}[query]}
    got = tsm.SmartMetSource(cfg, sim_t)
    want = jsm.SmartMetSource(cfg, sim_t)
    assert got.url == want.url
    same(got.stations(), want.stations())
    sts = got.stations()
    assert [s.point_id for s in sts] == [101, 102]
    np.testing.assert_allclose(sts[0].values["tair"][:3], [-2.0, -1.5, -1.0])
    np.testing.assert_allclose(sts[0].values["tsurf_obs"][0], -3.0)
    last = _Handler.paths[-1]
    assert "starttime=20191201T2350" in last
    assert {"keyword": "keyword=roads", "fmisid": "fmisid=101%2C102",
            "lonlat": "lonlat=24.5%2C60.1"}[query] in last
    # the factory's smartmet type, an empty answer
    src = tsrc.create_source(dict(cfg, type="smartmet"), sim_t)
    same(src.stations(), sts)
    assert tsm.SmartMetSource(cfg, sim_t,
                              fetcher=lambda url: "  ").stations() == []


# ---------------------------------------------------------------------------
# GridSource and masks (tests/test_gridsource.py:161-281)
# ---------------------------------------------------------------------------

def _both_grid_sources(cfg, sim):
    return tgs.GridSource(cfg, sim), jgs.GridSource(cfg, sim)


def test_gridsource_at_points(tmp_path):
    t0 = utc("2019-12-02 00:00")
    p = tmp_path / "fc.npz"
    _write_grid_npz(p, t0)
    got, want = _both_grid_sources({"path": str(p)}, t0 + 1800 * np.arange(5))
    plat, plon = np.array([60.5, 60.0]), np.array([24.75, 24.0])
    vals = got.at_points(plat, plon)
    same(vals, want.at_points(plat, plon))
    np.testing.assert_allclose(vals["tair"][0], -2.5 + 0.25 * np.arange(5),
                               atol=1e-9)
    assert np.all(vals["prec_phase"] == 3.0)
    # the params subset
    sub, jsub = _both_grid_sources({"path": str(p), "params": ["tair"]},
                                   t0 + 1800 * np.arange(5))
    assert set(sub.fields) == {"tair"}
    same(sub.at_points(plat, plon), jsub.at_points(plat, plon))


def test_gridsource_rh_clamp_and_prec_sanity(tmp_path):
    t0 = utc("2019-12-02 00:00")
    p = tmp_path / "fc.npz"
    times = t0 + H * np.arange(2)
    np.savez(p, times=times, lats=np.array([60.0, 61.0]),
             lons=np.array([24.0, 25.0]), rhz=np.full((2, 2, 2), 104.0),
             prec=np.full((2, 2, 2), 400.0))
    got, want = _both_grid_sources({"path": str(p)}, times)
    vals = got.at_points(np.array([60.5]), np.array([24.5]))
    same(vals, want.at_points(np.array([60.5]), np.array([24.5])))
    assert np.all(vals["rhz"] == 100.0)
    assert np.all(vals["prec"] == MISSING)


def test_gridsource_directory_merge_later_wins(tmp_path):
    t0 = utc("2019-12-02 00:00")
    d = tmp_path / "grids"
    d.mkdir()
    _write_grid_npz(d / "a_run0.npz", t0, nhours=4, tair_base=-3.0)
    _write_grid_npz(d / "b_run1.npz", t0 + 2 * H, nhours=4, tair_base=+5.0)
    got, want = _both_grid_sources({"path": str(d)}, t0 + H * np.arange(6))
    same((got.times, got.lats, got.lons, got.fields),
         (want.times, want.lats, want.lons, want.fields))
    vals = got.at_points(np.array([60.0]), np.array([24.0]))
    np.testing.assert_allclose(vals["tair"][0],
                               [-3.0, -2.5, 5.0, 5.5, 6.0, 6.5], atol=1e-9)
    (d / "c.npz").write_bytes((d / "a_run0.npz").read_bytes())
    np.savez(d / "d_other.npz", times=np.array([t0]), lats=np.arange(3.0),
             lons=np.arange(4.0), tair=np.zeros((1, 3, 4)))
    with pytest.raises(ValueError, match="differing grids"):
        tgs.GridSource({"path": str(d)}, t0 + H * np.arange(6))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tgs.GridSource({"path": str(empty)}, t0 + H * np.arange(6))


def test_gridsource_latest_valid_time(tmp_path):
    t0 = utc("2019-12-02 00:00")
    p = tmp_path / "fc.npz"
    lats, lons, times = _write_grid_npz(p, t0, nhours=4)
    z = dict(np.load(p))
    z["tair"][-1] = MISSING
    z["vz"][:] = np.nan
    np.savez(p, **z)
    got, want = _both_grid_sources({"path": str(p)}, times)
    for name in ("tair", "rhz", "vz", "nope"):
        assert got.latest_valid_time(name) == want.latest_valid_time(name)
    assert got.latest_valid_time("tair") == int(times[-2])
    assert got.latest_valid_time("rhz") == int(times[-1])
    assert got.latest_valid_time("vz") is None


MASK_VARS = {"elev": np.array([10.0, 200.0, MISSING]),
             "lc": np.array([1.0, 2.0, 1.0])}
MASK_FORMULAS = [
    ("elev < 100 and lc == 1", [True, False, True]),
    ("elev < 100 and lc == 1 and not missing(elev)", [True, False, False]),
    ("missing(elev) or elev > 150", [False, True, True]),
    ("elev / 2 + 5 >= 10 && !missing(elev)", [True, True, False]),
    ("elev % 3 != 1 || 0 < lc <= 1", [True, True, True]),
    ("-elev < -PI * 3", [True, True, False]),
]


@pytest.mark.parametrize("formula,want", MASK_FORMULAS,
                         ids=[f[0] for f in MASK_FORMULAS])
def test_eval_mask_expression_ops(formula, want):
    got = tmasks.eval_mask_expression(formula, MASK_VARS)
    same(got, jmasks.eval_mask_expression(formula, MASK_VARS))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("formula,match", [
    ("y > 0", "Unrecognized variable"), ("x + 1", "must be boolean"),
    ("exp(x) > 0", "Unrecognized function"), ("x ** 2 > 0", "Unsupported"),
    ("missing(x, x)", "exactly one"), ("x > 'a'", "Unsupported constant"),
    ("x.y > 0", "Unsupported"), ("x[0] > 0", "Unsupported")])
def test_eval_mask_expression_errors(formula, match):
    for mod in (tmasks, jmasks):
        with pytest.raises(ValueError, match=match):
            mod.eval_mask_expression(formula, {"x": np.array([1.0])})


def test_expression_mask_grid_points(tmp_path, capsys):
    p = tmp_path / "static.npz"
    np.savez(p, lats=np.array([60.0, 61.0]), lons=np.array([24.0, 25.0]),
             elevation=np.array([[0.0, 100.0], [200.0, 300.0]]),
             landcover=np.ones((1, 2, 2)), times=np.array([0]))
    plat, plon = np.array([60.0, 60.0, 61.0]), np.array([24.0, 25.0, 25.0])
    keep = tmasks.expression_mask("elevation <= 100", str(p), plat, plon,
                                  verbose=True)
    same(keep, jmasks.expression_mask("elevation <= 100", str(p), plat,
                                      plon))
    np.testing.assert_array_equal(keep, [True, True, False])
    assert "enabled  2 points" in capsys.readouterr().out
    cfg = {"points": {"grid": {"bbox": [60.0, 24.0, 61.0, 25.0],
                               "ny": 2, "nx": 2},
                      "mask": {"path": str(p),
                               "enable": "elevation < 150 && landcover"
                                         " == 1"}}}
    ps, jps = tpoints.parse_points_full(cfg), jpoints.parse_points_full(cfg)
    assert ps.mode == "grid" and len(ps.lats) == 2 and ps.keep.sum() == 2
    for name in ("lats", "lons", "grid_lats", "grid_lons", "keep"):
        same(getattr(ps, name), getattr(jps, name), name)
