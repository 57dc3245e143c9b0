"""BENCHMARK.json and every file it names: they parse, they are found by
name, and they keep to the contract's names, units and limits."""
import json
import os
import re

import pytest

from benchmark import check, manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
E2E = {m["name"] for m in MAN["end_to_end"]}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert len(MAN["command"]) <= 32
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_full_check_fits_its_budget():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to
    compile and 1,200 s spare fit 43,200 s with the full 24 cells."""
    runs = 2 + 14 * 24
    assert (runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = manifest.config(entry["name"])
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    # the shapes upstream ships: 15 ground layers, 30 s steps, hourly rows
    assert cfg["model"]["DTSecs"] == 30
    assert cfg["model"].get("NLayers", 15) == 15
    assert cfg["output"]["step"] == 60
    assert "assumed" in cfg and "generator" in cfg and "now" in cfg
    assert os.path.exists(os.path.join(
        manifest.BENCH_DIR, "generators", f"{cfg['generator']['name']}.py"))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert TEXT.match(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    traffic = manifest.traffic(cell["traffic"])
    assert {"overrides", "warm_start", "check"} <= set(traffic)
    limits = check.load_limits(manifest.BENCH_DIR, cell["name"])
    assert set(limits) == set(check.NUMBERS)
    assert limits["failed_points"] == 0
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in manifest.metrics_of(cell["name"], "end_to_end",
                                                   MAN)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(cell["name"], "per_layer", MAN)


def test_names_unique_and_used():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in MAN["workloads"]}) == len(MAN["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert TEXT.match(m["layer"])
    # the metric it moves is an end-to-end metric every one of its cells
    # reports
    assert m["moves"] in E2E
    for w in m["workloads"]:
        manifest.workload(w, MAN)
        reported = {e["name"] for e in manifest.metrics_of(w, "end_to_end",
                                                           MAN)}
        assert m["moves"] in reported
    # found by name, a reader that reads nothing returns None
    read = manifest.metric_reader(m["name"])
    assert callable(read)
    if "_roofline" in m["name"]:
        assert m["unit"] == "%"


def test_per_layer_reader_reads_nothing_without_a_trace():
    from benchmark.run import Readings
    from roadsurf_tpu_torch.observability import RunMetrics
    r = Readings({}, RunMetrics(), [], None, {})
    for m in MAN["per_layer"]:
        assert manifest.metric_reader(m["name"])(r) is None


def test_layers_named_alike():
    """Metrics of one layer give the same ``layer``, letter for letter."""
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_files_under_paths_are_named_from_name_characters():
    for root, _, files in os.walk(manifest.BENCH_DIR):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), manifest.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_json_files_parse():
    for sub in ("configs", "traffic", "checks"):
        d = os.path.join(manifest.BENCH_DIR, sub)
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                json.load(fh)


def _perf_md_bounds() -> dict:
    """``{metric: bound}`` from the table of PERF.md's section 2."""
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        text = f.read()
    sec = text.split("\n## 2.", 1)[1].split("\n## 3.", 1)[0]
    rows = re.findall(r"^\| `([^`]+)` \| [^|]+ \| (?:lower|higher) \| "
                      r"([0-9.]+) \|", sec, re.M)
    return {name: float(b) for name, b in rows}


def test_bounds_are_those_perf_md_derives():
    """Each end-to-end bound in BENCHMARK.json is the one PERF.md section
    2 states and derives, and PERF.md states no other."""
    assert _perf_md_bounds() == {m["name"]: m["bound"]
                                 for m in MAN["end_to_end"]}


def _station_configs():
    return [c["name"] for c in MAN["configs"]
            if manifest.config(c["name"])["generator"]["name"] == "example1"]


@pytest.mark.parametrize("name", _station_configs())
def test_every_station_feeds_points_and_every_point_has_one(name):
    """At the configuration's own sizes: the generator's stations lie in
    the raster's box, every raster point has a station within the
    radius, and every station is the nearest of some points."""
    import numpy as np

    from benchmark.generators import example1
    from benchmark.reference.io.points import (nearest_station_index,
                                               parse_points_full)
    cfg = manifest.config(name)
    args = cfg["generator"]["args"]
    bbox = tuple(float(x) for x in args["bbox"].split(","))
    assert list(bbox) == cfg["points"]["grid"]["bbox"]
    n = int(args["stations"])
    rng = np.random.default_rng(2 ** 31 + 77)
    pos = np.array([example1.position(k, n, rng, bbox)
                    for k in range(n)])
    assert ((pos[:, 0] > bbox[0]) & (pos[:, 0] < bbox[2])
            & (pos[:, 1] > bbox[1]) & (pos[:, 1] < bbox[3])).all()
    pset = parse_points_full(cfg)
    idx = nearest_station_index(pos[:, 0], pos[:, 1], pset.lats, pset.lons,
                                cfg["points"]["max_radius_km"])
    assert (idx >= 0).all()
    assert len(np.unique(idx)) == n


def test_roofline_readers_count_from_the_shapes():
    """The roofline readers build their work from the cycle's shapes,
    with the deployment's own grid channels: more channels, more work,
    a larger share of the same time."""
    from benchmark import roofline
    from benchmark.run import Readings
    from roadsurf_tpu_torch.observability import RunMetrics

    class Trace:
        def seconds(self, pattern):
            return 1.0, 10

    base = dict(points=1 << 20, steps=4321, window_steps=0, decay_steps=0,
                chunks=34, out_rows=37, layers=15, grid_fields=[],
                grid_channels=0, relax=False, bl_iters=5.3)
    k2 = manifest.metric_reader("k2_roofline")
    k3 = manifest.metric_reader("k3_fused_roofline")
    share = {}
    for ch in (6, 8):
        s = dict(base, grid_fields=[f"f{i}" for i in range(ch)],
                 grid_channels=ch, relax=True)
        r = Readings({}, RunMetrics(), [1.0], Trace(), s)
        share[ch] = k3(r)
        assert share[ch] == pytest.approx(
            100.0 * roofline.k3_fused_seconds(roofline.work_of(s)))
    assert 0 < share[6] < share[8] < 100
    r = Readings({}, RunMetrics(), [1.0, 1.0], Trace(), base)
    assert k2(r) == pytest.approx(
        200.0 * roofline.k2_seconds(roofline.work_of(base)))
