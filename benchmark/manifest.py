"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, found as
``configs/<config>.json``, and a traffic mix, ``traffic/<traffic>.json``;
its comparison's limits are ``checks/<workload>.json``; a per-layer metric
is read by ``metrics/<name>.py``.  Adding a cell, a configuration or a
metric adds files and entries and edits none.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def workload(name: str, man: dict = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; workloads: "
                   f"{[w['name'] for w in man['workloads']]}")


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def metric_reader(name: str):
    """The ``read(readings)`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(workload_name: str, kind: str, man: dict = None) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that cell reports: those
    without a ``workloads`` list, and those that list it."""
    man = man or manifest()
    return [m for m in man[kind]
            if workload_name in m.get("workloads", [workload_name])]


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over`` merged in, key by key into nested objects."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


#: the keys of a configuration file that are not the runner's
NOT_RUNNER = ("generator", "now", "assumed")


def runner_config(cfg: dict, traffic_doc: dict, data_dir: str) -> dict:
    """The runner config a cell runs: the configuration's runner keys with
    the traffic's ``overrides`` merged in, each input path into
    ``data_dir``."""
    run = merge({k: v for k, v in cfg.items() if k not in NOT_RUNNER},
                traffic_doc.get("overrides", {}))
    for src in run["input"]:
        src["path"] = os.path.join(data_dir, os.path.basename(src["path"]))
    return run
