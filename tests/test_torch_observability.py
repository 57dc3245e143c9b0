"""The port's spans and counters (``observability.RunMetrics``), their
profiler ranges, ``idle_by_span`` and the engine entry's spans and
counters on small CPU runs.

A span books its seconds, its calls and its self time; while a torch
profiler records it is also the range ``roadsurf::<name>`` with its ids as
keyword inputs, and without one it opens none.  ``idle_by_span`` on
made-up intervals.  ``run_production`` on a grid (K3 fused's plain
version) and ``run_production_coupled`` on stations (K2's and K5's plain
versions): every ``cycle_setup`` part, the drain's bytes, K5's point-steps,
lane-steps and rewinds against the window's own per-point counts, and the
outputs and final state bit for bit with the profiler on and off.  The
CLI's kernel engine under ``--profile`` with verbose on: the runner's
parts are ranges too, and one stderr line puts the idle time down to them.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from roadsurf_tpu_torch import interop, observability
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch import production as tprod
from roadsurf_tpu_torch.observability import (RunMetrics, idle_by_span,
                                              idle_by_span_of, profile_trace)
from roadsurf_tpu_torch.ops import window_kernel as wk
from roadsurf_tpu_torch.state import State

import test_torch_production_coupled as tpc
import test_torch_production_grid as tp_grid

torch.set_num_threads(1)

NAMES = ("tsurf", "wat", "snow", "ice", "ice2", "dep")


class _Clock:
    """A fake ``perf_counter`` that moves on only when told."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_spans_nest_with_seconds_calls_and_self_time(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(observability.time, "perf_counter", clock)
    m = RunMetrics()
    with m.phase("outer"):
        clock.t = 1.0
        with m.phase("inner", "inner_s"):
            clock.t = 3.0
            with m.phase("leaf"):
                clock.t = 3.5
        clock.t = 4.0
        with m.phase("inner", "inner_s"):
            clock.t = 5.0
        clock.t = 10.0
    assert m.phases == {"outer": 10.0, "inner": 3.5, "leaf": 0.5}
    assert m.calls == {"outer": 1, "inner": 2, "leaf": 1}
    assert m.self_s == {"outer": 6.5, "inner": 3.0, "leaf": 0.5}
    assert m.counters == {"inner_s": 3.5}
    # a span left by an exception still books its seconds
    with pytest.raises(RuntimeError):
        with m.phase("outer"):
            clock.t = 12.0
            raise RuntimeError
    assert m.phases["outer"] == 12.0 and m.calls["outer"] == 2


def test_spans_are_profiler_ranges_with_their_ids():
    m = RunMetrics()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for _ in range(2):
            with m.cycle():
                with m.phase("stream.issue", chunk=3):
                    torch.ones(4).sum()
    ranges = [e for e in prof.events() if e.name.startswith("roadsurf::")]
    cycles = [e for e in ranges if e.name == "roadsurf::cycle"]
    issues = [e for e in ranges if e.name == "roadsurf::stream.issue"]
    assert [e.kwinputs for e in cycles] == [{"cycle": 0}, {"cycle": 1}]
    assert [e.kwinputs for e in issues] == [{"chunk": 3}, {"chunk": 3}]
    for e in issues:
        assert e.cpu_parent.name == "roadsurf::cycle"
        assert any(c.name == "aten::sum" for c in e.cpu_children)
    assert m.calls == {"cycle": 2, "stream.issue": 2} and m.cycles == 2


def test_no_range_without_a_profiler(monkeypatch):
    opened = []

    class Spy:
        def __init__(self, *a):
            opened.append(a)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Spy)
    m = RunMetrics()
    with m.cycle(), m.phase("stream.issue", chunk=0):
        pass
    assert opened == [] and m.calls["stream.issue"] == 1


@pytest.mark.parametrize("device,spans,want", [
    # a gap inside nested ranges goes to the innermost
    ([(0, 1), (5, 6)], [("a", 0, 6), ("b", 2, 4)],
     {"a": 2.0, "b": 2.0}),
    # a gap across two ranges is split at their edge
    ([(0, 1), (5, 6)], [("a", 0, 3), ("b", 3, 6)],
     {"a": 2.0, "b": 2.0}),
    # a gap no range covers goes to (outside)
    ([(0, 1), (4, 5)], [("a", 0, 2)], {"a": 1.0, "(outside)": 2.0}),
    # overlapping device intervals are one busy stretch; equal starts take
    # the range that ends first
    ([(0, 2), (1, 3), (7, 8)], [("a", 3, 8), ("b", 3, 5)],
     {"b": 2.0, "a": 2.0}),
], ids=["nested", "split", "outside", "overlap"])
def test_idle_by_span(device, spans, want):
    assert idle_by_span(device, spans) == pytest.approx(want)


def test_profile_trace_summary_puts_idle_time_down_to_spans(tmp_path,
                                                           capsys):
    """On the CPU nothing runs on a device: every stretch is idle, the
    spans' and the stretch outside them."""
    m = RunMetrics()
    with profile_trace(str(tmp_path), summary=True) as prof:
        with m.phase("outer"):
            torch.ones(64).cumsum(0)
            with m.phase("inner"):
                torch.ones(64).cumsum(0)
    err = capsys.readouterr().err
    assert "device idle by span, s: " in err
    assert set(idle_by_span_of(prof)) == {"outer", "inner"}
    assert "outer" in err and "inner" in err
    assert list(tmp_path.glob("trace_*.json"))
    with profile_trace(None) as none:
        assert none is None


def test_idle_by_span_of_reads_the_ranges():
    m = RunMetrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.phase("a"):
            with m.phase("b"):
                torch.ones(16).sum()
    idle = idle_by_span_of(prof)
    assert set(idle) == {"a", "b"}
    assert sum(idle.values()) == pytest.approx(m.phases["a"], rel=0.5)


def _grid_run(metrics):
    _, exp, settings, cal, pts, state0 = tp_grid._setup("grid",
                                                        with_jax=False)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    res = tprod.run_production(tm, exp, pts, cal,
                               interop.state(state0, "cpu"),
                               devices=["cpu"], chunk_t=24, out_stride=5,
                               metrics=metrics)
    return res, len(pts.lat)


def _coupled_run(metrics):
    setup = tpc._coupled_setup()
    settings, raw_st, raw_pt, cal, pts, st_idx, ctx = setup
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    exp = tprod.StationExpander(raw_st, tpc._padded(st_idx), "cpu",
                                chunk_t=16, prep_ctx=tpc._port_ctx(ctx))
    res = tprod.run_production_coupled(
        tm, exp, pts, cal, tm.init(raw_pt, cal, dtype=torch.float32,
                                   pts=pts),
        chunk_t=16, out_stride=6, metrics=metrics)
    return res, len(st_idx)


RUNS = {"grid": _grid_run, "coupled": _coupled_run}
SETUP_PARTS = {"sky_route", "blocks", "place", "host_rows"}


@pytest.mark.parametrize("kind", ["grid", "coupled"])
def test_engine_entry_spans_and_drain_bytes(kind):
    m = RunMetrics()
    res, n_real = RUNS[kind](m)
    parts = {n.split(".", 1)[1] for n in m.phases
             if n.startswith("cycle_setup.")}
    # the kernels' library is built only where the run is on the card
    assert parts == SETUP_PARTS | ({"window_plan"} if kind == "coupled"
                                   else set())
    assert m.calls["cycle"] == 1 and m.cycles == 1
    for name in ("cycle_setup", "stream", "output"):
        assert m.calls[name] == 1, name
    # the spans inside the cycle leave it little self time
    assert m.self_s["cycle"] <= 0.1 * m.phases["cycle"]
    n = m.counters["stream_chunks"]
    assert m.calls["stream.issue"] == n
    assert m.phases["stream.issue"] == m.counters["stream_issue_s"]
    assert m.phases["stream.drain.wait"] == m.counters["stream_wait_s"]
    assert m.phases["stream.drain.rows"] == m.counters["stream_rows_s"]
    assert (m.counters["stream_rows_bytes"]
            == len(res.out_steps) * 6 * n_real * 4)
    if kind == "coupled":
        assert m.calls["phase_b.launch"] == m.calls["phase_b.sync"] == 1
        # phase B's drain is one more than the chunks
        assert m.calls["stream.drain.rows"] == n + 1


def test_window_counters_are_k5s_own_counts(monkeypatch):
    """The phase B counters against the per-point rewinds and steps the
    window wrote, and the lane-steps counted in numpy from them: each
    warp of 32 points of the launch as long as its slowest point."""
    outs = []
    window = wk.window

    def spy(*a, **k):
        outs.append(window(*a, **k))
        return outs[-1]

    monkeypatch.setattr(wk, "window", spy)
    m = RunMetrics()
    _coupled_run(m)
    assert len(outs) == 1
    steps = outs[0].steps.numpy().astype(np.int64)
    reruns = outs[0].reruns.numpy().astype(np.int64)
    c = m.counters
    assert c["coupling_window_point_steps"] == steps.sum() > 0
    assert c["coupling_reruns_total"] == reruns.sum() > 0
    assert c["coupling_window_lane_steps"] == 32 * steps.reshape(
        -1, 32).max(axis=1).sum()
    assert c["coupling_window_lane_steps"] >= c["coupling_window_point_steps"]
    # a second cycle adds to them
    _coupled_run(m)
    assert m.counters["coupling_window_point_steps"] == 2 * steps.sum()
    assert m.cycles == 2


@pytest.mark.parametrize("kind", ["grid", "coupled"])
def test_outputs_bit_for_bit_with_the_profiler_on(kind):
    want, _ = RUNS[kind](RunMetrics())
    m = RunMetrics()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        got, _ = RUNS[kind](m)
    issues = sorted((e for e in prof.events()
                     if e.name == "roadsurf::stream.issue"),
                    key=lambda e: e.time_range.start)
    assert [e.kwinputs for e in issues] == [
        {"cycle": 0, "chunk": k} for k in range(len(issues))]
    assert len(issues) == m.counters["stream_chunks"]
    assert np.array_equal(got.out_steps, want.out_steps)
    bits = lambda a: np.ascontiguousarray(a).view(np.int32)
    for name in NAMES:
        np.testing.assert_array_equal(bits(got.fields[name]),
                                      bits(want.fields[name]), err_msg=name)
    for name in State._fields:
        assert torch.equal(getattr(got.state, name),
                           getattr(want.state, name)), name


def test_cli_profile_names_the_runners_parts_and_prints_the_idle_line(
        tmp_path, capsys):
    """The CLI's kernel engine with ``--profile`` and verbose: the data
    plane's and the init's parts and the engine entry's spans are ranges
    of the written trace, and one stderr line puts the idle time down to
    them."""
    from roadsurf_tpu_torch import runner as trunner
    from test_torch_runner_grid import _write_grid_npz, utc
    fc = tmp_path / "fc.npz"
    _write_grid_npz(fc, utc("2019-12-02 00:00"), nhours=3)
    cfg = {"time": {"analysis": 1, "forecast": 1},
           "model": {"use_relaxation": 0, "DTSecs": 300.0},
           "points": {"coordinates": [[60.2, 24.5], [60.7, 25.1]]},
           "input": [{"path": str(fc), "type": "grid"}]}
    cfgp = tmp_path / "config.json"
    cfgp.write_text(json.dumps(cfg))
    m = RunMetrics()
    trunner.run(str(cfgp), "20191202T0100",
                output_path=str(tmp_path / "out.json"), verbose=True,
                device="cpu", engine="kernel", chunk_t=8, metrics=m,
                profile_dir=str(tmp_path / "prof"))
    lines = [l for l in capsys.readouterr().err.splitlines()
             if l.startswith("device idle by span, s: ")]
    assert len(lines) == 1
    trace = json.loads(next((tmp_path / "prof").glob("trace_*.json"))
                       .read_text())
    ranges = {e["name"] for e in trace["traceEvents"]
              if e.get("name", "").startswith("roadsurf::")}
    for name in ("data_plane.sources", "data_plane.stations",
                 "data_plane.params", "init.expanders", "init.state",
                 "cycle", "cycle_setup", "stream.issue", "write"):
        assert "roadsurf::" + name in ranges, name
        assert m.calls[name] >= 1, name
