"""One run of one cell of ``BENCHMARK.json``, in this process.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the process's start): the caches fixed inside
the checkout, the kernels and the native data-plane library built (each
build's tools under a time limit), the cell's input files generated from
the seed into ``TMPDIR``, read through the program's data plane, the
init built through its own pieces (``deploy.py``), and one warm-up cycle.
Window: whole forecast cycles back to back, one in flight, each from its
own warm start (``warm.py``), until ``--seconds`` have passed.  After it:
the device's peak memory, the comparison with the plain reference on a
sample of the window's points (``check.py``), the metrics, the teardown
of every process below this one, and one JSON line.  With ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics in place of its end-to-end ones.

It exits non-zero without a result where there is no card or fewer than
the cell asks for, where a process is left below it, or where JAX or the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

from . import check, manifest, procs

#: module names whose presence after the window fails the run, compared
#: by the whole top-level name (``roadsurf_tpu_torch`` is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "roadsurf_tpu")
#: time limits of the tools a run starts
BUILD_LIMIT_S = 900.0
NATIVE_LIMIT_S = 300.0
SMI_LIMIT_S = 30.0


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so that only a checkout's first run builds."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def smi() -> str:
    """One ``nvidia-smi`` query of the card's name, power limit, clocks,
    power and temperature."""
    try:
        res = procs.run_child(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            SMI_LIMIT_S)
    except (OSError, procs.subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip() or res.stderr.strip()


def build_program(device) -> None:
    """The program's kernels (``ops/build.py``, nvcc) and its native
    data-plane library (``io/native.py``, ``make -C native``), each under
    a time limit."""
    from roadsurf_tpu_torch.io import native
    if device.type == "cuda":
        from roadsurf_tpu_torch.ops import build
        procs.call_with_limit(build.load, BUILD_LIMIT_S, "nvcc")
    procs.call_with_limit(lambda: native.load(build_if_missing=True),
                          NATIVE_LIMIT_S, "make -C native")


def generate(cfg: dict, run_cfg: dict, seed: int, out_dir: str) -> None:
    """The cell's input files from the seed, by the configuration's
    generator (``generators/<name>.py``)."""
    gen = cfg["generator"]
    mod = importlib.import_module(f"benchmark.generators.{gen['name']}")
    args = {"analysis": run_cfg["time"]["analysis"],
            "forecast": run_cfg["time"]["forecast"], **gen.get("args", {})}
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in args.items()]
    with contextlib.redirect_stdout(sys.stderr):
        mod.main(argv + [f"--seed={seed}", f"--outdir={out_dir}"])


class Readings:
    """What the per-layer readers (``metrics/<name>.py``) read."""

    def __init__(self, spans, metrics, cycle_s, trace, shapes):
        self.spans = spans                    #: {name: seconds}, set-up
        self.counters = metrics.counters      #: RunMetrics, summed
        self.phases = metrics.phases          #: RunMetrics, summed
        self.cycle_s = cycle_s                #: each traced cycle's seconds
        self.cycles = len(cycle_s)            #: whole cycles traced
        self.trace = trace                    #: trace.DeviceTrace or None
        self.shapes = shapes                  #: a cycle's shapes, ``shapes``


def measure(workload: str, seed: int, seconds: float, trace_on: bool,
            device, sizes: dict = None, fault=None) -> dict:
    """One run of ``workload`` on ``device``; the result's pieces.
    ``sizes`` (tests) merges into the configuration; ``fault`` (tests)
    wraps the cycle call, ``fault(cycle_fn) -> cycle_fn``."""
    import numpy as np
    import torch
    from roadsurf_tpu_torch.observability import RunMetrics

    from . import deploy, trace, warm
    from .reference import run as reference

    man = manifest.manifest()
    cell = manifest.workload(workload, man)
    cfg = manifest.merge(manifest.config(cell["config"]), sizes or {})
    traffic = manifest.traffic(cell["traffic"])
    limits = check.load_limits(manifest.BENCH_DIR, workload)
    cuda = device.type == "cuda"
    spans = deploy.Spans()

    with spans.span("build"):
        build_program(device)
    data_dir = tempfile.mkdtemp(prefix="roadsurf_bench_")
    try:
        run_cfg = manifest.runner_config(cfg, traffic, data_dir)
        with spans.span("generate"):
            generate(cfg, run_cfg, seed, data_dir)
        dep = deploy.build(run_cfg, cfg["now"], device, spans)
        grid_fields = dep.grid_fields
        P = dep.n_points
        T = dep.settings.sim_len
        amp = traffic["warm_start"]
        k = int(traffic["check"]["points_per_cycle"])
        cycle_fn = deploy.cycle if fault is None else fault(deploy.cycle)

        def one(c, metrics):
            d = warm.draws(seed, c, P, device, amp)
            res = cycle_fn(dep, warm.apply(dep.state0, d), metrics)
            idx = check.sample_points(seed, c, P, k)
            return res, check.keep(c, idx, res, d)

        with spans.span("warm_up"):
            res, _ = one(0, RunMetrics())
            del res
        card = smi() if cuda else "no card"
        log(f"card before the window: {card}")

        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        metrics = RunMetrics()
        prof = trace.profiler() if trace_on and cuda else None
        if prof is not None:
            prof.__enter__()
        kept, cycle_s = [], []
        setup_s = process_age()
        t0 = time.perf_counter()
        c = 1
        while True:
            tc = time.perf_counter()
            res, kc = one(c, metrics)
            del res
            t_end = time.perf_counter()
            cycle_s.append(t_end - tc)
            kept.append(kc)
            if t_end - t0 >= seconds:
                break
            c += 1
        window_s = t_end - t0
        log(f"set-up {setup_s:.3f} s: " + ", ".join(
            f"{n} {s:.3f}" for n, s in spans.s.items()))
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        log(f"window {window_s:.3f} s: {len(cycle_s)} cycles, median "
            f"{float(np.median(cycle_s)):.4f} s, longest "
            f"{max(cycle_s):.4f} s; each: "
            + " ".join(f"{t:.4f}" for t in cycle_s))
        log("the program's phases over the window, s: " + ", ".join(
            f"{n} {v:.3f}" for n, v in metrics.phases.items()))
        card_after = smi() if cuda else "no card"
        log(f"card after the window: {card_after}")
        dev_trace = (trace.read(prof, window_s) if prof is not None
                     else None)
        del prof, one, dep
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the reference, on the CPU, over the kept points
        t_ref = time.perf_counter()
        kept_c = check.thin(kept, int(traffic["check"]["max_points"]), seed)
        index, draws = check.columns(kept_c)
        inp = reference.inputs(run_cfg, cfg["now"], index)
        ref = reference.forecast(
            inp, lambda st: warm.apply(st, {n: torch.as_tensor(v)
                                            for n, v in draws.items()}),
            kept_c[0].steps)
        numbers = check.compare(kept_c, ref.rows, ref.state)
        log(f"reference: {len(index)} points of {len(kept_c)} cycles in "
            f"{time.perf_counter() - t_ref:.1f} s; boundary-layer "
            f"iterations a point-step {ref.bl_iters_per_step:.4f}")
        correct = check.judge(numbers, limits)

        n_cyc = len(cycle_s)
        log(f"device memory peak, bytes: set-up {setup_peak}, window "
            f"{window_peak} (the result's memory_peak_bytes)")
        result = {
            "correct": bool(correct), "attempted": n_cyc, "failed": 0,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(device) if cuda
                                else "cpu"),
                       "count": 1,
                       "memory_peak_bytes": int(window_peak)},
        }
        if not trace_on:
            values = {
                "point_steps_per_s": n_cyc * P * T / window_s,
                "peak_mem_gib": window_peak / 2 ** 30,
                "setup_s": setup_s,
            }
            log(f"cycles {n_cyc}: p95 "
                f"{float(np.percentile(np.asarray(cycle_s), 95)):.4f} s")
        else:
            values = {}
            r = Readings(spans.s, metrics, cycle_s, dev_trace,
                         shapes(inp, T, P, metrics, n_cyc, grid_fields,
                                ref.bl_iters_per_step))
            for m in manifest.metrics_of(workload, "per_layer", man):
                v = manifest.metric_reader(m["name"])(r)
                if v is not None:
                    values[m["name"]] = float(v)
            if dev_trace is not None:
                result["device"]["busy_s"] = dev_trace.busy_s()
                result["device"]["window_s"] = dev_trace.window_s
                result["breakdown"] = {
                    "device_ops": dev_trace.top_ops(),
                    "idle_gaps": dev_trace.idle_gaps()}
            log(f"the card beside the roofline shares (name, power limit, "
                f"clock, power, temperature): {card}")
        units = {m["name"]: m["unit"] for m in man["end_to_end"]
                 + man["per_layer"]}
        result["metrics"] = {n: {"value": v, "unit": units[n]}
                             for n, v in values.items()}
        result["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                            for n in check.NUMBERS}
        return result
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def shapes(inp, T, P, metrics, n_cyc, grid_fields, bl_iters) -> dict:
    """A cycle's shapes, which a metric's reader counts its work from
    (``roofline.work_of``): the padded points, the steps outside the
    coupling window and the window's own, from the reference's windows of
    the kept points, the launches a cycle (the engine's chunk counter over
    the window's cycles), the output rows outside the window, the ground
    layers, the NWP grids' fields, relaxation on a grid, and the
    boundary-layer iterations a point-step that the reference counted."""
    import numpy as np
    lanes = 128
    p_pad = -(-P // lanes) * lanes
    settings = inp.settings
    ws = we = 0                       # 1-based; no window: 0, 0
    if settings.use_coupling:
        end = np.asarray(inp.pts.coupling_end)
        start = np.asarray(inp.pts.coupling_start)
        obs = np.asarray(inp.pts.coupling_tsurf)
        on = (end >= 1) & (obs > -100.0)
        if on.any():
            ws = max(int(start[on].min()), 1)
            we = int(min(end[on].max(), T - 1))
    W = we - ws + 1 if ws else 0
    out = np.arange(0, T, settings.output_stride) + 1
    return {"points": p_pad, "steps": T - W, "window_steps": W,
            "decay_steps": T - we if W else 0,
            "chunks": int(round(metrics.counters.get("stream_chunks", 0)
                                / max(n_cyc, 1))),
            "out_rows": int(np.sum((out < ws) | (out > we))) if W
            else len(out),
            "layers": settings.nlayers,
            "grid_fields": list(grid_fields),
            "grid_channels": len(grid_fields),
            "relax": bool(settings.use_relaxation) and bool(grid_fields),
            "bl_iters": float(bl_iters)}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(manifest.ROOT)
    result = None
    left = []
    try:
        import torch
        need = int(manifest.workload(args.workload)["chips"])
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark runs on the card only")
            return 2
        if torch.cuda.device_count() < need:
            log(f"the cell asks for {need} cards, "
                f"{torch.cuda.device_count()} are visible")
            return 2
        result = measure(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0))
    finally:
        left = procs.teardown()
    log(f"processes below this run after teardown: {len(left)} found"
        + (f" and killed ({left})" if left else "") + "; none left")
    if left:
        log("a process was left running below the run: the run failed")
        return 3
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark may not load: {bad}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
