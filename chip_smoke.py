"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the
hand-written scan kernel from this checkout, holds it against its plain
torch version, drives the station-fed production forecast end to end at
1,048,576 points x 8,881 steps (the operational 74-hour run at dt 30 s), and
prints a JSON summary.

    python3 chip_smoke.py

Phases (each fails the run on any error; nothing falls back to the CPU or to
the plain version):

 1. toolchain and device: torch, CUDA, nvcc, the card's name and power limit;
 2. build csrc/scan_kernel.cu for sm_90a (ops/build.py), with ptxas's
    register and spill counts;
 3. the kernel against scan_reference on the card: 65,536 points x 128
    steps (two scenarios, output stride 1 and 4, one chunk with a global
    offset and nsteps < T; the same chunk for each setting in VARIANTS, so
    every template instantiation and physics branch runs), then one main-path chunk of 1,048,576 points x
    64 steps (stride 120, offset 448) with both timed;
 4. run_production (station-level prepared channels) against the port's
    Model.run on the card: 8,192 points, 64 stations, some out of radius,
    97 steps, (chunk_t, out_stride) = (32, 6) and (16, 7);
 5. the main path at full size: 2,048 stations -> 1,048,576 points, 8,881
    steps, hourly output, chunk 64; kernel launches counted over the run;
    a 64-point sample re-run through Model.run over the whole horizon in
    float32 and float64, the kernel path held to twice the float32 run's
    error against float64.

The last two lines of standard output are the kernel summary and the device
line, both JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device "
                     "(torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from roadsurf_tpu_torch.config import ModelSettings  # noqa: E402
from roadsurf_tpu_torch.forcing import RawForcing  # noqa: E402
from roadsurf_tpu_torch.io.synthetic import synthetic_raw  # noqa: E402
from roadsurf_tpu_torch.model import Model  # noqa: E402
from roadsurf_tpu_torch.observability import Progress, RunMetrics  # noqa: E402
from roadsurf_tpu_torch.ops import build  # noqa: E402
from roadsurf_tpu_torch.ops import scan_kernel as sk  # noqa: E402
from roadsurf_tpu_torch import production  # noqa: E402
from roadsurf_tpu_torch.forcing import relax_anchors  # noqa: E402
from roadsurf_tpu_torch.state import default_point_params  # noqa: E402

DEV = torch.device("cuda", 0)
# tests/test_pallas_step.py:47-57 (tsurf and the profile; the storages)
TOL_T = dict(rtol=2e-5, atol=2e-4)
TOL_S = dict(rtol=2e-5, atol=2e-3)
# settings that reach the kernel's other template instantiations (layer
# capacity 32; a global output depth) and physics branches (the flag
# combinations of tests/test_triad_lockstep.py:37-43)
VARIANTS = ({"tsurf_output_depth": 0.03}, {"nlayers": 20},
            {"nlayers": 20, "tsurf_output_depth": 0.5},
            {"force_snow_melting": True, "force_ice_melting": True},
            {"melting_can_change_temperature": False}, {"force_tsurf": True})


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()


def check_close(name, got, want, tol):
    """Assert |got - want| <= atol + rtol |want| elementwise (NaN equal
    NaN); return the largest absolute error over finite pairs."""
    got, want = got.double(), want.double()
    both_nan = torch.isnan(got) & torch.isnan(want)
    err = (got - want).abs()
    bad = ~both_nan & ~(err <= tol["atol"] + tol["rtol"] * want.abs())
    if bool(bad.any()):
        idx = bad.nonzero()[0].tolist()
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside {tol}; first at "
            f"{idx}: got {got[tuple(idx)].item()!r} want "
            f"{want[tuple(idx)].item()!r}")
    finite = torch.isfinite(err)
    return float(err[finite].max()) if bool(finite.any()) else 0.0


def compare_scan(label, got, want, nlayers):
    """Kernel vs plain results: profile, outputs, equal failed masks."""
    tmp_g, scal_g, out_g = got
    tmp_w, scal_w, out_w = want
    errs = [check_close(f"{label} tmp", tmp_g[:nlayers + 2],
                        tmp_w[:nlayers + 2], TOL_T),
            check_close(f"{label} tsurf", out_g[:, 0], out_w[:, 0], TOL_T)]
    for k, name in enumerate(("wat", "snow", "ice", "ice2", "dep"), 1):
        errs.append(check_close(f"{label} {name}", out_g[:, k], out_w[:, k],
                                TOL_S))
    if not torch.equal(scal_g[sk.R_FAILED], scal_w[sk.R_FAILED]):
        raise AssertionError(f"{label}: failed masks differ")
    return max(errs)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def packed_inputs(model, npoints, sim_len, scenario, seed):
    """Packed kernel inputs from the port's own prep of synthetic forcing.
    The padded profile rows hold NaN, which neither version may read."""
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario,
                             dtype=np.float32)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    state = model.init(raw, cal, dtype=torch.float32)
    ones = torch.ones(prep.tair.shape, dtype=torch.float32, device=DEV)
    obs = torch.tensor(pts.coupling_tsurf, dtype=torch.float32, device=DEV)
    tmp0, scal0 = sk.pack_state(state)
    tmp0[model.settings.nlayers + 2:] = float("nan")
    return tmp0, scal0, sk.pack_forcing(prep, ones, ones, obs)


def phase_kernel_small(npoints=65536):
    max_err = 0.0
    off, stride, nsteps = 5, 4, 100
    n_out = len(range(-(-off // stride) * stride, off + nsteps, stride))
    partial = dict(out_stride=stride, nsteps=nsteps, out_offset=off,
                   n_out=n_out)
    runs = [("winter_mix", {}, [dict(out_stride=1), dict(out_stride=4),
                                partial]),
            ("cold_snow", {}, [dict(out_stride=1), dict(out_stride=4)])]
    runs += [("winter_mix", v, [partial]) for v in VARIANTS]
    for scenario, variant, cases in runs:
        model = Model(ModelSettings(sim_len=128, dt=30.0, **variant),
                      device=DEV)
        packed = packed_inputs(model, npoints, 128, scenario, seed=21)
        for kw in cases:
            got = sk.scan_cuda(*packed, model.cfg, model.params, model.grid,
                               **kw)
            torch.cuda.synchronize()
            want = sk.scan_reference(*packed, model.cfg, model.params,
                                     model.grid, **kw)
            label = f"{scenario} {variant or 'defaults'} {kw}"
            err = compare_scan(label, got, want, model.settings.nlayers)
            log(f"  kernel vs plain, {npoints} x 128, {label}: "
                f"max |err| {err:.3e}")
            max_err = max(max_err, err)
    return max_err


def full_size_setup(metrics, S=2048, npoints=1048576, T=8881, chunk_t=64):
    """The operational configuration: 2,048 stations -> 1,048,576 points,
    8,881 steps of 30 s, hourly output (bench.py:130-148 at full length)."""
    t0 = time.perf_counter()
    raw_st, cal = synthetic_raw(S, T, dt=30.0, seed=7,
                                scenario="winter_mix", dtype=np.float32)
    rng = np.random.default_rng(7)
    st_idx = rng.integers(0, S, size=npoints)
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=False)
    model = Model(settings, device=DEV)
    log(f"  synthetic station forcing [{S}, {T}] in "
        f"{time.perf_counter() - t0:.1f} s")
    ctx = {"st_pts": default_point_params(S + 1), "anchors": None,
           "settings": settings, "params": model.params, "hour": cal.hour,
           "t_total": T}
    with metrics.phase("expander"):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx)
        torch.cuda.synchronize()
    pts = default_point_params(npoints)
    first = RawForcing(**{n: exp.first_host[n][:, None]
                          for n in RawForcing._fields})
    with metrics.phase("init"):
        state0 = model.init(first, cal, dtype=torch.float32)
        torch.cuda.synchronize()
    return dict(model=model, exp=exp, pts=pts, cal=cal, state0=state0,
                raw_st=raw_st, st_idx=st_idx, chunk_t=chunk_t, T=T,
                npoints=npoints)


def phase_kernel_chunk(cfg):
    """One main-path chunk (1,048,576 points x 64 steps, stride 120,
    global offset 448), kernel and plain version timed on the card."""
    model = cfg["model"]
    eng = production._Engine(model, cfg["exp"], cfg["pts"], cfg["cal"],
                             cfg["state0"], chunk_t=cfg["chunk_t"])
    t0 = 7 * cfg["chunk_t"]
    forc = eng.chunk_forcing(t0)
    args = (eng.tmp0, eng.scal0, forc, model.cfg, model.params, model.grid)
    kw = dict(out_stride=eng.os_, nsteps=cfg["chunk_t"], out_offset=t0,
              n_out=eng.k_alloc)
    got = sk.scan_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = sk.scan_reference(*args, **kw)
    torch.cuda.synchronize()
    err = compare_scan("1M chunk", got, want, model.settings.nlayers)
    ms = cuda_ms(lambda: sk.scan_cuda(*args, **kw), reps=10)
    plain_ms = cuda_ms(lambda: sk.scan_reference(*args, **kw), reps=2)
    rate = cfg["npoints"] * cfg["chunk_t"] / (ms * 1e-3)
    log(f"  kernel vs plain, {cfg['npoints']} x 64 main-path chunk: max |err| "
        f"{err:.3e}; kernel {ms:.3f} ms ({rate:.4g} point-steps/s), "
        f"plain {plain_ms:.1f} ms")
    # the other two layers of a stream chunk, for the time breakdown
    gather_ms = cuda_ms(lambda: eng.chunk_forcing(t0), reps=5)
    row = got[2][:1, :6]
    drain_ms = cuda_ms(lambda: row.cpu(), reps=5)
    log(f"  [{card_line()}] per chunk: forcing gather {gather_ms:.3f} ms, "
        f"kernel {ms:.3f} ms, drain of one output row {drain_ms:.3f} ms")
    del forc, got, want, eng
    torch.cuda.empty_cache()
    return err, ms, plain_ms


def _small_station_case(S=64, P=8192, T=97, seed=11):
    """Station-fed setup with relaxation and out-of-radius points
    (tests/test_production.py:20-57 and :106-140, sky view off)."""
    settings = ModelSettings(sim_len=T, dt=30.0, use_relaxation=True)
    raw_st, cal = synthetic_raw(S, T, seed=seed, dtype=np.float32)
    rng = np.random.default_rng(seed)
    st_idx = rng.integers(0, S, size=P)
    st_idx[::97] = -1
    ok = st_idx >= 0
    raw_pt = RawForcing(*(
        np.where(ok[:, None], np.asarray(getattr(raw_st, n))[
            np.where(ok, st_idx, 0)], -9999 if n == "prec_phase"
            else np.float32(-9999.9)) for n in RawForcing._fields))
    il = 25
    rows = np.arange(S)
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        init_len=np.full(S + 1, il, np.int32),
        tair_relax=app(raw_st.tair[rows, il] + 0.4, -9999.9),
        vz_relax=app(raw_st.vz[rows, il] + 0.1, -9999.9),
        rh_relax=app(raw_st.rhz[rows, il] - 2.0, -9999.9))
    sidx = np.where(ok, st_idx, S)
    pts = default_point_params(P)._replace(
        init_len=np.full(P, il, np.int32),
        tair_relax=np.asarray(st_pts.tair_relax)[sidx],
        vz_relax=np.asarray(st_pts.vz_relax)[sidx],
        rh_relax=np.asarray(st_pts.rh_relax)[sidx])
    vz_a = raw_st.vz.copy()
    vz_a[:, 0] = np.maximum(vz_a[:, 0], 0.4)
    anch_st = (app(raw_st.tair[rows, il - 1], -9999.9),
               app(vz_a[rows, il - 1], -9999.9),
               app(raw_st.rhz[rows, il - 1], -9999.9))
    return settings, raw_st, raw_pt, cal, pts, st_idx, st_pts, anch_st


def phase_main_small(P=8192):
    (settings, raw_st, raw_pt, cal, pts, st_idx, st_pts,
     anch_st) = _small_station_case(P=P)
    model = Model(settings, device=DEV)
    final_ref, out_ref = model.run(raw_pt, pts, cal)
    state0 = model.init(raw_pt, cal, dtype=torch.float32)
    anchors = relax_anchors(raw_pt, pts)
    ctx = {"st_pts": st_pts, "anchors": anch_st, "settings": settings,
           "params": model.params, "hour": cal.hour,
           "t_total": settings.sim_len}
    for chunk_t, stride in ((32, 6), (16, 7)):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx)
        before = sk.LAUNCHES
        res = production.run_production(
            model, exp, pts, cal, state0, anchors=anchors, chunk_t=chunk_t,
            out_stride=stride)
        n_chunks = -(-settings.sim_len // chunk_t)
        assert sk.LAUNCHES - before == n_chunks, (sk.LAUNCHES, before)
        want = np.arange(0, settings.sim_len, stride)
        assert np.array_equal(res.out_steps, want), res.out_steps
        errs = []
        for k, name in enumerate(production.OUT_FIELD_ROWS):
            ref = getattr(out_ref, name)[want].cpu()
            errs.append(check_close(
                f"run_production {name}", torch.from_numpy(res.fields[name]),
                ref, TOL_T if k == 0 else TOL_S))
        errs.append(check_close("run_production final tmp", res.state.tmp,
                                final_ref.tmp.cpu(), TOL_T))
        assert torch.equal(res.state.failed, final_ref.failed.cpu())
        log(f"  run_production vs Model.run, {P} pts / 64 stations / 97 "
            f"steps, (chunk_t, out_stride) = ({chunk_t}, {stride}): max "
            f"|err| {max(errs):.3e}, failed {int(res.state.failed.sum())}")


def phase_main_full(cfg, metrics):
    model, T = cfg["model"], cfg["T"]
    torch.cuda.reset_peak_memory_stats(DEV)
    sk.LAUNCHES = 0
    res = production.run_production(
        model, cfg["exp"], cfg["pts"], cfg["cal"], cfg["state0"],
        chunk_t=cfg["chunk_t"], metrics=metrics,
        progress=Progress(T, every_s=0.5))
    launches = sk.LAUNCHES
    peak = torch.cuda.max_memory_allocated(DEV)
    n_chunks = -(-T // cfg["chunk_t"])
    assert launches == n_chunks, (launches, n_chunks)
    assert np.array_equal(res.out_steps, np.arange(0, T, 120)), \
        res.out_steps
    for name, f in res.fields.items():
        assert f.shape == (len(range(0, T, 120)), cfg["npoints"]), \
            (name, f.shape)
        assert np.all(np.isfinite(f) | (f == -9999.0)), name
    failed = float(res.state.failed.float().mean())
    return res, launches, peak, failed


def phase_sample_long(cfg, res, n=64):
    """A sample of points re-run through Model.run over the whole horizon,
    in float32 and in float64 (the plain torch scan on the host: at 64
    points its step is dispatch-bound, and the CPU dispatches faster than
    the card).  Over 8,881 steps no two float32 implementations agree at
    the kernel tolerances: where a storage runs out (the last ice melts,
    wet snow turns to water) the step and the remainder hang on rounding
    accumulated over thousands of steps, and tsurf or water jumps there.
    So the bound is relative: per field, the kernel path's largest error
    against the float64 run is at most twice the float32 Model.run's own,
    plus the field's tolerance."""
    idx = np.linspace(0, cfg["npoints"] - 1, n).astype(np.int64)
    raw = RawForcing(*(np.asarray(getattr(cfg["raw_st"], f))[
        cfg["st_idx"][idx]] for f in RawForcing._fields))
    raw64 = RawForcing(*(x.astype(np.float64) if x.dtype.kind == "f" else x
                         for x in raw))
    model = Model(cfg["model"].settings, device="cpu")
    pts = default_point_params(n)
    t0 = time.perf_counter()
    final, out32 = model.run(raw, pts, cfg["cal"])
    final64, out64 = model.run(raw64, pts, cfg["cal"])
    secs = time.perf_counter() - t0
    assert torch.equal(final.failed, res.state.failed[idx]), "failed masks"
    assert torch.equal(final64.failed, res.state.failed[idx]), "failed masks"
    rows = res.out_steps
    err, err32 = {}, {}
    for k, name in enumerate(production.OUT_FIELD_ROWS):
        ref = getattr(out64, name)[rows].numpy()
        err[name] = float(np.abs(res.fields[name][:, idx] - ref).max())
        err32[name] = float(np.abs(getattr(out32, name)[rows].numpy()
                                   - ref).max())
        atol = (TOL_T if k == 0 else TOL_S)["atol"]
        assert err[name] <= 2.0 * err32[name] + atol, \
            (name, err[name], err32[name])
    fmt = lambda e: json.dumps({k: float(f"{v:.3e}") for k, v in e.items()})
    log(f"  {n}-point sample over {cfg['T']} steps ({secs:.0f} s), max |err| "
        f"against float64 Model.run: kernel path {fmt(err)}; float32 "
        f"Model.run {fmt(err32)}")
    return err


def main():
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log("== 1. toolchain and device")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log("  " + nvcc.stdout.strip().splitlines()[-1])
    log(f"  card: {card}")

    log("== 2. build")
    info = build.build()
    log(f"  {info['path']}: {'built' if info['built'] else 'reused'} in "
        f"{info['seconds']:.2f} s")
    for kname, regs, frame, st, ld in build.ptxas_usage(info["log"]):
        log(f"  {kname}: {regs} registers, stack frame {frame} B, spill "
            f"stores {st} B, spill loads {ld} B")
    build.load()

    log("== 3. kernel against its plain version")
    err_small = phase_kernel_small()
    metrics = RunMetrics(announce=True)      # phase lines on stderr
    cfg = full_size_setup(metrics)
    err_chunk, ms, plain_ms = phase_kernel_chunk(cfg)

    log("== 4. main path, small, against Model.run on the card")
    phase_main_small()

    log("== 5. main path at full size: 1048576 points x 8881 steps")
    t0 = time.perf_counter()
    res, launches, peak, failed = phase_main_full(cfg, metrics)
    wall = time.perf_counter() - t0
    log(f"  [{card}] run_production wall {wall:.2f} s, stream "
        f"{metrics.phases['stream']:.2f} s, "
        f"{res.point_steps_per_s:.6g} point-steps/s (stream), "
        f"peak device memory {peak / 2**30:.2f} GiB, failed share "
        f"{failed:.6f}, kernel launches {launches}")
    log(f"  [{card}] phases (s): " + json.dumps(
        {k: round(v, 3) for k, v in metrics.phases.items()}))
    phase_sample_long(cfg, res)

    print(json.dumps({"kernels": [{
        "name": "scan_kernel", "route": "cuda",
        "source": "roadsurf_tpu_torch/csrc/scan_kernel.cu",
        "replaces": "roadsurf_tpu/ops/pallas_step.py:694",
        "launches": launches,
        "max_abs_err": max(err_small, err_chunk),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
