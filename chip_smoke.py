"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the
hand-written scan kernel (K1, point-major, and K2, slim, modes of one
source) from this checkout, holds each mode against its plain torch
version, drives the station-fed production forecast end to end at
1,048,576 points x 8,881 steps (the operational 74-hour run at dt 30 s),
uncoupled and observation-coupled, and prints a JSON summary.

    python3 chip_smoke.py

Phases (each fails the run on any error; nothing falls back to the CPU or to
the plain version):

 1. toolchain and device: torch, CUDA, nvcc, the card's name and power limit;
 2. build csrc/scan_kernel.cu for sm_90a (ops/build.py), with ptxas's
    register, stack-frame and spill counts for every instantiation;
 3. K1 against scan_reference on the card: 65,536 points x 128 steps (two
    scenarios, output stride 1 and 4, one chunk with a global offset and
    nsteps < T; the same chunk for each setting in VARIANTS, so every
    template instantiation and physics branch runs), then one main-path
    chunk of 1,048,576 points x 64 steps (stride 120, offset 448) with both
    timed;
 3b. K2 against scan_reference on the card: 65,536 points x 128 steps,
    slim without the coefficient decay, and slim with it on an offset chunk
    that crosses window ends, holds the run's last step and has
    nsteps < T; K2 with the decay against K1 fed forcing.cof_window's rows,
    bit for bit; then one 1,048,576 x 64 chunk of each mode from the
    coupled configuration of phase 6, timed beside the plain version;
 4. run_production (station-level prepared channels; K2, and K1 with
    slim=False) against the port's Model.run on the card: 8,192 points, 64
    stations, some out of radius, 97 steps, (chunk_t, out_stride) = (32, 6)
    and (16, 7);
 4b. run_production_coupled against the port's Model.run_coupled (the
    per-point-PC engine) on the card: the same stations and points, window
    [11, 40] with an obs target below the air temperature, the same
    (chunk_t, out_stride) pairs; kernel tolerances, equal failed masks;
 5. the main path at full size: 2,048 stations -> 1,048,576 points, 8,881
    steps, hourly output, chunk 64, through K2 (the default) and through
    K1 (slim=False); kernel launches counted over each run; a 64-point
    sample re-run through Model.run over the whole horizon in float32 and
    float64, the kernel path held to twice the float32 run's error against
    float64;
 6. the coupled main path at full size: phase 5's stations and points with
    relaxation and a 180-minute coupling window ending in the last 20
    minutes of a 24 h analysis, every 7th station without obs:
    run_production_coupled (phase A and C through K2, phase B in torch on
    the card), with a 64-point sample of coupled points re-run through
    Model.run_coupled on the host in float32 and float64 under the same
    bound.

The last three lines of standard output are the kernel summary (JSON), the
card's name and power limit, and the device line (JSON).
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
from roadsurf_tpu_torch.forcing import RawForcing, cof_window  # noqa: E402
from roadsurf_tpu_torch.io.synthetic import synthetic_raw  # noqa: E402
from roadsurf_tpu_torch.model import Model  # noqa: E402
from roadsurf_tpu_torch.observability import Progress, RunMetrics  # noqa: E402
from roadsurf_tpu_torch.ops import build  # noqa: E402
from roadsurf_tpu_torch.ops import scan_kernel as sk  # noqa: E402
from roadsurf_tpu_torch import production  # noqa: E402
from roadsurf_tpu_torch.forcing import relax_anchors  # noqa: E402
from roadsurf_tpu_torch.state import PointParams, default_point_params  # noqa: E402

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


def assert_bitwise(label, got, want):
    """K2 with the in-kernel decay against K1 fed cof_window's rows: the
    same bits everywhere (the NaN of the padded profile rows included)."""
    for name, g, w in zip(("tmp", "scal", "out"), got, want):
        n_diff = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        if n_diff:
            raise AssertionError(
                f"{label}: {n_diff} elements of {name} differ, max |diff| "
                f"{float((g - w).abs().max()):.3e}")
    log(f"  {label}: equal bit for bit")


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


def phase_kernel_slim_small(npoints=65536, T=128):
    """K2 on 65,536 points x 128 steps: without the decay over the whole
    chunk; with it at global offset 40, 100 of 128 steps, in a run of 140
    steps (the chunk holds the lastValues step), window ends before and
    inside the chunk and at the last step.  The coupling flag is set at
    random, so the melting guard reads the obs aux row."""
    model = Model(ModelSettings(sim_len=T, dt=30.0), device=DEV)
    raw, cal = synthetic_raw(npoints, T, seed=21, scenario="winter_mix",
                             dtype=np.float32)
    prep = model.prepare(raw, default_point_params(npoints), cal)
    rng = np.random.default_rng(5)
    dev_f = lambda a: torch.tensor(np.asarray(a, np.float32), device=DEV)
    prep = prep._replace(in_coupling=torch.tensor(
        rng.random((T, npoints)) < 0.5, device=DEV))
    state = model.init(raw, cal, dtype=torch.float32)
    tmp0, scal0 = sk.pack_state(state)
    tmp0[model.settings.nlayers + 2:] = float("nan")
    forc, trf = sk.pack_forcing_slim(prep)
    obs = dev_f(rng.uniform(-3.0, 1.0, npoints))
    off, nsteps, stride = 40, 100, 4
    t_total = off + nsteps
    cend = rng.integers(20, t_total, npoints)
    cend[::9] = -99
    cend[1::9] = t_total - 1
    aux = sk.pack_aux(obs, dev_f(rng.uniform(-0.4, 0.6, npoints)),
                      dev_f(rng.uniform(-0.4, 0.6, npoints)), dev_f(cend))
    trf_g = torch.zeros(off + T, dtype=torch.float32, device=DEV)
    trf_g[off:] = trf
    geo = dict(out_stride=stride, nsteps=nsteps, out_offset=off,
               n_out=len(range(-(-off // stride) * stride, off + nsteps,
                               stride)))
    cof_kw = dict(slim_trf=trf_g, aux_rows=aux, aux_cofs=True,
                  t_total=t_total,
                  cof_red=model.settings.coupling_effect_reduction)
    cases = [("slim", dict(out_stride=1, slim_trf=trf,
                           aux_rows=sk.pack_aux(obs))),
             ("slim + decay, offset chunk", dict(geo, **cof_kw))]
    max_err = 0.0
    args = (tmp0, scal0, forc, model.cfg, model.params, model.grid)
    for label, kw in cases:
        got = sk.scan_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = sk.scan_reference(*args, **kw)
        err = compare_scan(label, got, want, model.settings.nlayers)
        log(f"  K2 vs plain, {npoints} x {T}, {label}: max |err| "
            f"{err:.3e}")
        max_err = max(max_err, err)
    # the same chunk through K1 fed forcing.cof_window's rows (on the card)
    swc, lwc = cof_window(aux[0], aux[1], aux[2].to(torch.int32), off, T,
                          t_total, model.settings, torch.float32)
    k1_forc = sk.pack_forcing(prep._replace(trf_fric=trf_g[off:]), swc, lwc,
                              obs)
    k1 = sk.scan_cuda(tmp0, scal0, k1_forc, model.cfg, model.params,
                      model.grid, **geo)
    assert_bitwise(f"K2 + decay vs K1 fed cof_window, {npoints} x {T}",
                   got, k1)
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
                npoints=npoints, ctx=ctx)


def coupled_full_setup(cfg, metrics, window_min=180, init_h=24):
    """Phase 5's stations and points with the reference's operating mode
    (examples/example1/example_config.json: relaxation and coupling on, a
    24 h analysis, a 180-minute coupling window): each station's last valid
    obs falls at a step drawn from the last 20 minutes of the analysis,
    coupling_end is that step and coupling_start 360 steps before it; the
    obs target is the station's air temperature there minus U(0.5, 2.5) K,
    so the control iterates; every 7th station has no obs.  Relaxation
    anchors at the end of the analysis.  Every point takes its station's
    values (the fast-path contract)."""
    raw_st, cal, st_idx, T = cfg["raw_st"], cfg["cal"], cfg["st_idx"], cfg["T"]
    S = raw_st.tair.shape[0]
    settings = ModelSettings(sim_len=T, dt=30.0, output_step_minutes=60,
                             use_relaxation=True, use_coupling=True,
                             coupling_minutes=window_min)
    model = Model(settings, device=DEV)
    il = int(init_h * 3600 / settings.dt)               # 2,880
    wl = settings.coupling_len_steps                     # 360
    rng = np.random.default_rng(17)
    end = rng.integers(il - 39, il + 1, S).astype(np.int32)   # [2841, 2880]
    rows = np.arange(S)
    obs = raw_st.tair[rows, end - 1] - rng.uniform(0.5, 2.5, S)
    no_obs = rows % 7 == 0
    obs = np.where(no_obs, -9999.9, obs)
    tsurf_obs = raw_st.tsurf_obs.copy()
    tsurf_obs[no_obs] = -9999.9
    raw_st = raw_st._replace(tsurf_obs=tsurf_obs)
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        init_len=np.full(S + 1, il, np.int32),
        tair_relax=app(raw_st.tair[rows, il] + 0.4, -9999.9),
        vz_relax=app(raw_st.vz[rows, il] + 0.1, -9999.9),
        rh_relax=app(raw_st.rhz[rows, il] - 2.0, -9999.9),
        coupling_start=app(np.where(no_obs, -99, end - wl), -99).astype(
            np.int32),
        coupling_end=app(np.where(no_obs, -99, end), -99).astype(np.int32),
        coupling_tsurf=app(obs, -9999.9))
    vz_a = raw_st.vz[:, :il].copy()
    vz_a[:, 0] = np.maximum(vz_a[:, 0], 0.4)
    anch_st = (app(raw_st.tair[rows, il - 1], -9999.9),
               app(vz_a[rows, il - 1], -9999.9),
               app(raw_st.rhz[rows, il - 1], -9999.9))
    ctx = {"st_pts": st_pts, "anchors": anch_st, "settings": settings,
           "params": model.params, "hour": cal.hour, "t_total": T}
    with metrics.phase("expander_coupled"):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=cfg["chunk_t"],
                                         prep_ctx=ctx)
        torch.cuda.synchronize()
    pts = default_point_params(len(st_idx))._replace(**{
        n: np.asarray(getattr(st_pts, n))[st_idx] for n in (
            "init_len", "tair_relax", "vz_relax", "rh_relax",
            "coupling_start", "coupling_end", "coupling_tsurf")})
    anchors = tuple(a[st_idx] for a in anch_st)
    first = RawForcing(**{n: exp.first_host[n][:, None]
                          for n in RawForcing._fields})
    state0 = model.init(first, cal, dtype=torch.float32)
    log(f"  coupled configuration: {int((~no_obs).sum())} of {S} stations "
        f"with obs, window ends in [{end.min()}, {end.max()}], "
        f"{wl} window steps, init_len {il}")
    return dict(cfg, model=model, exp=exp, pts=pts, state0=state0,
                raw_st=raw_st, anchors=anchors, st_pts=st_pts)


def phase_kernel_chunk(cfg):
    """One main-path chunk (1,048,576 points x 64 steps, stride 120,
    global offset 448), K1 and plain version timed on the card."""
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
    log(f"  K1 vs plain, {cfg['npoints']} x 64 main-path chunk: max |err| "
        f"{err:.3e}; kernel {ms:.3f} ms ({rate:.4g} point-steps/s), "
        f"plain {plain_ms:.1f} ms")
    # the other two layers of a stream chunk, for the time breakdown
    gather_ms = cuda_ms(lambda: eng.chunk_forcing(t0), reps=5)
    row = got[2][:1, :6]
    drain_ms = cuda_ms(lambda: row.cpu(), reps=5)
    log(f"  [{card_line()}] per K1 chunk: forcing gather {gather_ms:.3f} ms, "
        f"kernel {ms:.3f} ms, drain of one output row {drain_ms:.3f} ms")
    del forc, got, want, eng
    torch.cuda.empty_cache()
    return err, ms, plain_ms


def phase_kernel_slim_chunk(cfg6):
    """One 1,048,576 x 64 chunk of each K2 mode from the coupled
    configuration: without the decay at offset 448 (phase A), with it at
    the first chunk past every window end (offset 2,944, phase C); kernel
    and plain version
    timed on the card, and the decay chunk against K1 fed cof_window."""
    model = cfg6["model"]
    eng = production._Engine(model, cfg6["exp"], cfg6["pts"], cfg6["cal"],
                             cfg6["state0"], anchors=cfg6["anchors"],
                             chunk_t=cfg6["chunk_t"])
    assert eng.slim
    rng = np.random.default_rng(3)
    cofs = tuple(torch.tensor(rng.uniform(-0.3, 0.3, eng.P_pad)
                              .astype(np.float32), device=DEV)
                 for _ in range(2))
    res, errs = {}, []
    ct = cfg6["chunk_t"]
    t0_c = (int(np.max(cfg6["pts"].coupling_end)) // ct + 1) * ct
    for label, t0, c in (("slim", 7 * ct, None), ("slim + decay", t0_c, cofs)):
        forc, skw = eng.kernel_inputs(t0, c)
        args = (eng.tmp0, eng.scal0, forc, model.cfg, model.params,
                model.grid)
        kw = dict(out_stride=eng.os_, nsteps=cfg6["chunk_t"], out_offset=t0,
                  n_out=eng.k_alloc, **skw)
        got = sk.scan_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = sk.scan_reference(*args, **kw)
        torch.cuda.synchronize()
        errs.append(compare_scan(f"1M {label} chunk", got, want,
                                 model.settings.nlayers))
        ms = cuda_ms(lambda: sk.scan_cuda(*args, **kw), reps=10)
        plain_ms = cuda_ms(lambda: sk.scan_reference(*args, **kw), reps=2)
        gather_ms = cuda_ms(lambda: eng.kernel_inputs(t0, c), reps=5)
        rate = cfg6["npoints"] * cfg6["chunk_t"] / (ms * 1e-3)
        log(f"  [{card_line()}] K2 vs plain, {cfg6['npoints']} x 64 chunk, "
            f"{label}: max |err| {errs[-1]:.3e}; kernel {ms:.3f} ms "
            f"({rate:.4g} point-steps/s), plain {plain_ms:.1f} ms, slim "
            f"forcing gather {gather_ms:.3f} ms")
        res[label] = (ms, plain_ms)
        if c is not None:
            k1 = sk.scan_cuda(eng.tmp0, eng.scal0, eng.chunk_forcing(t0, c),
                              model.cfg, model.params, model.grid,
                              out_stride=eng.os_, nsteps=cfg6["chunk_t"],
                              out_offset=t0, n_out=eng.k_alloc)
            assert_bitwise("1M K2 + decay chunk vs K1 fed cof_window", got,
                           k1)
            del k1
        del forc, got, want
    del eng
    torch.cuda.empty_cache()
    return max(errs), res


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


def compare_fields(label, res, out_ref, final_ref, steps):
    """run_production(_coupled) rows against a reference [T, P] per field
    (or [n, P, 6] rows), kernel tolerances, equal failed masks."""
    errs = []
    for k, name in enumerate(production.OUT_FIELD_ROWS):
        ref = (out_ref[:, :, k] if isinstance(out_ref, torch.Tensor)
               else getattr(out_ref, name)[steps])
        errs.append(check_close(f"{label} {name}",
                                torch.from_numpy(res.fields[name]),
                                ref.cpu(), TOL_T if k == 0 else TOL_S))
    errs.append(check_close(f"{label} final tmp", res.state.tmp,
                            final_ref.tmp.cpu(), TOL_T))
    if not torch.equal(res.state.failed, final_ref.failed.cpu()):
        raise AssertionError(f"{label}: failed masks differ")
    return max(errs)


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
    for chunk_t, stride, slim in ((32, 6, True), (16, 7, True),
                                  (32, 6, False)):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx,
                                         slim=slim)
        before = (sk.LAUNCHES, sk.LAUNCHES_SLIM)
        res = production.run_production(
            model, exp, pts, cal, state0, anchors=anchors, chunk_t=chunk_t,
            out_stride=stride)
        n_chunks = -(-settings.sim_len // chunk_t)
        launched = (sk.LAUNCHES - before[0], sk.LAUNCHES_SLIM - before[1])
        assert launched == ((0, n_chunks) if slim else (n_chunks, 0)), \
            launched
        want = np.arange(0, settings.sim_len, stride)
        assert np.array_equal(res.out_steps, want), res.out_steps
        err = compare_fields("run_production", res, out_ref, final_ref, want)
        log(f"  run_production ({'K2' if slim else 'K1'}) vs Model.run, {P} "
            f"pts / 64 stations / 97 steps, (chunk_t, out_stride) = "
            f"({chunk_t}, {stride}): max |err| {err:.3e}, failed "
            f"{int(res.state.failed.sum())}")


def _small_coupled_case(S=64, P=8192, T=97, seed=11, ws=11, we=40):
    """phase 4's stations and points with coupling: window [ws, we], obs
    target below the station's air temperature at we
    (tests/test_production.py:279-294), station 2 without obs;
    station-derived values (relaxation off)."""
    (settings, raw_st, raw_pt, cal, _, st_idx, _, _) = _small_station_case(
        S=S, P=P, T=T, seed=seed)
    settings = ModelSettings(sim_len=T, dt=30.0, use_coupling=True)
    ok = st_idx >= 0
    sidx = np.where(ok, st_idx, S)
    rng = np.random.default_rng(5)
    obs_st = raw_st.tair[:, we - 1] - rng.uniform(0.5, 2.5, S)
    obs_st[2] = -9999.9
    app = lambda a, fill: np.concatenate([np.asarray(a), [fill]])
    st_pts = default_point_params(S + 1)._replace(
        coupling_start=app(np.full(S, ws, np.int32), -99).astype(np.int32),
        coupling_end=app(np.full(S, we, np.int32), -99).astype(np.int32),
        coupling_tsurf=app(obs_st, -9999.9))
    pts = default_point_params(P)._replace(
        coupling_start=np.asarray(st_pts.coupling_start)[sidx],
        coupling_end=np.asarray(st_pts.coupling_end)[sidx],
        coupling_tsurf=np.asarray(st_pts.coupling_tsurf)[sidx])
    return settings, raw_st, raw_pt, cal, pts, st_idx, st_pts


def phase_coupled_small(P=8192):
    settings, raw_st, raw_pt, cal, pts, st_idx, st_pts = \
        _small_coupled_case(P=P)
    model = Model(settings, device=DEV)
    t0 = time.perf_counter()
    final_pc, out_pc = model.run_coupled(raw_pt, pts, cal)
    log(f"  Model.run_coupled (per-point PC) on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    state0 = model.init(raw_pt, cal, dtype=torch.float32, pts=pts)
    ctx = {"st_pts": st_pts, "anchors": None, "settings": settings,
           "params": model.params, "hour": cal.hour,
           "t_total": settings.sim_len}
    for chunk_t, stride in ((32, 6), (16, 7)):
        exp = production.StationExpander(raw_st, st_idx, DEV,
                                         chunk_t=chunk_t, prep_ctx=ctx)
        metrics = RunMetrics()
        before = sk.LAUNCHES_SLIM
        res = production.run_production_coupled(
            model, exp, pts, cal, state0, chunk_t=chunk_t, out_stride=stride,
            metrics=metrics)
        assert sk.LAUNCHES_SLIM > before
        want = np.arange(0, settings.sim_len, stride)
        assert np.array_equal(res.out_steps, want), res.out_steps
        c = metrics.counters
        assert c["coupling_reruns"] > 0, c
        err = compare_fields("run_production_coupled", res,
                             out_pc[torch.as_tensor(want)], final_pc, want)
        log(f"  run_production_coupled vs Model.run_coupled, {P} pts / 64 "
            f"stations / 97 steps, window [11, 40], (chunk_t, out_stride) = "
            f"({chunk_t}, {stride}): max |err| {err:.3e}, reruns "
            f"{c['coupling_reruns']}, coupled {c['coupling_points']}, "
            f"succeeded {c['coupling_succeeded']}, failed "
            f"{c['coupling_failed']}")


def phase_main_full(cfg, metrics, exp):
    """The uncoupled main path at full size through ``exp``: K2 when it is
    slim, else K1.  Returns (result, K1 launches, K2 launches, peak bytes,
    failed share)."""
    model, T = cfg["model"], cfg["T"]
    slim = exp.slim
    torch.cuda.reset_peak_memory_stats(DEV)
    sk.LAUNCHES = sk.LAUNCHES_SLIM = 0
    res = production.run_production(
        model, exp, cfg["pts"], cfg["cal"], cfg["state0"],
        chunk_t=cfg["chunk_t"], metrics=metrics,
        progress=Progress(T, every_s=2.0))
    launches = (sk.LAUNCHES, sk.LAUNCHES_SLIM)
    peak = torch.cuda.max_memory_allocated(DEV)
    n_chunks = -(-T // cfg["chunk_t"])
    assert launches == ((0, n_chunks) if slim else (n_chunks, 0)), launches
    check_outputs(res, cfg)
    failed = float(res.state.failed.float().mean())
    return res, launches, peak, failed


def check_outputs(res, cfg):
    T = cfg["T"]
    assert np.array_equal(res.out_steps, np.arange(0, T, 120)), \
        res.out_steps
    for name, f in res.fields.items():
        assert f.shape == (len(range(0, T, 120)), cfg["npoints"]), \
            (name, f.shape)
        assert np.all(np.isfinite(f) | (f == -9999.0)), name


def phase_sample_long(cfg, res, n=64, coupled=False):
    """A sample of points re-run through Model.run (Model.run_coupled when
    ``coupled``: the per-point-PC engine) over the whole horizon, in float32
    and in float64 (the plain torch path on the host: at 64 points its step
    is dispatch-bound, and the CPU dispatches faster than the card).  Over
    8,881 steps no two float32 implementations agree at the kernel
    tolerances: where a storage runs out (the last ice melts, wet snow
    turns to water) the step and the remainder hang on rounding accumulated
    over thousands of steps, and tsurf or water jumps there.  So the bound
    is relative: per field, the kernel path's largest error against the
    float64 run is at most twice the float32 plain run's own, plus the
    field's tolerance; the failed masks are equal."""
    if coupled:
        cand = np.nonzero(np.asarray(cfg["pts"].coupling_end) >= 1)[0]
        idx = cand[np.linspace(0, len(cand) - 1, n).astype(np.int64)]
    else:
        idx = np.linspace(0, cfg["npoints"] - 1, n).astype(np.int64)
    raw = RawForcing(*(np.asarray(getattr(cfg["raw_st"], f))[
        cfg["st_idx"][idx]] for f in RawForcing._fields))
    raw64 = RawForcing(*(x.astype(np.float64) if x.dtype.kind == "f" else x
                         for x in raw))
    model = Model(cfg["model"].settings, device="cpu")
    pts = PointParams(*(np.asarray(x)[idx] for x in cfg["pts"]))
    t0 = time.perf_counter()
    if coupled:
        stride = cfg["model"].settings.output_stride
        final, out32 = model.run_coupled(raw, pts, cfg["cal"], stride)
        final64, out64 = model.run_coupled(raw64, pts, cfg["cal"], stride)
        pick = lambda out, k, name: out[:, :, k].numpy()
    else:
        final, out32 = model.run(raw, pts, cfg["cal"])
        final64, out64 = model.run(raw64, pts, cfg["cal"])
        pick = lambda out, k, name: getattr(out, name)[res.out_steps].numpy()
    secs = time.perf_counter() - t0
    assert torch.equal(final.failed, res.state.failed[idx]), "failed masks"
    assert torch.equal(final64.failed, res.state.failed[idx]), "failed masks"
    err, err32 = {}, {}
    for k, name in enumerate(production.OUT_FIELD_ROWS):
        ref = pick(out64, k, name)
        err[name] = float(np.abs(res.fields[name][:, idx] - ref).max())
        err32[name] = float(np.abs(pick(out32, k, name) - ref).max())
        atol = (TOL_T if k == 0 else TOL_S)["atol"]
        assert err[name] <= 2.0 * err32[name] + atol, \
            (name, err[name], err32[name])
    fmt = lambda e: json.dumps({k: float(f"{v:.3e}") for k, v in e.items()})
    what = "Model.run_coupled" if coupled else "Model.run"
    log(f"  {n}-point sample over {cfg['T']} steps ({secs:.0f} s), max |err| "
        f"against float64 {what}: kernel path {fmt(err)}; float32 "
        f"{what} {fmt(err32)}")
    return err


def phase_coupled_full(cfg6, metrics):
    model, T = cfg6["model"], cfg6["T"]
    torch.cuda.reset_peak_memory_stats(DEV)
    sk.LAUNCHES = sk.LAUNCHES_SLIM = 0
    t0 = time.perf_counter()
    res = production.run_production_coupled(
        model, cfg6["exp"], cfg6["pts"], cfg6["cal"], cfg6["state0"],
        anchors=cfg6["anchors"], chunk_t=cfg6["chunk_t"], metrics=metrics,
        progress=Progress(T, every_s=5.0))
    wall = time.perf_counter() - t0
    launches = (sk.LAUNCHES, sk.LAUNCHES_SLIM)
    peak = torch.cuda.max_memory_allocated(DEV)
    check_outputs(res, cfg6)
    c, ph = metrics.counters, metrics.phases
    assert c["coupling_reruns"] > 0, c
    assert launches[1] > 0, launches
    log(f"  [{card_line()}] run_production_coupled wall {wall:.2f} s: phase A "
        f"{ph['phase_a']:.2f} s, phase B {ph['phase_b']:.2f} s, phase C "
        f"{ph['phase_c']:.2f} s; stream {ph['stream']:.2f} s = "
        f"{res.point_steps_per_s:.6g} point-steps/s")
    log(f"  coupling: window steps {c['coupling_window_steps']}, re-run "
        f"passes {c['coupling_reruns']}, window rows stepped "
        f"{c['coupling_window_rows']} "
        f"({1e3 * ph['phase_b'] / c['coupling_window_rows']:.2f} ms a row), "
        f"window forcing cached "
        f"{bool(c['coupling_window_cached'])}; points coupled "
        f"{c['coupling_points']}, succeeded {c['coupling_succeeded']}, "
        f"failed {c['coupling_failed']}; K1 launches {launches[0]}, K2 "
        f"launches {launches[1]}; peak device memory "
        f"{peak / 2**30:.2f} GiB; failed share "
        f"{float(res.state.failed.float().mean()):.6f}")
    return res, launches


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

    log("== 3. K1 against its plain version")
    err_small = phase_kernel_small()
    metrics = RunMetrics(announce=True)      # phase lines on stderr
    cfg = full_size_setup(metrics)
    err_chunk, ms, plain_ms = phase_kernel_chunk(cfg)

    log("== 3b. K2 against its plain version")
    err_slim_small = phase_kernel_slim_small()
    cfg6 = coupled_full_setup(cfg, metrics)
    err_slim_chunk, slim_times = phase_kernel_slim_chunk(cfg6)

    log("== 4. main path, small, against Model.run on the card")
    phase_main_small()

    log("== 4b. coupled path, small, against Model.run_coupled on the card")
    phase_coupled_small()

    log("== 5. main path at full size: 1048576 points x 8881 steps")
    # K2 (the default, slim expander) and K1 (slim=False, a second expander
    # on the same stations), in turns: the first run pays the allocator's
    # growth
    exps = {"K2": cfg["exp"], "K1": production.StationExpander(
        cfg["raw_st"], cfg["st_idx"], DEV, chunk_t=cfg["chunk_t"],
        prep_ctx=cfg["ctx"], slim=False)}
    runs, launched = {}, [0, 0]
    for label in ("K1", "K2", "K2", "K1"):
        m = RunMetrics(announce=True)
        t0 = time.perf_counter()
        res, launches, peak, failed = phase_main_full(cfg, m, exps[label])
        wall = time.perf_counter() - t0
        launched = [a + b for a, b in zip(launched, launches)]
        log(f"  [{card}] run_production ({label}) wall {wall:.2f} s, stream "
            f"{m.phases['stream']:.2f} s, "
            f"{res.point_steps_per_s:.6g} point-steps/s (stream), "
            f"peak device memory {peak / 2**30:.2f} GiB, failed share "
            f"{failed:.6f}, kernel launches K1 {launches[0]} K2 "
            f"{launches[1]}")
        log(f"  [{card}] phases (s): " + json.dumps(
            {k: round(v, 3) for k, v in m.phases.items()}))
        runs[label] = (res, launches)
    diff = max(float(np.abs(runs["K2"][0].fields[k]
                            - runs["K1"][0].fields[k]).max())
               for k in production.OUT_FIELD_ROWS)
    log(f"  K2 vs K1 main path, all output rows: max |diff| {diff:.3e}")
    del exps, runs["K1"]
    torch.cuda.empty_cache()
    phase_sample_long(cfg, runs["K2"][0])

    log("== 6. coupled main path at full size: 1048576 points x 8881 steps")
    res6, launches6 = phase_coupled_full(cfg6, RunMetrics(announce=True))
    phase_sample_long(cfg6, res6, coupled=True)

    k1_launches = launched[0] + launches6[0]
    k2_launches = launched[1] + launches6[1]
    print(json.dumps({"kernels": [
        {"name": "scan_kernel", "route": "cuda",
         "source": "roadsurf_tpu_torch/csrc/scan_kernel.cu",
         "replaces": "roadsurf_tpu/ops/pallas_step.py:694",
         "launches": k1_launches,
         "max_abs_err": max(err_small, err_chunk),
         "ms": ms, "plain_ms": plain_ms},
        {"name": "scan_kernel_slim", "route": "cuda",
         "source": "roadsurf_tpu_torch/csrc/scan_kernel.cu",
         "replaces": "roadsurf_tpu/ops/pallas_step.py:694",
         "launches": k2_launches,
         "max_abs_err": max(err_slim_small, err_slim_chunk),
         "ms": slim_times["slim"][0], "plain_ms": slim_times["slim"][1]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
