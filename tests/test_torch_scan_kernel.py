"""The whole-scan kernel's plain torch version (``scan_reference``) against
the JAX Pallas kernel (``pallas_scan(interpret=True)``) and against the
port's own torch scan, float32 on the same packed inputs; and, on a CUDA
card, the hand-written kernel against ``scan_reference``.  Tolerances are
those of tests/test_pallas_step.py:47-65."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roadsurf_tpu.config import ModelSettings
from roadsurf_tpu.io.synthetic import synthetic_raw
from roadsurf_tpu.model import Model
from roadsurf_tpu.ops import pallas_step as ps
from roadsurf_tpu.state import default_point_params
from roadsurf_tpu_torch import forcing as tforcing
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch.ops import build
from roadsurf_tpu_torch.ops import scan_kernel as sk
from roadsurf_tpu_torch.tools import sass

torch.set_num_threads(1)

F32_KEYS = ("tair", "vz", "rhz", "rain", "snow", "sw", "lw", "tsurf_obs",
            "trf_fric")
FIELDS = (("wat", 1), ("snow", 2), ("ice", 3), ("ice2", 4), ("dep", 5))

# tests/test_triad_lockstep.py:37-43 (copied: every physics flag toggled)
FLAG_COMBOS = [
    {},
    {"force_snow_melting": True, "force_ice_melting": True},
    {"melting_can_change_temperature": False},
    {"force_tsurf": True},
    {"tsurf_output_depth": 0.03},
]
# the kernel's template buckets: layer capacity 16 or 32, each with and
# without a global output depth
KERNEL_CASES = FLAG_COMBOS + [
    {"nlayers": 20},
    {"nlayers": 20, "tsurf_output_depth": 0.5},
]
CASE_IDS = lambda c: "+".join(f"{k}={v}" for k, v in c.items()) or "defaults"


def _inputs(scenario="winter_mix", sim_len=128, npoints=1024, seed=21,
            **settings_kw):
    """JAX-side float32 inputs as tests/test_pallas_step.py:15-31 builds
    them, and the port's model, state and prepared forcing made from them
    through interop."""
    settings = ModelSettings(sim_len=sim_len, dt=30.0, **settings_kw)
    model = Model(settings)
    raw, cal = synthetic_raw(npoints, sim_len, seed=seed, scenario=scenario,
                             dtype=np.float32)
    pts = default_point_params(npoints)
    prep = model.prepare(raw, pts, cal)
    prep = prep._replace(**{k: jnp.asarray(getattr(prep, k), jnp.float32)
                            for k in F32_KEYS})
    state = model.init(raw, cal, dtype=jnp.float32)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    return model, tm, pts, prep, state


def _jax_packed(prep, state, pts):
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)
    tmp0, scal0 = ps.pack_state(state)
    return tmp0, scal0, ps.pack_forcing(prep, ones, ones, obs)


def _port_packed(prep, state, pts):
    tprep = interop.prepared(prep, device="cpu")
    ones = torch.ones(tprep.tair.shape, dtype=torch.float32)
    obs = torch.tensor(np.asarray(pts.coupling_tsurf, np.float32))
    tmp0, scal0 = sk.pack_state(interop.state(state, device="cpu"))
    return tmp0, scal0, sk.pack_forcing(tprep, ones, ones, obs)


def _assert_close(out, want_out, tmp=None, want_tmp=None, rows=slice(None)):
    np.testing.assert_allclose(np.asarray(out)[rows, 0],
                               np.asarray(want_out)[rows, 0],
                               rtol=2e-5, atol=2e-4, err_msg="tsurf")
    for name, k in FIELDS:
        np.testing.assert_allclose(np.asarray(out)[rows, k],
                                   np.asarray(want_out)[rows, k],
                                   rtol=2e-5, atol=2e-3, err_msg=name)
    if tmp is not None:
        np.testing.assert_allclose(np.asarray(tmp), np.asarray(want_tmp),
                                   rtol=2e-5, atol=2e-4, err_msg="tmp")


def test_port_packing_matches_jax():
    model, tm, pts, prep, state = _inputs(npoints=256, sim_len=32)
    jt, js, jf = _jax_packed(prep, state, pts)
    tt, ts, tf = _port_packed(prep, state, pts)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # C_EAIR / C_AIRVCAP pass through exp and divides: float32 round-off
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=0)
    back = sk.unpack_state(tt, ts, model.settings.nlayers,
                           interop.state(state, device="cpu"))
    for name in back._fields:
        np.testing.assert_array_equal(interop.to_numpy(getattr(back, name)),
                                      np.asarray(getattr(state, name)),
                                      err_msg=name)


@pytest.mark.parametrize("scenario,out_stride", [
    ("winter_mix", 1), ("cold_snow", 1), ("winter_mix", 4)])
def test_reference_matches_pallas(scenario, out_stride):
    model, tm, pts, prep, state = _inputs(scenario)
    jt, js, jout = ps.pallas_scan(*_jax_packed(prep, state, pts), model.cfg,
                                  model.params, model.grid,
                                  out_stride=out_stride, chunk_t=64,
                                  interpret=True)
    tt, ts, tout = sk.scan_reference(*_port_packed(prep, state, pts),
                                     tm.cfg, tm.params, tm.grid,
                                     out_stride=out_stride)
    assert tout.shape == jout.shape
    _assert_close(tout, jout, tt, jt)
    assert np.array_equal(ts.numpy()[sk.R_FAILED], np.asarray(js)[ps.R_FAILED])


def test_reference_offset_and_partial_chunk():
    """A chunk of a streamed run: global offset 5, stride 4, 100 of 128
    steps, with its explicit row count; both kernels take the very same
    packed arrays (the JAX side's, carried over by interop.packed)."""
    off, stride, nsteps = 5, 4, 100
    n_out = len(range(-(-off // stride) * stride, off + nsteps, stride))
    model, tm, pts, prep, state = _inputs()
    packed = _jax_packed(prep, state, pts)
    kw = dict(out_stride=stride, nsteps=nsteps, out_offset=off, n_out=n_out)
    jt, js, jout = ps.pallas_scan(*packed, model.cfg, model.params,
                                  model.grid, chunk_t=64, interpret=True,
                                  **kw)
    tt, ts, tout = sk.scan_reference(*interop.packed(*packed, device="cpu"), tm.cfg,
                                     tm.params, tm.grid, **kw)
    assert tout.shape == (n_out, sk.N_OUT_FIELDS, 1024)
    _assert_close(tout, jout, tt, jt)
    assert np.array_equal(ts.numpy()[sk.R_FAILED], np.asarray(js)[ps.R_FAILED])


@pytest.mark.parametrize("combo", KERNEL_CASES, ids=CASE_IDS)
def test_reference_matches_port_scan(combo):
    """Kernel formulation vs the port's step-by-step scan, float32, for
    every physics flag (the port's side of the lockstep tripwire) and a
    layer count above 16."""
    model, tm, pts, prep, state = _inputs(sim_len=96, npoints=256, seed=31,
                                          **combo)
    tprep = interop.prepared(prep, device="cpu")
    tstate = interop.state(state, device="cpu")
    ones = torch.ones(tprep.tair.shape, dtype=torch.float32)
    obs = torch.tensor(np.asarray(pts.coupling_tsurf, np.float32))
    final, out = tmodel.scan_steps(tstate, tprep, ones, ones, obs, tm.cfg,
                                   tm.grid, tm.params)
    tt, ts, tout = sk.scan_reference(*_port_packed(prep, state, pts),
                                     tm.cfg, tm.params, tm.grid)
    want = torch.stack([out.tsurf, out.wat, out.snow, out.ice, out.ice2,
                        out.dep], dim=1)
    _assert_close(tout[:, :6], want, tt[:tm.settings.nlayers + 2],
                  final.tmp.T)


def test_dispatch_and_wrapper_checks():
    model, tm, pts, prep, state = _inputs(npoints=128, sim_len=16)
    packed = _port_packed(prep, state, pts)
    before = sk.LAUNCHES
    a = sk.scan(*packed, tm.cfg, tm.params, tm.grid, out_stride=4)
    b = sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid, out_stride=4)
    assert sk.LAUNCHES == before            # CPU tensors: the plain version
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        sk.scan_cuda(*packed, tm.cfg, tm.params, tm.grid)
    with pytest.raises(ValueError):
        sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid,
                          out_offset=3)     # n_out is required with it


def test_ptxas_usage_parses_log():
    log = (
        "ptxas info    : Compiling entry function '_Z4kernILi16ELb1EEv' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4kernILi16ELb1EEv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 64 registers, 796 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z4kernILi16ELb0EEv' "
        "for 'sm_90a'\n"
        "ptxas info    : Used 60 registers, 796 bytes cmem[0]\n")
    assert build.ptxas_usage(log) == [
        ("_Z4kernILi16ELb1EEv", 64, 8, 4, 8),
        ("_Z4kernILi16ELb0EEv", 60, 0, 0, 0)]


SASS_LISTING = """
\tcode for sm_90a
\t\tFunction : _Z11scan_kernelILi16ELb0ELb1EEv10ScanConsts
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;       /* 0x0000000000007919 */
.L_x_3:
        /*0020*/                   MUFU.RCP R3, R2 ;
        /*0030*/                   FCHK P0, R4, R2 ;
        /*0040*/               @P0 CALL.REL.NOINC `(__internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath) ;
.L_x_4:
        /*0050*/                   MUFU.LG2 R5, R5 ;
        /*0060*/                   MUFU.RSQ R6, R7 ;
        /*0070*/              @!P1 BRA `(.L_x_4) ;
        /*0080*/                   NOP ;
        /*0090*/               @P2 BRA 0x20 ;
        /*00a0*/                   EXIT ;
.L_x_9:
        /*00b0*/                   BRA `(.L_x_9);
\t\tFunction : _Z4tinyv
        /*0000*/                   EXIT ;
"""


def test_sass_stats_parses_listing():
    """Instructions, the watched opcode families and the loops (backward
    branches, by label or by address) of a cuobjdump -sass listing; NOPs
    and a branch to itself are left out."""
    got = sass.sass_stats(SASS_LISTING)
    assert set(got) == {"_Z11scan_kernelILi16ELb0ELb1EEv10ScanConsts",
                        "_Z4tinyv"}
    k = got["_Z11scan_kernelILi16ELb0ELb1EEv10ScanConsts"]
    assert k["instructions"] == 11
    assert k["opcodes"] == {"BRA": 3, "CALL": 1, "FCHK": 1, "MUFU": 3,
                            "MUFU.LG2": 1, "MUFU.RCP": 1, "MUFU.RSQ": 1}
    inner, outer = k["loops"]
    assert (inner["start"], inner["end"], inner["instructions"]) == (
        0x50, 0x70, 3)
    assert inner["opcodes"] == {"BRA": 1, "MUFU": 2, "MUFU.LG2": 1,
                                "MUFU.RSQ": 1}
    assert (outer["start"], outer["end"], outer["instructions"]) == (
        0x20, 0x90, 7)
    assert got["_Z4tinyv"] == {"instructions": 1, "opcodes": {},
                               "loops": []}


def test_warp_iterations_of_lane_counts():
    """A warp issues its slowest lane's iterations for all 32 lanes; a
    ragged last warp's idle lanes cost the same slots."""
    lane = torch.full((70,), 5, dtype=torch.int64)
    lane[7] = 12                      # warp 0: 32 x 12
    lane[32:64] = 7                   # warp 1: 32 x 7
    lane[64:] = torch.tensor([5, 5, 9, 0, 5, 5])   # warp 2: 32 x 9
    assert int(sk._warp_iters(lane)) == 32 * (12 + 7 + 9)
    assert int(sk._warp_iters(torch.zeros(0, dtype=torch.int64))) == 0


def test_reference_counts_warp_iterations():
    """``stats`` of scan_reference on copies of one point: 64 copies keep
    every warp coherent (warp iterations = lane iterations); 40 copies fill
    one warp and 8 of 32 lanes of another (the warps issue 64 / 40 of the
    lane iterations); a point failed from the start runs no step and
    issues nothing, but its warp still runs the loop for its other lanes."""
    (tmp0, scal0, forc), _, geo, tm = _tm_case("k1", False, npoints=128,
                                               nsteps=24)
    rest = (tm.cfg, tm.params, tm.grid)

    def stats_of(n, failed=()):
        idx = torch.zeros(n, dtype=torch.int64)
        sc = scal0[:, idx].clone()
        sc[sk.R_FAILED, list(failed)] = 1.0
        st = {}
        sk.scan_reference(tmp0[:, idx], sc, forc[:, :, idx], *rest,
                          stats=st, **geo)
        return st

    one = stats_of(1)
    assert one["point_steps"] == 24
    assert one["bl_warp_iters"] == 32 * one["bl_iters"]
    s64 = stats_of(64)
    assert s64["bl_iters"] == 64 * one["bl_iters"]
    assert s64["bl_warp_iters"] == s64["bl_iters"]
    s40 = stats_of(40)
    assert s40["bl_warp_iters"] == 64 * one["bl_iters"]
    s_failed = stats_of(64, failed=(3,))
    assert s_failed["point_steps"] == 63 * 24
    assert s_failed["bl_iters"] == 63 * one["bl_iters"]
    assert s_failed["bl_warp_iters"] == 64 * one["bl_iters"]


@pytest.mark.cuda
@pytest.mark.parametrize("combo", KERNEL_CASES, ids=CASE_IDS)
def test_kernel_matches_reference_on_cuda(combo):
    """Every template instantiation and physics branch of the kernel
    against scan_reference.  The padded profile rows hold NaN: the kernel
    must not let them reach any result the plain version does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    model, tm, pts, prep, state = _inputs(npoints=4096, **combo)
    packed = [x.cuda() for x in _port_packed(prep, state, pts)]
    packed[0][tm.settings.nlayers + 2:] = float("nan")
    for kw in (dict(out_stride=1),
               dict(out_stride=4, nsteps=100, out_offset=5, n_out=25)):
        before = sk.LAUNCHES
        got = sk.scan(*packed, tm.cfg, tm.params, tm.grid, **kw)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == before + 1
        want = sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid, **kw)
        _assert_close(got[2].cpu(), want[2].cpu(), got[0].cpu(),
                      want[0].cpu())
        assert torch.equal(got[1][sk.R_FAILED], want[1][sk.R_FAILED])


# ---------------------------------------------------------------------------
# K2: the slim mode (11 channels, time-only TRF, aux rows, in-kernel decay)
# ---------------------------------------------------------------------------

def _slim_case(npoints=1024, sim_len=128, off=0, nsteps=None, seed=5):
    """A slim chunk at global offset ``off`` of a run that ends with its
    step ``nsteps``: (JAX-side model, port model, pts, prep, state), the
    run length, and the aux inputs of the decay (windows ending before and
    inside the chunk, one at the run's last step, some points with none).
    """
    model, tm, pts, prep, state = _inputs(npoints=npoints, sim_len=sim_len)
    nsteps = nsteps or sim_len
    t_total = off + nsteps
    rng = np.random.default_rng(seed)
    cend = rng.integers(max(off - 20, 1), t_total, npoints).astype(np.float32)
    cend[::9] = -99.0
    cend[1::9] = t_total - 1
    sw = rng.uniform(-0.4, 0.6, npoints).astype(np.float32)
    lw = rng.uniform(-0.4, 0.6, npoints).astype(np.float32)
    obs = rng.uniform(-3.0, 1.0, npoints).astype(np.float32)
    return (model, tm, pts, prep, state, t_total,
            {"cend": cend, "sw": sw, "lw": lw, "obs": obs})


def _port_slim(tm, prep, state, aux, off, t_total, cofs):
    """(tmp0, scal0, forcing [T, 11, P]) and the slim keyword arguments."""
    tprep = interop.prepared(prep, device="cpu")
    forc, trf = sk.pack_forcing_slim(tprep)
    trf_g = torch.zeros(off + trf.shape[0], dtype=torch.float32)
    trf_g[off:] = trf                      # indexed by the global step
    t = lambda k: torch.tensor(aux[k])
    rows = (sk.pack_aux(t("obs"), t("sw"), t("lw"), t("cend")) if cofs
            else sk.pack_aux(t("obs")))
    tmp0, scal0 = sk.pack_state(interop.state(state, device="cpu"))
    kw = dict(slim_trf=trf_g, aux_rows=rows)
    if cofs:
        kw.update(aux_cofs=True, t_total=t_total,
                  cof_red=tm.settings.coupling_effect_reduction)
    return (tmp0, scal0, forc), kw


def _k1_forcing(forc, trf_rows, swc, lwc, obs):
    """K1's 16-channel packing of the very same slim forcing (so both modes
    read identical inputs wherever the packing was computed), with the
    given coefficient rows and coupling obs."""
    T, _, P = forc.shape
    out = torch.zeros((T, sk.NCH, P), dtype=torch.float32, device=forc.device)
    out[:, list(sk.SLIM_CHANNELS)] = forc
    out[:, sk.C_TRF] = trf_rows[:, None]
    out[:, sk.C_SWCOF] = swc
    out[:, sk.C_LWCOF] = lwc
    out[:, sk.C_CPLOBS] = obs[None, :]
    return out


def _decay_rows(kw, off, T, t_total, settings):
    """forcing.cof_window rows of the chunk from K2's aux rows, computed
    on their device."""
    aux = kw["aux_rows"]
    return tforcing.cof_window(aux[sk.A_SWCORR], aux[sk.A_LWCORR],
                               aux[sk.A_CEND].to(torch.int32), off, T,
                               t_total, settings, torch.float32)


def _geometry(off, nsteps, stride):
    n_out = len(range(-(-off // stride) * stride, off + nsteps, stride))
    return dict(out_stride=stride, nsteps=nsteps, out_offset=off,
                n_out=n_out)


@pytest.mark.parametrize("cofs", [False, True], ids=["plain", "cofs"])
def test_reference_slim_matches_pallas(cofs):
    """scan_reference in slim mode against the JAX kernel's slim tile-major
    mode (one 1024-point tile), at global offset 40 with 100 of 128 steps:
    the chunk holds window ends and the run's last step."""
    off, nsteps, stride = 40, 100, 4
    model, tm, pts, prep, state, t_total, aux = _slim_case(off=off,
                                                           nsteps=nsteps)
    packed, kw = _port_slim(tm, prep, state, aux, off, t_total, cofs)
    geo = _geometry(off, nsteps, stride)
    tt, ts, tout = sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid,
                                     **geo, **kw)
    tmp0, scal0, forc = (np.asarray(x.numpy()) for x in packed)
    T = forc.shape[0]
    forc_tm = forc.reshape(T, sk.NCH_SLIM, 1, 8, ps.LANE).transpose(
        2, 0, 1, 3, 4)                      # [n_tiles, T, 11, subl, LANE]
    jkw = dict(slim_trf=jnp.asarray(kw["slim_trf"].numpy()),
               aux_rows=jnp.asarray(kw["aux_rows"].numpy()),
               aux_cofs=cofs)
    if cofs:
        jkw.update(t_total=t_total, cof_red=kw["cof_red"])
    jt, js, jout = ps.pallas_scan(jnp.asarray(tmp0), jnp.asarray(scal0),
                                  jnp.asarray(forc_tm), model.cfg,
                                  model.params, model.grid, chunk_t=64,
                                  interpret=True, **geo, **jkw)
    assert tout.shape == jout.shape
    _assert_close(tout, jout, tt, jt)
    assert np.array_equal(ts.numpy()[sk.R_FAILED], np.asarray(js)[ps.R_FAILED])


@pytest.mark.parametrize("cofs", [False, True], ids=["plain", "cofs"])
def test_reference_slim_equals_packed_bitwise(cofs):
    """K2's plain version equals K1's on the same data, bit for bit: without
    cofs against the 16-channel packing with ones, with cofs against K1
    fed forcing.cof_window's rows (the run's last step included)."""
    off, nsteps, stride = 40, 100, 4
    model, tm, pts, prep, state, t_total, aux = _slim_case(
        npoints=256, off=off, nsteps=nsteps)
    packed, kw = _port_slim(tm, prep, state, aux, off, t_total, cofs)
    geo = _geometry(off, nsteps, stride)
    got = sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid, **geo, **kw)
    forc = packed[2]
    T = forc.shape[0]
    if cofs:
        swc, lwc = _decay_rows(kw, off, T, t_total, tm.settings)
    else:
        swc = lwc = torch.ones((T, forc.shape[2]), dtype=torch.float32)
    k1 = _k1_forcing(forc, kw["slim_trf"][off:], swc, lwc,
                     kw["aux_rows"][sk.A_CPLOBS])
    # the 16-channel packing of the same prep, as production builds it
    tprep = interop.prepared(prep, device="cpu")._replace(trf_fric=kw["slim_trf"][off:])
    assert torch.equal(k1, sk.pack_forcing(tprep, swc, lwc,
                                           kw["aux_rows"][sk.A_CPLOBS]))
    want = sk.scan_reference(packed[0], packed[1], k1, tm.cfg, tm.params,
                             tm.grid, **geo)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_slim_wrapper_checks():
    model, tm, pts, prep, state, t_total, aux = _slim_case(npoints=128,
                                                           sim_len=16)
    packed, kw = _port_slim(tm, prep, state, aux, 0, t_total, True)
    before = (sk.LAUNCHES, sk.LAUNCHES_SLIM)
    a = sk.scan(*packed, tm.cfg, tm.params, tm.grid, **kw)
    b = sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid, **kw)
    assert (sk.LAUNCHES, sk.LAUNCHES_SLIM) == before   # CPU: plain version
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        sk.scan_cuda(*packed, tm.cfg, tm.params, tm.grid, **kw)
    with pytest.raises(ValueError):                     # no t_total
        sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid,
                          slim_trf=kw["slim_trf"], aux_rows=kw["aux_rows"],
                          aux_cofs=True)
    with pytest.raises(ValueError):                     # TRF too short
        sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid,
                          slim_trf=kw["slim_trf"][:8],
                          aux_rows=kw["aux_rows"])
    with pytest.raises(ValueError):                     # K1 forcing
        sk.scan_reference(packed[0], packed[1],
                          torch.zeros(16, sk.NCH, 128), tm.cfg, tm.params,
                          tm.grid, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cofs", [False, True], ids=["plain", "cofs"])
def test_slim_kernel_matches_reference_on_cuda(cofs):
    """K2 against its plain version on the card, and with cofs against K1
    fed forcing.cof_window's rows computed on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    off, nsteps, stride = 40, 100, 4
    model, tm, pts, prep, state, t_total, aux = _slim_case(
        npoints=4096, off=off, nsteps=nsteps)
    packed, kw = _port_slim(tm, prep, state, aux, off, t_total, cofs)
    packed = [x.cuda() for x in packed]
    kw = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    geo = _geometry(off, nsteps, stride)
    before = sk.LAUNCHES_SLIM
    got = sk.scan(*packed, tm.cfg, tm.params, tm.grid, **geo, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES_SLIM == before + 1
    want = sk.scan_reference(*packed, tm.cfg, tm.params, tm.grid, **geo,
                             **kw)
    _assert_close(got[2].cpu(), want[2].cpu(), got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1][sk.R_FAILED], want[1][sk.R_FAILED])
    if cofs:
        # the decay rows from torch on the card, the same packed inputs
        forc = packed[2]
        swc, lwc = _decay_rows(kw, off, forc.shape[0], t_total, tm.settings)
        k1 = sk.scan(packed[0], packed[1],
                     _k1_forcing(forc, kw["slim_trf"][off:], swc, lwc,
                                 kw["aux_rows"][sk.A_CPLOBS]),
                     tm.cfg, tm.params, tm.grid, **geo)
        for g, w in zip(got, k1):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


# ---------------------------------------------------------------------------
# K3: the tile-major forcing layout [P / TP, T, nch, TP], either channel set
# ---------------------------------------------------------------------------

# (channel set, in-kernel decay): K1's 16 channels, K2's 11 without and
# with the decay
TM_MODES = [("k1", False), ("k2", False), ("k2", True)]
TM_IDS = ["k1", "k2", "k2-cofs"]


def _tm_case(mode, cofs, npoints=1024, off=40, nsteps=100, stride=4):
    """The slim chunk of ``_slim_case`` (offset 40, 100 of 128 steps, the
    run's last step inside) as (packed point-major args, slim keyword
    arguments, output geometry, port model); K1's forcing is the
    16-channel packing of the same values with ones coefficients."""
    model, tm, pts, prep, state, t_total, aux = _slim_case(
        npoints=npoints, off=off, nsteps=nsteps)
    packed, kw = _port_slim(tm, prep, state, aux, off, t_total, cofs)
    if mode == "k1":
        T, _, P = packed[2].shape
        ones = torch.ones((T, P), dtype=torch.float32)
        packed = (packed[0], packed[1],
                  _k1_forcing(packed[2], kw["slim_trf"][off:], ones, ones,
                              kw["aux_rows"][sk.A_CPLOBS]))
        kw = {}
    return packed, kw, _geometry(off, nsteps, stride), tm


@pytest.mark.parametrize("tp", [128, 256])
@pytest.mark.parametrize("mode,cofs", TM_MODES, ids=TM_IDS)
def test_reference_tile_major_equals_point_major(mode, cofs, tp):
    """scan_reference on the tile-major forcing equals the point-major
    call bit for bit, for both channel sets, with and without the decay,
    on an offset chunk with nsteps < T that holds the run's last step."""
    (tmp0, scal0, forc), kw, geo, tm = _tm_case(mode, cofs)
    want = sk.scan_reference(tmp0, scal0, forc, tm.cfg, tm.params, tm.grid,
                             **geo, **kw)
    f4 = sk.to_tile_major(forc, tp)
    assert f4.shape == (1024 // tp, forc.shape[0], forc.shape[1], tp)
    assert torch.equal(sk.to_point_major(f4), forc)
    got = sk.scan_reference(tmp0, scal0, f4, tm.cfg, tm.params, tm.grid,
                            **geo, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_reference_tile_major_matches_pallas():
    """The port's 16-channel tile-major scan_reference against the JAX
    kernel fed the 5-D tile-major forcing [n_tiles, T, NCH, subl, LANE]
    (pallas_step.py:387-398), an offset chunk with nsteps < T."""
    (tmp0, scal0, forc), _, geo, tm = _tm_case("k1", False)
    model = Model(ModelSettings(sim_len=128, dt=30.0))
    tp = 256
    f4 = sk.to_tile_major(forc, tp)
    tt, ts, tout = sk.scan_reference(tmp0, scal0, f4, tm.cfg, tm.params,
                                     tm.grid, **geo)
    T = forc.shape[0]
    f5 = f4.numpy().reshape(1024 // tp, T, sk.NCH, tp // ps.LANE, ps.LANE)
    jt, js, jout = ps.pallas_scan(jnp.asarray(tmp0.numpy()),
                                  jnp.asarray(scal0.numpy()),
                                  jnp.asarray(f5), model.cfg, model.params,
                                  model.grid, chunk_t=64, interpret=True,
                                  **geo)
    assert tout.shape == jout.shape
    _assert_close(tout, jout, tt, jt)
    assert np.array_equal(ts.numpy()[sk.R_FAILED], np.asarray(js)[ps.R_FAILED])


def test_pack_forcing_tile_major():
    """pack_forcing_tm / pack_forcing_slim_tm of a tile-layout Prepared
    equal the point-major packings laid out per tile."""
    model, tm, pts, prep, state = _inputs(npoints=512, sim_len=32)
    tprep = interop.prepared(prep, device="cpu")
    nt, tp = 2, 256
    tile = lambda x: x.reshape(x.shape[0], nt, tp).transpose(0, 1)
    tprep_tm = tprep._replace(**{n: tile(getattr(tprep, n))
                                 for n in tprep._fields if n != "trf_fric"})
    T, P = tprep.tair.shape
    swc = torch.tensor(np.random.default_rng(3).uniform(0.5, 1.5, (T, P)),
                       dtype=torch.float32)
    obs = torch.tensor(np.asarray(pts.coupling_tsurf, np.float32))
    want = sk.pack_forcing(tprep, swc, 1.0, obs)
    got = sk.pack_forcing_tm(tprep_tm, tile(swc), 1.0, obs.reshape(nt, tp))
    assert torch.equal(got, sk.to_tile_major(want, tp))
    slim, trf = sk.pack_forcing_slim(tprep)
    slim_tm, trf_tm = sk.pack_forcing_slim_tm(tprep_tm)
    assert torch.equal(slim_tm, sk.to_tile_major(slim, tp))
    assert torch.equal(trf_tm, trf)


def test_tile_major_wrapper_checks():
    (tmp0, scal0, forc), kw, geo, tm = _tm_case("k2", True, npoints=256,
                                                nsteps=24)
    f4 = sk.to_tile_major(forc, 128)
    before = (sk.LAUNCHES, sk.LAUNCHES_SLIM, sk.LAUNCHES_TM)
    stats = {}
    sk.scan(tmp0, scal0, f4, tm.cfg, tm.params, tm.grid, **geo, **kw)
    sk.scan_reference(tmp0, scal0, f4, tm.cfg, tm.params, tm.grid,
                      stats=stats, **geo, **kw)
    assert (sk.LAUNCHES, sk.LAUNCHES_SLIM, sk.LAUNCHES_TM) == before
    # the work these inputs need: every point runs every step, and the
    # boundary-layer loop takes 5 to bl_max_iter iterations a step
    assert stats["point_steps"] == 256 * 24
    assert (5 * stats["point_steps"] <= stats["bl_iters"]
            <= tm.cfg.bl_max_iter * stats["point_steps"])
    with pytest.raises(ValueError):
        sk.scan_cuda(tmp0, scal0, f4, tm.cfg, tm.params, tm.grid, **geo,
                     **kw)
    bad = forc.reshape(forc.shape[0], forc.shape[1], 4, 64).permute(
        2, 0, 1, 3).contiguous()                 # TP = 64: not a lane width
    with pytest.raises(ValueError):
        sk.scan_reference(tmp0, scal0, bad, tm.cfg, tm.params, tm.grid,
                          **geo, **kw)
    with pytest.raises(ValueError):              # 16-channel layout, slim
        sk.scan_reference(tmp0, scal0, torch.zeros(2, 128, sk.NCH, 128),
                          tm.cfg, tm.params, tm.grid, **geo, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [128, 1024])
@pytest.mark.parametrize("mode,cofs", TM_MODES, ids=TM_IDS)
def test_tile_major_kernel_on_cuda(mode, cofs, tp):
    """K3 on the card against its plain version at the kernel tolerances
    with equal failed masks, and against K1 / K2 on the same values, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    packed, kw, geo, tm = _tm_case(mode, cofs, npoints=4096)
    tmp0, scal0, forc = (x.cuda() for x in packed)
    kw = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    args = (tm.cfg, tm.params, tm.grid)
    f4 = sk.to_tile_major(forc, tp)
    before = sk.LAUNCHES_TM
    got = sk.scan(tmp0, scal0, f4, *args, **geo, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES_TM == before + 1
    want = sk.scan_reference(tmp0, scal0, f4, *args, **geo, **kw)
    _assert_close(got[2].cpu(), want[2].cpu(), got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1][sk.R_FAILED], want[1][sk.R_FAILED])
    pm = sk.scan(tmp0, scal0, forc, *args, **geo, **kw)
    for g, w in zip(got, pm):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_storage_runout_rounding_decides_the_melt():
    """Storage.f90's run-out event on one point-step (phase 3c of
    chip_smoke.py, the stations by day): the step's melt heat Q2Melt was
    computed from the snow itself (q2n = heat * snow / 1000 / dt), so snow
    - mm is a rounding remainder.  With true division (torch on the CPU; the
    JAX package) +3.7e-9 remains, the snow wear turns it into ice, and that
    ice melts with the same mm: the water takes the melt twice, in both
    packages.  Divided as torch divides by a Python scalar on the card (a
    multiply by the float32 reciprocal), q2n is one ulp larger, nothing
    remains and the water takes it once.  So the kernel rounds each
    operation as torch does on the card (csrc/scan_kernel.cu, Numerics)."""
    settings = ModelSettings(sim_len=8, dt=30.0)
    model = Model(settings)
    tm = tmodel.Model(interop.settings(settings), device="cpu")
    f32 = np.float32
    heat = f32(model.params.wat_m_heat * model.params.wat_dens)
    snow = f32(0.054304391)
    q2_div = heat * (snow / f32(1000.0)) / f32(30.0)
    q2_rcp = heat * (snow * (f32(1.0) / f32(1000.0))) * (f32(1.0) / f32(30.0))
    assert q2_rcp > q2_div
    runs = {}
    for q2 in (q2_div, q2_rcp):
        vals = (0.0, snow, 0.0, 0.0, 0.0, 0.3249589, 0.0, q2, 0.25)
        got = sk._road_cond(*(torch.tensor([v], dtype=torch.float32)
                              for v in vals), torch.tensor([False]),
                            tm.cfg, tm.params)
        mm = f32(1000.0) * (q2 * f32(30.0)) / heat
        assert float(got[1][0]) == 0.0
        runs[q2 == q2_div] = (float(got[0][0]), float(mm))
        if q2 == q2_div:
            want = ps._road_cond(*(jnp.asarray([v], jnp.float32)
                                   for v in vals), jnp.asarray([False]),
                                 model.cfg, model.params)
            assert float(np.asarray(want[0])[0]) == float(got[0][0])
    wat, mm = runs[True]
    assert wat == float(f32(mm) + f32(mm))      # the melt, twice
    wat, mm = runs[False]
    assert wat == mm                             # once


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [None, 16])
@pytest.mark.parametrize("nlayers", [15, 20])
def test_fused_kernel_at_any_span_on_cuda(nlayers, stage, monkeypatch):
    """K3 fused on the card at SPAN above the stage width (the sub-hourly
    grid of tests/test_torch_fused_span.py: its chunks' steps cross from
    the first stage of segment lines to the next), at 15 and 20 layers
    (the <16> and <32> instantiations) and two widths (the rule's, and
    16), against its plain version on every chunk of the run, bit for bit:
    profile, state and the output rows the chunk writes; at the rule's
    width the blocks an SM are what the registers allow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from roadsurf_tpu_torch import production as tprod
    from test_torch_fused_span import CHUNK, port_engine, span_case
    dev = torch.device("cuda", 0)
    tm, exp, pts, cal, st = port_engine(
        span_case(nlayers=nlayers, device=dev), device=dev)
    eng = tprod._Engine(tm, exp, pts, cal, st, chunk_t=CHUNK)
    assert eng.fused
    if stage:
        monkeypatch.setattr(sk, "stage_width", lambda *a: stage)
    args = (eng.tmp0, eng.scal0)
    rest = (eng.cfg, eng.params, eng.grid)
    for t0 in range(0, tm.settings.sim_len, CHUNK):
        nsteps = min(CHUNK, tm.settings.sim_len - t0)
        src, kw = eng.kernel_inputs(t0)
        assert sk.fuse_args(src, dev).span == exp.SPAN
        geo = eng.scan_kwargs(t0, nsteps)
        got = sk.scan_cuda_fused(*args, src, *rest, **geo, **kw)
        f = sk.LAST_LAUNCH["K3 fused"]
        assert exp.SPAN > f.stage == (stage or f.stage)
        assert stage or f.blocks == f.blocks_regs, f
        want = sk.scan_fused_reference(*args, src, *rest, **geo, **kw)
        torch.cuda.synchronize()
        k = len(range(-(-t0 // eng.os_) * eng.os_, t0 + nsteps, eng.os_))
        for g, w in ((got[0], want[0]), (got[1], want[1]),
                     (got[2][:k, :6], want[2][:k, :6])):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        args = (got[0], got[1])
