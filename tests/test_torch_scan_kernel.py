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
from roadsurf_tpu_torch import interop
from roadsurf_tpu_torch import model as tmodel
from roadsurf_tpu_torch.ops import build
from roadsurf_tpu_torch.ops import scan_kernel as sk

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
    tm = tmodel.Model(interop.settings(settings))
    return model, tm, pts, prep, state


def _jax_packed(prep, state, pts):
    ones = jnp.ones(prep.tair.shape, jnp.float32)
    obs = jnp.asarray(pts.coupling_tsurf, jnp.float32)
    tmp0, scal0 = ps.pack_state(state)
    return tmp0, scal0, ps.pack_forcing(prep, ones, ones, obs)


def _port_packed(prep, state, pts):
    tprep = interop.prepared(prep)
    ones = torch.ones(tprep.tair.shape, dtype=torch.float32)
    obs = torch.tensor(np.asarray(pts.coupling_tsurf, np.float32))
    tmp0, scal0 = sk.pack_state(interop.state(state))
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
                           interop.state(state))
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
    tt, ts, tout = sk.scan_reference(*interop.packed(*packed), tm.cfg,
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
    tprep = interop.prepared(prep)
    tstate = interop.state(state)
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
