"""Frozen copy of ``roadsurf_tpu_torch/model.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Simulation loops: the eager time loop and the model facade.

The counterpart of ``roadsurf_tpu/model.py``.  ``scan_steps`` runs the full
trajectory as one Python loop over prepared forcing -- the batched equivalent
of the reference's per-point Fortran ``do while``
(examples/example1/src/Simulation.f90:58-95), all points at once.  It is
the plain torch path; the production engine runs the hand-written CUDA scan
kernel (``ops/scan_kernel.py``) instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams
from .forcing import Calendar, Prepared, RawForcing, prepare
from .grid import LayerGrid, depth_interp_coeffs, depth_interp_coeffs_vec, \
    make_grid
from .state import PointParams, State, init_state
from .step import StepConfig, StepForcing, step, step_output


class SimOutput(NamedTuple):
    """Trajectories, time-major [T, P]."""
    tsurf: torch.Tensor
    wat: torch.Tensor
    snow: torch.Tensor
    ice: torch.Tensor
    ice2: torch.Tensor
    dep: torch.Tensor


def _depth_config(settings: ModelSettings, grid: LayerGrid) -> StepConfig:
    use_depth = settings.tsurf_output_depth >= 0.0
    if use_depth:
        idx, w = depth_interp_coeffs(grid, settings.tsurf_output_depth)
        # python scalars: a numpy float64 weight would promote a float32
        # state through surface_average (model.py:38-41)
        idx, w = int(idx), float(w)
    else:
        idx, w = 1, 0.0
    return StepConfig.from_settings(settings, depth_idx=idx, depth_w=w,
                                    use_depth=use_depth)


def scan_steps(state: State, prep: Prepared, sw_cof, lw_cof, coupling_tsurf,
               cfg: StepConfig, grid: LayerGrid, p: PhysicsParams,
               depth=None):
    """Loop the step over the time axis of ``prep``.

    sw_cof/lw_cof: [T, P] radiation-coefficient schedules (ones when
    uncoupled).  Returns (final_state, SimOutput).
    """
    dtype, dev = state.tmp.dtype, state.tmp.device
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    dyc, cond_dz, wcont = as_t(grid.dyc), as_t(grid.cond_dz), as_t(grid.wcont)

    outs = []
    for t in range(prep.tair.shape[0]):
        f = StepForcing(prep.tair[t], prep.vz[t], prep.rhz[t], prep.rain[t],
                        prep.snow[t], prep.sw[t], prep.lw[t],
                        prep.tsurf_obs[t], prep.valid[t],
                        prep.in_coupling[t], prep.trf_fric[t], sw_cof[t],
                        lw_cof[t])
        new = step(state, f, coupling_tsurf, cfg, dyc, cond_dz, wcont, p,
                   depth=depth)
        outs.append(step_output(new, state.failed))
        state = new
    return state, SimOutput(*(torch.stack(x) for x in zip(*outs)))


class Model:
    """Facade tying config, grid, forcing prep and the scan together.

    Host inputs (numpy ``RawForcing``/``PointParams``) are placed on
    ``device``, the card unless the caller asks for the CPU; the float
    dtype of a run is the dtype of ``raw.tair``."""

    def __init__(self, settings: ModelSettings,
                 params: Optional[PhysicsParams] = None, device="cuda"):
        self.settings = settings
        self.params = (params or PhysicsParams()).derive(settings.dt)
        self.grid = make_grid(self.params, settings.nlayers)
        self.cfg = _depth_config(settings, self.grid)
        self.device = torch.device(device)

    def _put(self, x, dtype=None):
        t = (x.to(self.device) if isinstance(x, torch.Tensor)
             else torch.tensor(np.asarray(x), device=self.device))
        return t.to(dtype) if dtype is not None else t

    def raw_tensors(self, raw: RawForcing) -> RawForcing:
        return RawForcing(*(self._put(x) for x in raw))

    def point_tensors(self, pts: PointParams) -> PointParams:
        return PointParams(*(self._put(x) for x in pts))

    def prepare(self, raw: RawForcing, pts: PointParams, cal: Calendar
                ) -> Prepared:
        return prepare(self.raw_tensors(raw), self.point_tensors(pts), cal,
                       self.settings, self.params)

    def depth_arrays(self, pts: PointParams, dtype=torch.float64):
        """Per-point output-depth gather tensors, or None.  The global
        settings.tsurf_output_depth wins when set (InputOutput.f90:125-130);
        otherwise per-point depths come from pts.out_depth (ex2's
        modelInput%depth)."""
        if self.cfg.use_depth:
            return None
        od = pts.out_depth
        od = (od.detach().cpu().numpy() if isinstance(od, torch.Tensor)
              else np.asarray(od))
        if od.ndim == 0 or od.shape[0] == 0 or not np.any(od >= 0.0):
            return None
        idx, w, use = depth_interp_coeffs_vec(self.grid, od)
        return (self._put(idx), self._put(w, dtype), self._put(use))

    def init(self, raw: RawForcing, cal: Calendar, dtype=None,
             pts: Optional[PointParams] = None) -> State:
        """Initial state from the first forcing step (``raw`` leaves may be
        [P, T] or just [P, 1])."""
        date0 = (int(cal.year[0]), int(cal.month[0]), int(cal.day[0]))
        dtype = dtype or self._put(raw.tair).dtype
        depth = self.depth_arrays(pts, dtype) if pts is not None else None
        didx, dw, duse = depth if depth is not None else (
            self.cfg.depth_idx, self.cfg.depth_w, self.cfg.use_depth)
        first = lambda x: self._put(x, dtype)[..., 0]
        return init_state(self.settings, self.params, self.grid,
                          first(raw.tair), first(raw.vz), first(raw.rhz),
                          first(raw.tsurf_obs), date0,
                          depth_idx=didx, depth_w=dw, use_depth=duse)

    def run(self, raw: RawForcing, pts: PointParams, cal: Calendar):
        """Uncoupled batched simulation (model.py:132-142)."""
        pts_t = self.point_tensors(pts)
        prep = prepare(self.raw_tensors(raw), pts_t, cal, self.settings,
                       self.params)
        dtype = prep.tair.dtype
        state = self.init(raw, cal, dtype=dtype, pts=pts)
        ones = torch.ones(prep.tair.shape, dtype=dtype, device=self.device)
        depth = self.depth_arrays(pts, dtype)
        return scan_steps(state, prep, ones, ones, pts_t.coupling_tsurf,
                          self.cfg, self.grid, self.params, depth=depth)

    def run_coupled(self, raw: RawForcing, pts: PointParams, cal: Calendar,
                    out_stride: int = 1):
        """Full simulation with observation coupling (the per-point-PC
        engine, model.py:144-154; see roadsurf_tpu_torch.coupling).  Returns
        (final_state, out [n_out, P, 6])."""
        from .coupling import run_coupled
        pts_t = self.point_tensors(pts)
        prep = prepare(self.raw_tensors(raw), pts_t, cal, self.settings,
                       self.params)
        dtype = prep.tair.dtype
        state = self.init(raw, cal, dtype=dtype, pts=pts)
        depth = self.depth_arrays(pts, dtype)
        return run_coupled(state, prep, pts_t, self.settings, self.cfg,
                           self.grid, self.params, out_stride=out_stride,
                           depth=depth)
