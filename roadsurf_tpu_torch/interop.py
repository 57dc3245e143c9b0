"""Carry parameters, inputs and state across between the JAX package and the
port (the one module with no JAX counterpart).

It imports neither package's array library on the JAX side: every function
takes the JAX side's objects through numpy (``np.asarray`` on each leaf) and
returns the port's types with tensors on a given device (the card unless the
caller asks for the CPU), or takes the port's tensors back to numpy.  The dataclass configs travel by
``dataclasses.asdict``.  The tests use it to feed both packages the same
inputs and to compare their results.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Type

import numpy as np
import torch

from .config import ModelSettings, PhysicsParams
from .coupling import CouplingVars
from .forcing import Calendar, Prepared, RawForcing
from .state import PointParams, State


def settings(s) -> ModelSettings:
    """A ModelSettings-shaped dataclass -> the port's ModelSettings."""
    return ModelSettings(**dataclasses.asdict(s))


def params(p) -> PhysicsParams:
    """A PhysicsParams-shaped dataclass -> the port's PhysicsParams."""
    return PhysicsParams(**dataclasses.asdict(p))


def _tensor(x, device, dtype: Optional[torch.dtype]):
    a = np.asarray(x)
    t = torch.tensor(a, device=device)
    if dtype is not None and a.dtype.kind == "f":
        t = t.to(dtype)
    return t


def to_torch(obj, cls: Type[NamedTuple], device="cuda",
             dtype: Optional[torch.dtype] = None):
    """Any NamedTuple with ``cls``'s fields (a JAX-side State, PointParams,
    RawForcing, Prepared, ...) -> ``cls`` of tensors on ``device``.  Float
    leaves are cast to ``dtype`` when given; ints and bools keep theirs."""
    return cls(*(_tensor(getattr(obj, n), device, dtype)
                 for n in cls._fields))


def point_params(pts, device="cuda", dtype=None) -> PointParams:
    return to_torch(pts, PointParams, device, dtype)


def raw_forcing(raw, device="cuda", dtype=None) -> RawForcing:
    return to_torch(raw, RawForcing, device, dtype)


def state(st, device="cuda", dtype=None) -> State:
    return to_torch(st, State, device, dtype)


def prepared(prep, device="cuda", dtype=None) -> Prepared:
    return to_torch(prep, Prepared, device, dtype)


def coupling_vars(cv, device="cuda", dtype=None) -> CouplingVars:
    """A coupling-iteration state (the JAX package's ``CouplingVars``) ->
    the port's, float leaves cast to ``dtype`` when given."""
    return to_torch(cv, CouplingVars, device, dtype)


def calendar(cal) -> Calendar:
    """The calendar stays host numpy in both packages."""
    return Calendar(*(np.asarray(getattr(cal, n)) for n in Calendar._fields))


def packed(tmp, scal, forcing, device="cuda"):
    """The kernel's packed (tmp [LPAD, P], scal [NROWS, P], forcing
    [T, NCH, P]) float32 arrays -> contiguous float32 tensors."""
    return tuple(_tensor(np.asarray(x, np.float32), device, torch.float32)
                 .contiguous() for x in (tmp, scal, forcing))


def packed_blocks(tmp, scal, forcing, devices, slim_trf=None, aux_rows=None):
    """The kernel's whole packed arrays (a JAX-side sharded launch's inputs,
    through numpy) -> the per-block lists ``parallel.sharding.scan_sharded``
    takes, block ``b`` on ``devices[b]``: (tmp0, scal0, forcing, slim_trf,
    aux_rows), None staying None."""
    from .parallel import sharding
    f32 = lambda x: None if x is None else torch.tensor(
        np.asarray(x, np.float32))
    return sharding.shard_packed(f32(tmp), f32(scal), f32(forcing), devices,
                                 slim_trf=f32(slim_trf),
                                 aux_rows=f32(aux_rows))


def production_result(res, device="cpu"):
    """A JAX-side ``ProductionResult`` (whole, or one process's shard) ->
    the port's: the state as tensors on ``device`` (the host unless named,
    where the port's results live), steps and fields as numpy, the point
    range as it is."""
    from .production import ProductionResult
    return ProductionResult(
        state=state(res.state, device),
        out_steps=np.asarray(res.out_steps),
        fields={k: np.asarray(v) for k, v in res.fields.items()},
        point_steps_per_s=float(res.point_steps_per_s),
        point_range=tuple(int(v) for v in res.point_range))


def to_numpy(obj, cls: Optional[Type[NamedTuple]] = None):
    """A tensor, or a NamedTuple of tensors -> numpy; with ``cls`` (e.g. the
    JAX package's State) the NamedTuple is rebuilt as ``cls`` by field
    name."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if not hasattr(obj, "_fields"):
        return np.asarray(obj)
    leaves = {n: to_numpy(getattr(obj, n)) for n in obj._fields}
    return (cls or type(obj))(**leaves)
