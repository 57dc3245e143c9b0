"""Output writers: example1-format forecast JSON and binary state
checkpoints for warm-start cycling.

The counterpart of ``roadsurf_tpu/io/writer.py``: the same files, byte for
byte, from the same values.  Host numpy throughout; tensors (on any device)
are taken to the host first, and ``restore_state`` returns tensors on the
template's device.

JSON format per save_output (examples/example1/src/roadrunner.cpp:285-327):
a list of {statId, lat, lon, time[], RoadTemperature[], Water[], Ice[],
Snow[], Deposit[]} subsampled at the output step (Ice2 is computed but not
written by the reference's JSON writer -- replicated; the checkpoint keeps
it).
"""
from __future__ import annotations

import json
import time as timelib
from typing import Sequence

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def format_times(epochs: Sequence[int], fmt: str = "%Y-%m-%dT%H:%M"):
    return [timelib.strftime(fmt, timelib.gmtime(int(e))) for e in epochs]


def write_forecast_json(path: str, point_ids, lats, lons, sim_epochs,
                        out_tsurf, out_wat, out_snow, out_ice, out_dep,
                        output_stride: int = 1):
    """out_*: [T, P] arrays (or already-strided [T_out, P] with stride 1)."""
    sl = slice(None, None, output_stride)
    times = format_times(np.asarray(sim_epochs)[sl])
    doc = []
    for i, pid in enumerate(point_ids):
        doc.append({
            "statId": int(pid),
            "lat": float(lats[i]),
            "lon": float(lons[i]),
            "time": times,
            "RoadTemperature": [round(float(v), 5)
                                for v in _np(out_tsurf)[sl, i]],
            "Water": [round(float(v), 5) for v in _np(out_wat)[sl, i]],
            "Ice": [round(float(v), 5) for v in _np(out_ice)[sl, i]],
            "Snow": [round(float(v), 5) for v in _np(out_snow)[sl, i]],
            "Deposit": [round(float(v), 5)
                        for v in _np(out_dep)[sl, i]],
        })
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def write_forecast_json_extended(path: str, point_ids, lats, lons,
                                 sim_epochs, fields: dict, tair, tdew,
                                 output_stride: int = 1):
    """example2's extended parameter set (QueryDataTools.cpp:125-153): tsurf,
    tair, tdew, dew-point deficit (tsurf - tdew), snow, water, ice, deposit,
    ice2 -- as JSON (the querydata binary container is FMI-internal; the
    field set is what matters for parity)."""
    sl = slice(None, None, output_stride)
    times = format_times(np.asarray(sim_epochs)[sl])
    r5 = lambda arr, i: [round(float(v), 5) for v in _np(arr)[sl, i]]
    doc = []
    for i, pid in enumerate(point_ids):
        tsurf = _np(fields["tsurf"])[sl, i]
        td = _np(tdew)[sl, i]
        doc.append({
            "statId": int(pid), "lat": float(lats[i]), "lon": float(lons[i]),
            "time": times,
            "RoadTemperature": [round(float(v), 5) for v in tsurf],
            "Temperature2m": r5(tair, i),
            "DewPoint": r5(tdew, i),
            "DewPointDeficit": [round(float(a - b), 5)
                                for a, b in zip(tsurf, td)],
            "Snow": r5(fields["snow"], i),
            "Water": r5(fields["wat"], i),
            "Ice": r5(fields["ice"], i),
            "Deposit": r5(fields["dep"], i),
            "Ice2": r5(fields["ice2"], i),
        })
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def write_forecast_grid(path: str, grid_lats, grid_lons, keep, sim_epochs,
                        fields: dict, tair, tdew, output_stride: int = 1):
    """Gridded output writer -- the querydata-writer equivalent
    (examples/example2/src/QueryDataTools.cpp): the 9-parameter set
    (create_param_descriptor :125-153 -- tsurf, tair, tdew, dew-point
    deficit, snow, water, ice, deposit, ice2) scattered back onto the
    simulation grid at the output stride (get_write_stride :270-283), masked
    cells missing.  Container is npz (the querydata binary is FMI-internal):
    ``times`` [T_out], ``lats`` [ny], ``lons`` [nx], ``mask`` [ny, nx], and
    one [T_out, ny, nx] float32 array per parameter.

    fields: {tsurf, wat, snow, ice, ice2, dep} as [T, P] over kept points in
    row-major grid order (the parse_points_full flattening).
    """
    keep = np.asarray(keep, bool)
    ny, nx = keep.shape
    sl = slice(None, None, output_stride)
    epochs = np.asarray(sim_epochs)[sl]
    tsurf = _np(fields["tsurf"])[sl]
    tair = _np(tair)[sl]
    tdew = _np(tdew)[sl]
    params = {
        "tsurf": tsurf, "tair": tair, "tdew": tdew,
        "tdew_deficit": tsurf - tdew,
        "snow": _np(fields["snow"])[sl],
        "water": _np(fields["wat"])[sl],
        "ice": _np(fields["ice"])[sl],
        "deposit": _np(fields["dep"])[sl],
        "ice2": _np(fields["ice2"])[sl],
    }
    T_out = len(epochs)
    grids = {}
    for name, v in params.items():
        g = np.full((T_out, ny * nx), -9999.9, np.float32)
        g[:, keep.ravel()] = v.astype(np.float32)
        grids[name] = g.reshape(T_out, ny, nx)
    np.savez_compressed(
        path, times=epochs.astype(np.int64),
        lats=np.asarray(grid_lats, np.float64),
        lons=np.asarray(grid_lons, np.float64),
        mask=keep, **grids)


def write_shard_npz(path: str, point_range, out_steps, fields: dict,
                    epochs=None):
    """Per-process output shard with a range manifest: the multi-host
    output path (ProductionResult from ``drain='shard'``).  Each host
    writes ONLY its own [lo, hi) point columns -- the cross-host analogue
    of the reference's disjoint-row writes into one shared querydata
    object (examples/example2/src/QueryDataTools.cpp:299-345).  Rejoin
    with :func:`merge_shards`."""
    lo, hi = point_range
    np.savez_compressed(
        path, lo=np.int64(lo), hi=np.int64(hi),
        steps=np.asarray(out_steps, np.int64),
        epochs=(np.asarray(epochs, np.int64) if epochs is not None
                else np.zeros(0, np.int64)),
        **{k: np.asarray(_np(v), np.float32) for k, v in fields.items()})


def merge_shards(paths):
    """Assemble shard files written by :func:`write_shard_npz` into the
    full (out_steps, fields {name: [n_out, P]}, epochs); validates that
    the ranges tile [0, P) exactly and that steps/epochs agree across
    shards.  ``epochs`` is empty when the writers stored none."""
    metas = []
    for p in paths:
        with np.load(p) as z:
            metas.append((int(z["lo"]), int(z["hi"]), dict(z)))
    metas.sort(key=lambda m: m[0])
    steps = metas[0][2]["steps"]
    epochs = metas[0][2]["epochs"]
    cur = 0
    for lo, hi, z in metas:
        if lo != cur:
            raise ValueError(f"shard ranges do not tile: gap/overlap at "
                             f"{cur} (next shard starts {lo})")
        if not np.array_equal(z["steps"], steps):
            raise ValueError("shard output steps disagree")
        if not np.array_equal(z["epochs"], epochs):
            raise ValueError("shard output epochs disagree")
        cur = hi
    names = [k for k in metas[0][2]
             if k not in ("lo", "hi", "steps", "epochs")]
    fields = {n: np.concatenate([z[n] for _, _, z in metas], axis=-1)
              for n in names}
    return steps, fields, epochs


def save_checkpoint(path: str, state, point_ids, sim_epoch_end: int):
    """Binary prognostic-state checkpoint (the reference has none -- it
    reconstructs from obs+climatology each cycle; SURVEY.md section 5).  The
    saved set is exactly the coupling snapshot's definition of model state
    plus the boundary-layer warm start."""
    np.savez_compressed(
        path,
        point_ids=np.asarray(point_ids),
        epoch=np.int64(sim_epoch_end),
        tmp=_np(state.tmp),
        tsurf_ave=_np(state.tsurf_ave),
        wat=_np(state.wat), snow=_np(state.snow),
        ice=_np(state.ice), ice2=_np(state.ice2),
        dep=_np(state.dep),
        q2melt=_np(state.q2melt), t4melt=_np(state.t4melt),
        very_cold=_np(state.very_cold),
        evap=_np(state.evap), blcond=_np(state.blcond),
        albedo=_np(state.albedo), failed=_np(state.failed))


def load_checkpoint(path: str):
    """Returns (dict of arrays, point_ids, epoch)."""
    z = np.load(path)
    fields = {k: z[k] for k in z.files if k not in ("point_ids", "epoch")}
    return fields, z["point_ids"], int(z["epoch"])


def restore_state(path: str, point_ids, state_template):
    """Build a State from a checkpoint, matching points by id; points absent
    from the checkpoint keep the template (cold-start) state.  Each leaf
    comes back as its template leaf is: a tensor on the template's device,
    or numpy for a numpy template.  A checkpoint of no points (the shard
    of a process whose blocks hold only padding) restores nothing."""
    fields, ckpt_ids, _ = load_checkpoint(path)
    index = {int(pid): i for i, pid in enumerate(ckpt_ids)}
    rows = np.array([index.get(int(p), -1) for p in point_ids])
    have = rows >= 0
    rows_c = np.clip(rows, 0, None)

    def merge(name, tmpl):
        tmpl_np = _np(tmpl)
        if not have.any():
            return tmpl
        ck = fields[name][rows_c]
        mask = have.reshape(have.shape + (1,) * (tmpl_np.ndim - 1))
        merged = np.where(mask, ck, tmpl_np).astype(tmpl_np.dtype)
        if isinstance(tmpl, torch.Tensor):
            return torch.tensor(merged, device=tmpl.device)
        return merged

    return state_template._replace(
        **{name: merge(name, getattr(state_template, name))
           for name in ("tmp", "tsurf_ave", "wat", "snow", "ice", "ice2",
                        "dep", "q2melt", "t4melt", "very_cold", "evap",
                        "blcond", "albedo", "failed")})
