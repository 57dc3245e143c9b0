"""Point-axis sharding over a list of devices.

The counterpart of ``roadsurf_tpu/parallel/sharding.py``.  The reference's
entire parallel structure is embarrassingly-parallel CPU threading over
independent road points (examples/example1/src/WorkQueue.h:15-131,
examples/example2 boost::asio pool).  Here a list of devices stands for the
JAX package's mesh: the points axis is cut into as many equal contiguous
blocks as the list has entries, block ``b`` lives on ``devices[b]``, and the
whole-scan kernel runs on every block with no communication (columns are
independent).  A device may appear more than once; each of its blocks then
gets a CUDA stream of its own, so one card runs several blocks side by side.
Only the failed-point count of the missing-data budget is reduced, over
processes (the analogue of example2's allowed_missing_ratio guard,
examples/example2/src/roadrunner.cpp:700-706).

Where the JAX package holds one global array sharded over the mesh, the port
holds a list with one tensor per block, each on its block's device.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import scan_kernel as sk

LANE = sk.LANE


def tree_map(fn, tree):
    """``fn`` over the leaves of a NamedTuple, tuple, list or dict (None
    stays None)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def block_ranges(n_points: int, ndev: int, tile_p: Optional[int] = None):
    """[(lo, hi)] of the ``ndev`` equal contiguous point blocks; raises where
    ``pallas_scan_sharded`` does (sharding.py:97-113): the points must divide
    the devices, and a block must hold whole kernel lanes and, with
    ``tile_p``, whole tiles."""
    if n_points % ndev:
        raise ValueError(
            f"points ({n_points}) must divide the devices ({ndev}); pad "
            "with pad_points() first")
    per = n_points // ndev
    if per % LANE:
        raise ValueError(
            f"per-device points ({per} = {n_points}/{ndev}) must be a "
            f"multiple of the kernel lane width ({LANE}); pad with "
            f"pad_points(tree, {ndev * LANE}) first")
    if tile_p is not None and per % tile_p:
        raise ValueError(
            f"per-device points ({per}) must be a multiple of tile_p "
            f"({tile_p}); pad with pad_points(tree, {ndev * tile_p}) first")
    return [(b * per, (b + 1) * per) for b in range(ndev)]


class DeviceBlocks:
    """The device list of a sharded run: ``devices[b]`` holds block ``b``.
    A CUDA device that appears more than once gives each of its blocks a
    stream of its own; a device that appears once works on the current
    stream."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a sharded run needs at least one device")
        self.devices = devs
        counts = Counter(devs)
        self._streams = [
            torch.cuda.Stream(device=d)
            if d.type == "cuda" and counts[d] > 1 else None for d in devs]

    def __len__(self):
        return len(self.devices)

    def stream(self, b: int):
        """Block ``b``'s CUDA stream (None on the CPU)."""
        d = self.devices[b]
        if d.type != "cuda":
            return None
        own = self._streams[b]
        return own if own is not None else torch.cuda.current_stream(d)

    def scope(self, b: int):
        """Context in which block ``b``'s work is issued: its device and
        its stream current."""
        s = self.stream(b)
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def synchronize(self):
        """Wait for every block's stream."""
        for b in range(len(self)):
            s = self.stream(b)
            if s is not None:
                s.synchronize()


def make_mesh(devices=None) -> DeviceBlocks:
    """The blocks of ``devices``; None means every visible CUDA device (as
    the JAX package's ``make_mesh()`` means ``jax.devices()``), and raises
    when there is none: it never means the CPU."""
    if isinstance(devices, DeviceBlocks):
        return devices
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "devices=None means every visible CUDA device, and there "
                "is none; name the devices (e.g. ['cpu'] * n) to run "
                "elsewhere")
        devices = [torch.device("cuda", i) for i in range(n)]
    return DeviceBlocks(devices)


def _block(x, mesh: DeviceBlocks, b: int, axis: int, ranges=None):
    """Block ``b`` of ``x`` cut on ``axis`` (all of it where it has no such
    axis), contiguous on the block's device."""
    x = torch.as_tensor(x)
    if x.dim() <= axis:
        return x.to(mesh.devices[b])
    if ranges is None:
        n, ndev = x.shape[axis], len(mesh)
        if n % ndev:
            raise ValueError(f"points ({n}) must divide the devices "
                             f"({ndev}); pad with pad_points() first")
        ranges = [(k * (n // ndev), (k + 1) * (n // ndev))
                  for k in range(ndev)]
    lo, hi = ranges[b]
    return x.narrow(axis, lo, hi - lo).to(mesh.devices[b]).contiguous()


def _split(x, mesh: DeviceBlocks, axis: int, ranges=None):
    return [_block(x, mesh, b, axis, ranges) for b in range(len(mesh))]


def shard_state(tree, devices):
    """A State/PointParams-like tree cut on its leading (points) axis: a
    list with one tree per block, leaves on the block's device."""
    mesh = make_mesh(devices)
    return [tree_map(lambda x: _block(x, mesh, b, 0), tree)
            for b in range(len(mesh))]


def shard_prepared(prep, devices):
    """Time-major [T, P] forcing channels cut on axis 1, [T] channels
    replicated: a list with one tree per block."""
    mesh = make_mesh(devices)
    return [tree_map(lambda x: _block(x, mesh, b, 1), prep)
            for b in range(len(mesh))]


def pad_points(tree, multiple: int, axis: int = 0):
    """Pad the points axis to a multiple (device count x lane).  Padded
    points are marked failed by the caller, so they never contribute.
    Returns (padded tree of numpy arrays, original count)."""
    def pad(x):
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        if x.ndim <= axis:
            return x
        rem = (-x.shape[axis]) % multiple
        if rem == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, rem)
        return np.pad(x, widths, mode="edge")
    first = _leaves(tree)[0]
    return tree_map(pad, tree), int(first.shape[axis])


def shard_packed(tmp0, scal0, forcing, devices, slim_trf=None, aux_rows=None):
    """The kernel's packed inputs cut into the blocks of ``devices`` as
    ``pallas_scan_sharded`` places them (sharding.py:136-147): ``tmp0``,
    ``scal0`` and ``aux_rows`` on axis 1, a point-major forcing on axis 2, a
    tile-major one on its tile axis, ``slim_trf`` replicated.  Returns
    (tmp0, scal0, forcing, slim_trf, aux_rows) as per-block lists (None
    stays None)."""
    mesh = make_mesh(devices)
    ndev = len(mesh)
    n_points = tmp0.shape[1]
    tile_major = forcing.dim() == 4
    ranges = block_ranges(n_points, ndev,
                          forcing.shape[3] if tile_major else None)
    if tile_major and forcing.shape[0] % ndev:
        raise ValueError(f"tile count ({forcing.shape[0]}) must divide the "
                         f"devices ({ndev})")
    cut = lambda x, axis: _split(x, mesh, axis, ranges)
    if tile_major:
        tp = forcing.shape[3]
        forc = _split(forcing, mesh, 0,
                      [(lo // tp, hi // tp) for lo, hi in ranges])
    else:
        forc = cut(forcing, 2)
    return (cut(tmp0, 1), cut(scal0, 1), forc,
            None if slim_trf is None else _split(slim_trf, mesh, 1),
            None if aux_rows is None else cut(aux_rows, 1))


def _check_blocks(tmp0, forcing, mesh: DeviceBlocks):
    """The divisibility rules of ``pallas_scan_sharded`` on per-block
    inputs: one equal block for each device, whole lanes, whole tiles."""
    if len(tmp0) != len(mesh) or len({t.shape[1] for t in tmp0}) != 1:
        raise ValueError(
            f"points ({[int(t.shape[1]) for t in tmp0]} in {len(tmp0)} "
            f"blocks) must divide the devices ({len(mesh)}): one equal "
            "block for each; pad with pad_points() first")
    per = tmp0[0].shape[1]
    f0 = forcing[0]
    block_ranges(per * len(mesh), len(mesh),
                 f0.tile_geom[1] if sk.is_fused(f0)
                 else f0.shape[3] if f0.dim() == 4 else None)
    for b, (t, d) in enumerate(zip(tmp0, mesh.devices)):
        if t.device != d:
            raise ValueError(f"block {b} lies on {t.device}, its device is "
                             f"{d}")


def scan_sharded(tmp0, scal0, forcing, cfg, params, grid, devices=None,
                 out_stride: int = 1, nsteps: Optional[int] = None,
                 out_offset=None, n_out: Optional[int] = None,
                 t_total: Optional[int] = None,
                 cof_red: Optional[float] = None, slim_trf=None,
                 aux_rows=None, aux_cofs: bool = False, fence: bool = True,
                 out=None):
    """The whole-scan kernel over the point blocks of a device list (K4,
    sharding.py:73 ``pallas_scan_sharded``): every block's chunk goes
    through one sharded launch, nothing is exchanged between blocks.

    The arguments of ``ops.scan_kernel.scan`` with a per-block list in place
    of each tensor: ``tmp0[b]`` [LPAD, P_b], ``scal0[b]`` [NROWS, P_b],
    ``forcing[b]`` [T, NCH or NCH_SLIM, P_b] or tile-major
    [P_b / TP, T, nch, TP] (or a fused chunk of raw inputs,
    ``production.FusedChunk``: K3 fused), and in the slim mode
    ``slim_trf[b]`` (a copy of the time-only vector on the block's device)
    and ``aux_rows[b]`` [4, P_b], each on ``devices[b]`` (:func:`shard_packed` cuts whole
    tensors so).  ``devices``: a list of devices or a :class:`DeviceBlocks`;
    None means every visible CUDA device.

    CUDA blocks take ``ops.scan_kernel.scan_cuda_sharded`` (one host call,
    block ``b`` on its own stream) or raise; CPU blocks take
    :func:`scan_sharded_reference`.  With ``fence`` each block's stream
    first waits for the work already issued on its device's current stream,
    and that stream waits for the block's launch after it, so a caller on
    the current stream need order nothing; a caller that issues each
    block's work inside ``DeviceBlocks.scope`` passes ``fence=False``.

    ``out``: optional per-block (tmp, scal, rows) tensors the results are
    written into (``ops.scan_kernel.check_out``), for a caller that keeps
    two sets a block and alternates them; None allocates new ones.

    Returns a list of (tmp [LPAD, P_b], scal [NROWS, P_b],
    out [n_out, N_OUT_FIELDS, P_b]) per block."""
    mesh = make_mesh(devices)
    _check_blocks(tmp0, forcing, mesh)
    kw = dict(out_stride=out_stride, nsteps=nsteps, out_offset=out_offset,
              n_out=n_out, slim_trf=slim_trf, aux_rows=aux_rows,
              aux_cofs=aux_cofs, t_total=t_total, cof_red=cof_red, out=out)
    kinds = {d.type for d in mesh.devices}
    if kinds == {"cpu"}:
        return scan_sharded_reference(tmp0, scal0, forcing, cfg, params,
                                      grid, **kw)
    if kinds != {"cuda"}:
        raise ValueError(f"no sharded scan kernel for devices "
                         f"{mesh.devices}")
    streams = [mesh.stream(b) for b in range(len(mesh))]
    if fence:
        callers = [torch.cuda.current_stream(d) for d in mesh.devices]
        for s, c in zip(streams, callers):
            if s != c:
                s.wait_stream(c)
    results = sk.scan_cuda_sharded(tmp0, scal0, forcing, cfg, params, grid,
                                   streams, **kw)
    if fence:
        for s, c, res in zip(streams, callers, results):
            if s != c:
                c.wait_stream(s)
                for x in res:
                    x.record_stream(c)
    return results


def scan_sharded_reference(tmp0, scal0, forcing, cfg, params, grid,
                           out_stride: int = 1,
                           nsteps: Optional[int] = None, out_offset=None,
                           n_out: Optional[int] = None, slim_trf=None,
                           aux_rows=None, aux_cofs: bool = False,
                           t_total: Optional[int] = None,
                           cof_red: Optional[float] = None, out=None):
    """The plain version of :func:`scan_sharded`: ``scan_reference`` on one
    block after the other, on whatever device each lies; with ``out`` the
    results are copied into it."""
    slim = aux_rows is not None
    res = [(sk.scan_fused_reference if sk.is_fused(forcing[b])
            else sk.scan_reference)(
        tmp0[b], scal0[b], forcing[b], cfg, params, grid,
        out_stride=out_stride, nsteps=nsteps, out_offset=out_offset,
        n_out=n_out, slim_trf=slim_trf[b] if slim else None,
        aux_rows=aux_rows[b] if slim else None, aux_cofs=aux_cofs,
        t_total=t_total, cof_red=cof_red) for b in range(len(tmp0))]
    if out is None:
        return res
    sk.check_out(out, tmp0, scal0, [[x.shape for x in r] for r in res])
    for o, r in zip(out, res):
        for x, y in zip(o, r):
            x.copy_(y)
    return [tuple(o) for o in out]


def gather_blocks(blocks, axis: int = -1, device="cpu"):
    """Per-block tensors joined on ``axis`` on one device (the host unless
    named)."""
    return torch.cat([x.to(device) for x in blocks], dim=axis)


def failure_stats(failed, devices=None):
    """Global failed-point count and ratio: the missing-data budget
    reduction (examples/example2/src/roadrunner.cpp:536-543).

    ``failed``: one [P] bool tensor or array, or the per-block list of a
    sharded run; in a run of several processes each passes its own points
    and the counts are summed over the processes (``devices`` is accepted
    for the JAX signature's ``mesh`` and not read: the blocks carry their
    devices).  Returns (count, ratio) as python numbers."""
    from . import distributed
    blocks = failed if isinstance(failed, (list, tuple)) else [failed]
    blocks = [f if isinstance(f, torch.Tensor) else np.asarray(f)
              for f in blocks]
    count = sum(int(f.sum()) for f in blocks)
    total = sum(int(np.prod(f.shape)) for f in blocks)
    count, total = distributed.sum_over_processes([count, total])
    return count, count / total


def check_missing_budget(failed, allowed_missing_ratio: float,
                         devices=None) -> bool:
    """True if the run exceeds the allowed failure budget (the reference
    raises a hard error then; example2/src/roadrunner.cpp:578-581)."""
    _, ratio = failure_stats(failed, devices)
    return bool(ratio > allowed_missing_ratio)
