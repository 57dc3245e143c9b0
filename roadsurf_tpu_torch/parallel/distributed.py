"""Execution over several processes: ``torch.distributed`` + per-process
point shards.

The counterpart of ``roadsurf_tpu/parallel/distributed.py``.  The reference
scales by running independent processes on partitioned point sets
(config/mask partitioning; SURVEY.md section 2.4 P1/P5).  Here the processes
of one run split the globally ordered points into equal contiguous ranges:
each process owns ``host_point_range`` and its own devices, runs the sharded
scan over the blocks of its range, drains only its own columns
(``run_production(drain="shard")``) and writes them with a range manifest
(``io.writer.write_shard_npz`` / ``merge_shards``).  No tensor crosses
between processes: the only collectives are a few integers (failed counts,
``host_any`` bits), reduced on CPU tensors, so the default backend is
``gloo`` on every machine (NCCL refuses two ranks on one card, and nothing
here needs it).

Nothing on a machine tells a process of the others: ``initialize`` is given
the coordinator's address, the number of processes and this one's index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import sharding


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo", timeout_s: float = 300.0) -> None:
    """Join the run's process group (``tcp://coordinator_address``); no-op
    for a single-process run."""
    if num_processes is None or num_processes <= 1:
        return
    import datetime
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group (no-op for a single-process run)."""
    if _active():
        dist.destroy_process_group()


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def host_point_range(n_points_total: int) -> Tuple[int, int]:
    """[start, end) of the globally-ordered point range this process owns
    (equal contiguous shards; the process loads ONLY this slice's
    forcing)."""
    n_proc, pid = process_count(), process_index()
    per = -(-n_points_total // n_proc)
    start = min(pid * per, n_points_total)
    return start, min(start + per, n_points_total)


def make_global(tree, devices, axis: int = 0):
    """This process's blocks of a host-local tree: each leaf is the
    process's [local_P, ...] (axis 0) or [..., local_P] contribution and is
    cut into one block per device of ``devices`` (this process's); a leaf
    without that axis is replicated.  Returns a list with one tree per
    block, as ``sharding.shard_state`` does."""
    mesh = sharding.make_mesh(devices)
    return [sharding.tree_map(
        lambda x: sharding._block(np.asarray(x), mesh, b, axis), tree)
        for b in range(len(mesh))]


def sum_over_processes(values):
    """Elementwise sum of a short list of integers over the processes
    (a CPU all-reduce); the list itself for a single process."""
    if not _active():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return [int(v) for v in t]


def host_any(x) -> bool:
    """``bool(any(x))`` over every process's part: ``x`` is a tensor or
    array, or the per-block list of a sharded run.  Every process returns
    the SAME answer, so it is safe to branch on the result."""
    blocks = x if isinstance(x, (list, tuple)) else [x]
    local = any(bool(b.any()) if isinstance(b, torch.Tensor)
                else bool(np.any(np.asarray(b))) for b in blocks)
    return sum_over_processes([int(local)])[0] > 0


def gather_to_host(x, axis: int = 0):
    """This process's part of a (possibly sharded) value as numpy: a tensor,
    or a per-block list joined on ``axis`` (output writing; each process
    addresses only its own blocks)."""
    if isinstance(x, (list, tuple)):
        return np.concatenate([gather_to_host(b) for b in x], axis=axis)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
