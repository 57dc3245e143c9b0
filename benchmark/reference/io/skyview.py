"""Frozen copy of ``roadsurf_tpu_torch/io/skyview.py`` (commit 56b3c41) in the
benchmark's plain reference: later changes to the program do not
reach it, and it imports nothing of the program.

Sky view factor and local horizon file parsing
(examples/example1/src/SkyView.cpp: sky_view_file ``id name lat lon svf``;
local_horizon_file ``id name lat lon`` + 360 horizon angles).  Missing points
default to svf = 1.0 (no modification) and zero horizons.

The counterpart of ``roadsurf_tpu/io/skyview.py``: the same host numpy, so the
same values bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def read_sky_view_file(path: str) -> Dict[int, float]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                out[int(parts[0])] = float(parts[4])
    return out


def read_horizon_file(path: str) -> Dict[int, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4 + 360:
                out[int(parts[0])] = np.asarray(parts[4:4 + 360], np.float64)
    return out


def sky_variables(point_ids: Sequence[int],
                  sky_view_path: Optional[str] = None,
                  horizon_path: Optional[str] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point (sky_view [P], horizons [P, 360]) with the reference
    defaults (SkyView.cpp:125-138)."""
    P = len(point_ids)
    svf = np.ones(P)
    horizons = np.zeros((P, 360))
    if sky_view_path:
        table = read_sky_view_file(sky_view_path)
        for i, pid in enumerate(point_ids):
            svf[i] = table.get(pid, 1.0)
    if horizon_path:
        table = read_horizon_file(horizon_path)
        for i, pid in enumerate(point_ids):
            if pid in table:
                horizons[i] = table[pid]
    return svf, horizons
