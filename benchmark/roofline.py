"""The least time the card could take for a cycle's whole-scan kernels.

Frozen copy of the bound arithmetic of ``chip_smoke.py`` (commit 56b3c41:
its peaks and operation counts, ``scan_bound`` and ``fused_bound``), the
bound PERF.md's kernel table uses: the larger of the bytes the kernel
must read and write once over the card's HBM rate, and the operations
these inputs need over its float32 (and float64) rate.  The work is
counted from the cell's shapes and from the boundary-layer iterations the
reference counts on its sample, so a share reads the same work whatever
implements the kernel.  Where the original counted what a launch's own
arguments showed (the grid's raw rows in a chunk, the segment lines), this
copy counts less, never more: a share can only read low, not above 100%.
"""
from __future__ import annotations

from typing import NamedTuple

#: NVIDIA's data sheet for one H100 SXM (700 W): HBM rate, float32 rate
#: outside the tensor cores, float64 rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F64_OPS_S = 34e12
#: float32 operations of one point-step of the kernel's body, counted from
#: csrc/scan_kernel.cu (each add, multiply, divide, min/max, sqrt, log and
#: exp one operation; both arms of an arithmetic select): the step outside
#: the layer loop and the boundary-layer loop, each layer of the stencil,
#: each boundary-layer iteration, the in-kernel coefficient decay
OPS_STEP = 141
OPS_LAYER = 26
OPS_BL_ITER = 25
OPS_DECAY = 10
#: K3 fused's prep: float32 operations of every point-step, of each grid
#: channel a point-step; float64 operations of a point-step with
#: relaxation on
OPS_PREP = 29
OPS_GRID_CH = 3
OPS_RELAX_F64 = 19
#: the slim forcing's channels (K2), the packed state's scalar rows up to
#: and with the failure flag, the output fields a row
NCH_SLIM = 11
STATE_ROWS = 13
OUT_FIELDS = 6


class Work(NamedTuple):
    """A cycle's shapes, as the cell sets them."""
    points: int            #: points the kernel runs (padded to lanes)
    steps: int             #: kernel steps of the cycle (phases A and C)
    chunks: int            #: kernel launches of the cycle
    out_rows: int          #: output rows the launches write
    layers: int            #: ground layers
    bl_iters: float        #: boundary-layer iterations a point-step
    decay_steps: int = 0   #: steps with the coefficient decay (phase C)
    grid_channels: int = 0  #: grid channels the fused prep interpolates
    relax: bool = False    #: relaxation on (the fused prep's float64 work)


def work_of(shapes: dict) -> Work:
    """The ``Work`` of a cycle's shapes (``run.shapes``): the keys that
    ``Work`` has, the others left to the readers that need them."""
    return Work(**{k: shapes[k] for k in Work._fields if k in shapes})


def _state_bytes(w: Work) -> float:
    """The profile and the scalar state, read and written once a launch,
    and the output rows written."""
    return 4.0 * w.points * (w.chunks * 2 * (w.layers + 3 + STATE_ROWS)
                             + w.out_rows * OUT_FIELDS)


def _body_ops(w: Work) -> float:
    ps = float(w.points) * w.steps
    return (ps * (OPS_STEP + OPS_LAYER * w.layers)
            + float(w.points) * w.decay_steps * OPS_DECAY
            + ps * w.bl_iters * OPS_BL_ITER)


def k2_seconds(w: Work) -> float:
    """The bound of a cycle's K2 launches (slim forcing from the station
    gather): its 11 channels read once a step, the state and rows."""
    n_bytes = _state_bytes(w) + 4.0 * w.points * w.steps * NCH_SLIM
    return max(n_bytes / PEAK_BYTES_S, _body_ops(w) / PEAK_F32_OPS_S)


def k3_fused_seconds(w: Work) -> float:
    """The bound of a cycle's K3 fused launches: the body and the prep's
    operations (float32, and float64 with relaxation), or the state and
    rows' bytes (the raw grid rows, read once a stage, are left out)."""
    ps = float(w.points) * w.steps
    ops32 = _body_ops(w) + ps * (OPS_PREP + OPS_GRID_CH * w.grid_channels)
    ops64 = ps * OPS_RELAX_F64 if w.relax else 0.0
    return max(_state_bytes(w) / PEAK_BYTES_S,
               ops32 / PEAK_F32_OPS_S + ops64 / PEAK_F64_OPS_S)
