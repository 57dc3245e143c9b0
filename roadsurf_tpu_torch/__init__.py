"""roadsurf_tpu_torch: the road weather model framework on PyTorch and CUDA.

The port of ``roadsurf_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch, with the
whole-forecast scan kernel written by hand in CUDA C++ for Hopper
(``csrc/scan_kernel.cu``).  The JAX package stays the reference: every
module here names its counterpart there by file and line, and the tests hold
the two against each other on the same inputs.
"""

from .config import ModelSettings, PhysicsParams
from .forcing import Calendar, Prepared, RawForcing
from .model import Model, SimOutput, scan_steps
from .state import PointParams, State, default_point_params, init_state

__version__ = "0.1.0"

__all__ = [
    "ModelSettings", "PhysicsParams", "Calendar", "Prepared", "RawForcing",
    "Model", "SimOutput", "scan_steps", "PointParams", "State",
    "default_point_params", "init_state",
]
