"""nbody_tpu_torch: the all-pairs N-body system on PyTorch and CUDA.

The port of ``nbody_tpu`` (JAX + Pallas) to one NVIDIA H100, module for
module.  It imports torch and numpy and never JAX.  The force kernels are
hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built by ``nvcc`` at
first use; on CPU tensors their plain PyTorch versions run instead.
"""

from .config import SimConfig
from .models.init import init_state
from .models.state import SimState, state_from_numpy, state_to_numpy
from .ops.forces import compute_forces, resolve_impl
from .ops.step import run_steps, step

__all__ = ["SimConfig", "SimState", "init_state", "state_from_numpy",
           "state_to_numpy", "compute_forces", "resolve_impl", "run_steps",
           "step"]
