"""Runtime configuration, field for field the JAX package's ``SimConfig``.

The fields, defaults and the impl / integrator vocabulary are those of
``nbody_tpu/config.py``, so one command line drives both packages.  The
port adds ``device`` (default ``"cuda"``) and ``torch_dtype``.

Every impl of the vocabulary runs on a kernel of the port.  ``shards`` is
accepted as in the JAX package, where it records the mesh size; the mesh
itself is passed to ``Simulation`` (``parallel/mesh.py``).  The huge-N
modes are accepted as in the JAX package: ``prog_cap`` (interactions a
program of the bounded dispatch, ``ops/step.py::should_use_multiprog``)
and ``flat_state`` (the flat ``(3N,)`` state, a view of the ``(N, 3)``
one; ``ops/step.py::should_use_flat``).
``resident=True``
is accepted: it forces the resident kernels K3/K4, and routing
(``ops/resident.py::should_use_resident``) raises with the reason when the
run is out of their scope.
``block_i`` / ``block_j`` / ``block_u`` / ``panel_nb`` are the Pallas tile
knobs: they are kept for the shared command line, and the CUDA kernels use
the tiles fixed in their sources.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DEFAULT_DT = 0.1
DEFAULT_EPS2 = 0.002
DEFAULT_MAX_POS = 100_000.0
DEFAULT_MIN_MASS = 100_000.0
DEFAULT_MAX_MASS = 1_000_000_000.0
DEFAULT_N_BODIES = 8192
DEFAULT_MAX_VIEW = 200_000.0

_VALID_IMPLS = ("auto", "xla", "xla_nxn", "pallas", "pallas_kahan",
                "pallas_mxu", "pallas_fast", "pallas_turbo", "pallas_sym",
                "pallas_sym2", "pallas_sym_turbo", "pallas_sym_turbo2",
                "pallas_sym_mxu")
_VALID_INTEGRATORS = ("reference", "kdk", "yoshida4")

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full runtime configuration of a simulation (see the JAX
    ``SimConfig`` for the meaning of each field)."""

    n_bodies: int = DEFAULT_N_BODIES
    steps: int = 100
    dt: float = DEFAULT_DT
    eps2: float = DEFAULT_EPS2
    max_pos: float = DEFAULT_MAX_POS
    min_mass: float = DEFAULT_MIN_MASS
    max_mass: float = DEFAULT_MAX_MASS
    seed: int = 0
    integrator: str = "reference"
    impl: str = "auto"
    dtype: str = "float32"
    block_i: int = 512
    block_j: int = 2048
    chunk: int = 1024
    block_u: Optional[int] = None
    panel_nb: Optional[int] = None
    prog_cap: Optional[float] = None
    viz: bool = False
    viz_width: int = 800
    viz_height: int = 600
    max_view: float = DEFAULT_MAX_VIEW
    viz_every: int = 1
    flat_state: Optional[bool] = None
    resident: Optional[bool] = None
    shards: Optional[int] = None
    # The port's own field: where the state lives and the kernels run.
    device: str = "cuda"

    def __post_init__(self):
        if self.impl not in _VALID_IMPLS:
            raise ValueError(
                f"impl must be one of {_VALID_IMPLS}, got {self.impl!r}")
        if self.integrator not in _VALID_INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {_VALID_INTEGRATORS}, "
                f"got {self.integrator!r}")
        if self.n_bodies <= 0:
            raise ValueError("n_bodies must be positive")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def interactions_per_step(self) -> int:
        """All-pairs interaction count per step (N^2), the unit of the
        GInteractions/s metric."""
        return self.n_bodies * self.n_bodies

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
