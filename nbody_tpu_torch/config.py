"""Runtime configuration, field for field the JAX package's ``SimConfig``.

The fields, defaults and the impl / integrator vocabulary are those of
``nbody_tpu/config.py``, so one command line drives both packages.  The
port adds ``device`` (default ``"cuda"``) and ``torch_dtype``.

Impls whose kernels are not ported yet raise ``NotImplementedError`` naming
their ROADMAP item, and so do the TPU execution modes the port does not
have (``resident=True``, ``flat_state=True``, ``prog_cap``, ``shards``).
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

# Impls whose kernels are still to be ported -> their ROADMAP Queue 2 item.
UNPORTED_IMPLS = {
    "pallas_kahan": "K11", "pallas_mxu": "K10", "pallas_fast": "K12",
    "pallas_turbo": "K9", "pallas_sym": "K7", "pallas_sym_turbo": "K5",
    "pallas_sym_turbo2": "K14", "pallas_sym_mxu": "K6",
}

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
        if self.impl in UNPORTED_IMPLS:
            raise NotImplementedError(
                f"impl={self.impl!r} is not ported yet (ROADMAP Queue 2 "
                f"{UNPORTED_IMPLS[self.impl]})")
        if self.integrator not in _VALID_INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {_VALID_INTEGRATORS}, "
                f"got {self.integrator!r}")
        if self.n_bodies <= 0:
            raise ValueError("n_bodies must be positive")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.resident:
            raise NotImplementedError(
                "resident=True: the resident multi-step kernel is not ported "
                "yet (ROADMAP Queue 2 K3); None and False run per step")
        if self.flat_state:
            raise NotImplementedError(
                "flat_state=True is a TPU layout workaround, not ported "
                "(ROADMAP Queue 1 item 13)")
        if self.prog_cap is not None:
            raise NotImplementedError(
                "prog_cap: bounded multi-program dispatch is not ported "
                "(ROADMAP Queue 1 item 13)")
        if self.shards and self.shards > 1:
            raise NotImplementedError(
                "shards > 1: multi-GPU is not ported yet (ROADMAP Queue 1 "
                "item 14)")

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
