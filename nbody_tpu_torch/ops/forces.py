"""Force-backend dispatch: ``resolve_impl`` and ``compute_forces``, as in
``nbody_tpu/ops/forces.py``.

Off CUDA, ``auto`` resolves as the JAX package does off the TPU.  On CUDA
it picks the one-sided kernel K1 (``pallas``) below ``SYM_CROSSOVER_N``
bodies and the pair-symmetric kernel K2 (``pallas_sym2``) from there up.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from .forces_sym import forces_sym
from .forces_tiled import forces_tiled
from .forces_torch import forces_chunked, forces_nxn

_NXN_MAX_N = 16384

# K1 / K2 crossover on the card: one force evaluation on an H100 80GB
# HBM3 at 700 W, median of 7 alternating rounds, took 0.0285 ms (K1) vs
# 0.0454 ms (K2) at N=1024 and 0.0417 vs 0.0286 ms at N=1536; K2 won at
# 1536 in two of three runs and at every N from 2048 in all three
# (PERF.md, "K1/K2 crossover").  Below ~2048 both times are mostly the
# wrappers' host cost, not device time.
SYM_CROSSOVER_N = 1536


def resolve_impl(cfg: SimConfig) -> str:
    """Resolve impl='auto' to a concrete backend for ``cfg.device``."""
    if cfg.impl != "auto":
        return cfg.impl
    if cfg.dtype != "float32":
        # The kernels are float32-only; the plain paths follow the dtype.
        return "xla_nxn" if cfg.n_bodies <= 4096 else "xla"
    if torch.device(cfg.device).type != "cuda":
        return "xla_nxn" if cfg.n_bodies <= 4096 else "xla"
    return "pallas_sym2" if cfg.n_bodies >= SYM_CROSSOVER_N else "pallas"


def compute_forces(pos: torch.Tensor, mass: torch.Tensor, cfg: SimConfig,
                   impl: "str | None" = None) -> torch.Tensor:
    """Softened all-pairs gravitational acceleration (N,3)."""
    impl = impl or resolve_impl(cfg)
    if impl == "xla_nxn":
        if pos.shape[0] > _NXN_MAX_N:
            raise ValueError(
                f"impl='xla_nxn' materializes O(N^2); N={pos.shape[0]} > "
                f"{_NXN_MAX_N}. Use 'xla' or 'pallas'.")
        return forces_nxn(pos, mass, cfg.eps2)
    if impl == "xla":
        return forces_chunked(pos, mass, cfg.eps2, chunk=cfg.chunk)
    if impl == "pallas":
        return forces_tiled(pos, mass, cfg.eps2)
    if impl == "pallas_sym2":
        return forces_sym(pos, mass, cfg.eps2)
    raise ValueError(f"unknown force impl {impl!r}")
