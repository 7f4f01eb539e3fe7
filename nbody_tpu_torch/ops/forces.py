"""Force-backend dispatch: ``resolve_impl`` and ``compute_forces``, as in
``nbody_tpu/ops/forces.py``.

Off CUDA, ``auto`` resolves as the JAX package does off the TPU.  On CUDA
it picks the one-sided kernel K1 (``pallas``) below ``SYM_CROSSOVER_N``
bodies and the pair-symmetric kernel K2 (``pallas_sym2``) from there up.
With ``resident=True`` it resolves to ``pallas_sym2`` at any N and on any
device, as the JAX package does, so the forced resident path engages.
The other tiers (``pallas_sym`` K7, ``pallas_kahan`` K11, ``pallas_fast``
K12, and the tensor-core tiers ``pallas_turbo`` K9, ``pallas_mxu`` K10,
``pallas_sym_turbo`` K5, ``pallas_sym_mxu`` K6, ``pallas_sym_turbo2``
K14a) run only when named: the JAX package's ``auto`` never picks them
either.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from .forces_fast import forces_fast
from .forces_sym_variants import CLASSIC, SYM_IMPL_VARIANTS
from .forces_tiled import forces_tiled, forces_tiled_kahan
from .forces_tiled_tc import forces_tiled_mxu, forces_tiled_turbo
from .forces_torch import forces_chunked, forces_nxn

# impl -> the wrapper of its kernel; the pair-symmetric impls (K2, K7,
# K5, K6, K14a) through their variants.
_KERNELS = {
    "pallas": forces_tiled,                    # K1, exact
    "pallas_kahan": forces_tiled_kahan,        # K11, exact, compensated
    "pallas_fast": forces_fast,                # K12, centred distances
    "pallas_turbo": forces_tiled_turbo,        # K9
    "pallas_mxu": forces_tiled_mxu,            # K10
    **{impl: CLASSIC[v] for impl, v in SYM_IMPL_VARIANTS.items()},
}

_NXN_MAX_N = 16384

# K1 / K2 crossover on the card: one force evaluation on an H100 80GB
# HBM3 at 700 W, median of 7 alternating rounds, took 0.0285 ms (K1) vs
# 0.0454 ms (K2) at N=1024 and 0.0417 vs 0.0286 ms at N=1536; K2 won at
# 1536 in two of three runs and at every N from 2048 in all three
# (PERF.md, "K1/K2 crossover").  Below ~2048 both times are mostly the
# wrappers' host cost, not device time.
SYM_CROSSOVER_N = 1536


def resolve_impl(cfg: SimConfig, sharded: bool = False) -> str:
    """Resolve impl='auto' to a concrete backend for ``cfg.device``.

    ``sharded``: the caller runs the config on a mesh, as in the JAX
    package.  There it keeps mesh runs out of the resident window; here
    the resident kernels are routed by ``should_use_resident``, which mesh
    runs never consult, so the resolution is the same."""
    del sharded
    if cfg.impl != "auto":
        return cfg.impl
    if cfg.dtype != "float32":
        # The kernels are float32-only; the plain paths follow the dtype.
        return "xla_nxn" if cfg.n_bodies <= 4096 else "xla"
    if cfg.resident is True:
        # Forced resident: an impl the resident kernels serve at any N and
        # on any device; should_use_resident raises if the run is out of
        # their scope.
        return "pallas_sym2"
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
    kernel = _KERNELS.get(impl)
    if kernel is not None:
        return kernel(pos, mass, cfg.eps2)
    raise ValueError(f"unknown force impl {impl!r}")
