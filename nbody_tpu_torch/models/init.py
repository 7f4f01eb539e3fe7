"""Initial conditions: the uniform box of ``nbody_tpu/models/init.py``
(positions uniform per axis in [-max_pos, max_pos], masses uniform in
[min_mass, max_mass], velocities and accelerations zero).

Determinism comes from an explicit ``torch.Generator`` seeded with
``cfg.seed`` on the state's device.  Its numbers are not ``jax.random``'s,
so tests that compare the two packages start from shared numpy arrays.
The other presets (Plummer, disk, collision) come later.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig
from ..utils.device import require_device
from .state import SimState


def init_state(cfg: SimConfig,
               generator: Optional[torch.Generator] = None) -> SimState:
    device = require_device(cfg.device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    n, dtype = cfg.n_bodies, cfg.torch_dtype
    pos = torch.empty((n, 3), dtype=torch.float32, device=device).uniform_(
        -cfg.max_pos, cfg.max_pos, generator=generator).to(dtype)
    mass = torch.empty((n,), dtype=torch.float32, device=device).uniform_(
        cfg.min_mass, cfg.max_mass, generator=generator).to(dtype)
    zeros = torch.zeros((n, 3), dtype=dtype, device=device)
    return SimState(pos=pos, vel=zeros, acc=zeros.clone(), mass=mass)
