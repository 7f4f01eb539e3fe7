"""The shard mesh: ``make_mesh``, ``SHARD_AXIS``, ``shard_state`` and the
placement of each shard, as in ``nbody_tpu/parallel/mesh.py``.

The JAX package lays the bodies over a 1-D ``jax.sharding.Mesh`` and runs
the ring inside one ``shard_map`` program, where ``lax.ppermute`` and
``all_gather`` are compiled onto the TPU's ICI links.  The port keeps what
that buys, P shards that each own a slice of the bodies and meet the
others' slices in P hops, with a mesh that is a list of devices: shard i
lives on CUDA device ``i % torch.cuda.device_count()``, or on the CPU when
the caller asks for it.  On one card all P shards share the device, as the
JAX test suite runs its ring on 8 virtual CPU devices; then a hop moves no
bytes, and what a run measures is the schedule and its kernels, not
communication.  Across cards a hop is a peer copy (``Tensor.to``).

What does not survive: the born-sharded ``jit`` out_shardings (the state
is made on one device and split; on the card a shard is a view until it
moves).  The bounded mesh (``parallel/multiprog.py``) is the ring's host
loop cut into programs, and the mesh's energy (``parallel/energy.py``)
the halved ring of K8 row sums.  A collective backend for several
processes (``torch.distributed``) is out of scope: the JAX package is one
process (nothing in it calls ``jax.distributed``), and one process here
already places a shard on every card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.state import SimState

# The name of the mesh's one axis in the JAX package's ``shard_map``; the
# port's collectives address shards by position, so nothing here reads it.
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[i]`` holds shard i."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        """One line naming where each shard lives."""
        by_dev: dict = {}
        for i, d in enumerate(self.devices):
            by_dev.setdefault(str(d), []).append(i)
        parts = [f"shards {','.join(map(str, ids))} on {d}"
                 for d, ids in by_dev.items()]
        note = (" (one device: hops move no bytes)" if len(by_dev) == 1
                and self.size > 1 else "")
        return f"mesh: {self.size} shards; " + "; ".join(parts) + note


def make_mesh(n_shards: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of ``n_shards`` shards (default: one per card).  Shard i goes
    to CUDA device ``i % torch.cuda.device_count()`` for ``device="cuda"``,
    or to the CPU for ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(device='cuda') but torch.cuda.is_available() is "
                "False; pass device='cpu' for a mesh on the CPU")
        count = torch.cuda.device_count()
        n = n_shards or count
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    elif device.type == "cpu":
        devices = (torch.device("cpu"),) * (n_shards or 1)
    else:
        raise ValueError(f"make_mesh: no mesh on device {device}")
    if not devices:
        raise ValueError("make_mesh: n_shards must be positive")
    return Mesh(devices=devices)


def shard_state(state: SimState, mesh: Mesh) -> List[SimState]:
    """Split a state whose N the mesh size divides into one state per
    shard, each on its shard's device."""
    n = state.n
    if n % mesh.size:
        raise ValueError(f"shard_state: N={n} is not divisible by "
                         f"{mesh.size} shards; pad first (shard_padding)")
    c = n // mesh.size
    return [SimState(*(t[i * c:(i + 1) * c].to(d) for t in state))
            for i, d in enumerate(mesh.devices)]


def gather_state(shards: List[SimState], device=None) -> SimState:
    """The inverse of ``shard_state``: the shards concatenated in order on
    ``device`` (default: shard 0's)."""
    device = device or shards[0].pos.device
    return SimState(*(torch.cat([getattr(s, k).to(device) for s in shards])
                      for k in SimState._fields))
