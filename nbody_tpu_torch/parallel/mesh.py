"""The shard mesh: ``make_mesh``, ``SHARD_AXIS``, ``shard_state`` and the
placement of each shard, as in ``nbody_tpu/parallel/mesh.py``.

The JAX package lays the bodies over a 1-D ``jax.sharding.Mesh`` and runs
the ring inside one ``shard_map`` program, where ``lax.ppermute`` and
``all_gather`` are compiled onto the TPU's ICI links.  The port keeps what
that buys, P shards that each own a slice of the bodies and meet the
others' slices in P hops, with a mesh that is a list of devices
(``placement``): ``make_mesh(P, "cuda")`` puts shard i on card ``i %
torch.cuda.device_count()``, the JAX package's device i whenever P is at
most the card count; ``make_mesh(P, "cuda:k")`` puts every shard on card
k; ``"cpu"`` puts them on the CPU.  On one card all P shards share the
device, as the JAX test suite runs its ring on 8 virtual CPU devices; then
a hop moves no bytes, and what a run measures is the schedule and its
kernels, not communication.  Across cards a hop is a peer copy
(``Tensor.to``, queued behind the copy on the receiving card's stream),
every kernel is launched with its shard's card current
(``ops/_build.py``), and K13's hops are peer stores inside its launches:
a mesh on more than one card enables peer access between every pair of
its cards when it is made, and raises if a pair cannot reach each other.

What does not survive: the born-sharded ``jit`` out_shardings (the state
is made on one device and split; on the card a shard is a view until it
moves); and ``body_sharding``, a ``jax.sharding.NamedSharding`` that
tells XLA to split a global array over the mesh: here ``shard_state``
splits it and each shard is its own tensor.  The bounded mesh
(``parallel/multiprog.py``) is the ring's host loop cut into programs,
and the mesh's energy (``parallel/energy.py``) the halved ring of K8 row
sums.  A collective backend for several
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
        """One line naming each device's shards and the ring hops (shard i
        to i + 1) that cross from one card to another."""
        by_dev: dict = {}
        for i, d in enumerate(self.devices):
            by_dev.setdefault(str(d), []).append(i)
        parts = [f"shards {','.join(map(str, ids))} on {d}"
                 for d, ids in by_dev.items()]
        if len(by_dev) == 1:
            note = " (one device: hops move no bytes)" if self.size > 1 else ""
        else:
            cross = [f"{i}->{(i + 1) % self.size}" for i in range(self.size)
                     if self.devices[i] != self.devices[(i + 1) % self.size]]
            note = (f"; hops across cards: {', '.join(cross)}" if cross
                    else "; no hop crosses cards")
        return f"mesh: {self.size} shards; " + "; ".join(parts) + note


def placement(n_shards: int, device: str, card_count: int) -> "list[str]":
    """Where each of ``n_shards`` shards lives, as device strings: for
    ``"cuda"`` shard i on ``cuda:{i % card_count}``, for ``"cuda:k"`` every
    shard on ``cuda:k``, for ``"cpu"`` every shard on the CPU.  A pure
    function of its arguments (``make_mesh`` passes the card count)."""
    if n_shards < 1:
        raise ValueError("make_mesh: n_shards must be positive")
    kind, _, index = str(device).partition(":")
    if kind == "cpu":
        return ["cpu"] * n_shards
    if kind != "cuda":
        raise ValueError(f"make_mesh: no mesh on device {device}")
    if card_count < 1:
        raise RuntimeError(
            "make_mesh(device='cuda') but no CUDA card is available; pass "
            "device='cpu' for a mesh on the CPU")
    if index:
        if not 0 <= int(index) < card_count:
            raise ValueError(f"make_mesh: {device} but the host has "
                             f"{card_count} card(s)")
        return [f"cuda:{int(index)}"] * n_shards
    return [f"cuda:{i % card_count}" for i in range(n_shards)]


def make_mesh(n_shards: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of ``n_shards`` shards (default: one per card, or one on the
    CPU) placed by ``placement``; a mesh on more than one card has peer
    access enabled between every pair of its cards."""
    device = torch.device(device)
    count = 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(device='cuda') but torch.cuda.is_available() is "
                "False; pass device='cpu' for a mesh on the CPU")
        count = torch.cuda.device_count()
    n = n_shards or (count if device.type == "cuda" and device.index is None
                     else 1)
    devices = tuple(torch.device(d) for d in placement(n, str(device), count))
    if len(set(devices)) > 1:
        from .rdma_ring import enable_peers
        enable_peers(devices)
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
