"""The total energy of a state on a mesh: ``total_energy_sharded``, as in
``nbody_tpu/parallel/energy.py``, on kernel K8's row sums
(``ops/pe.py::pe_rows``).

``Simulation`` takes it for a mesh run past ``MAX_HOST_ENERGY_N`` bodies
(``run --shards P --energy``), where the JAX package does.  The energy is
computed where the shards live, with no shard holding the whole N^2 work:

- each shard sums ``m_i m_j (|r|^2 + eps2)^(-1/2)`` of its rows against a
  visiting shard that walks the ring (``LocalComm.ppermute``: no bytes on
  one card, a peer copy across cards), the force ring's pattern;
- symmetry halves the sweep: rotations k and P-k cover the same unordered
  shard pairs, so only k = 0 .. P//2 run: the self shard once, each cross
  rotation with weight 2, and for even P the antipodal rotation once (both
  orderings of its pairs are already present across the shards);
- each shard's rows go in ``_row_chunks`` pieces of at most
  ``max_prog_pairs / c`` rows (whole tiles, at most two sizes).
  A (rotation, chunk) is one program: one K8 launch per shard, float32 in
  and float64 row sums out, added in float64 on the shard's device.
  ``progress(done, total, None)`` runs after each program, the heartbeat
  contract of the bounded dispatch (``Simulation``'s
  ``_ProgressHeartbeat`` waits for the card only when it prints);
- K8 is mask-free, so each row's self term is subtracted in float64, as
  the JAX package's kernel flavor subtracts their total; here each row's
  own, from its row sum in the self rotation, so that the float64 sums
  hold pair-sized numbers and not the self terms, which are ~7,000 times
  larger at N = 300 in the reference's ranges (a row chunking then moves
  the total by ~1e-16, not by one ulp of the self total).  The term
  subtracted is the one K8 adds, ``m_i^2 rsqrt(float32(eps2))`` with the
  rsqrt rounded as the shard's device rounds it (``torch.rsqrt``:
  rsqrtf's bits on a card, which K8's ``rsqrt_normal`` gives for every
  d2 >= eps2; correctly rounded on the CPU, as in ``pe_rows_plain``), not
  JAX's closed form ``m^2 / sqrt(eps2)``: the two differ by the same few
  1e-7 in every row, which the self terms' weight turns into a bias of
  the energy (8.0e-5 at N = 8192 on the card).  The kinetic energy is
  summed per shard in float64.

What changes from the JAX package: the chunks bound the host's silence,
not a program's run time (the card has no program kill, as in
``parallel/multiprog.py``).  JAX's ``block_u`` and ``block_i`` were the
Pallas kernel's VMEM blocks and go: K8's tile, ``PE_TILE``, is the unit of
both the padding (zero-mass ghosts up to a multiple of ``P * PE_TILE``,
so each shard's tiles align with ``pe_total``'s) and the row chunks.
``use_pallas`` goes too: the shard's
device chooses, K8 on a card and its plain twin ``pe_rows_plain`` on the
CPU, as in every port wrapper, and the JAX package's masked XLA flavor has
no counterpart.  On one card the shards share the device, so the sweep
does 0.75 N^2 pair terms at P = 4 against ``pe_total``'s N^2 / 2 on the
gathered state; the one-device shortcut would be a route the JAX package
does not have.
"""

from __future__ import annotations

import torch

from ..models.energy import MAX_HOST_ENERGY_N  # noqa: F401  (re-export:
#    Simulation routes on it; the one definition lives with energy_f64)
from ..models.state import pad_state_to, round_up
from ..ops.pe import PE_TILE, pe_rows
from .mesh import Mesh, shard_state
from .ring import LocalComm


def _row_chunks(c: int, block_i: int, max_prog_pairs: float):
    """Split a shard's c rows into (offset, rows) chunks of at most
    ``max_prog_pairs / c`` rows each, block_i-aligned, sizes differing by
    at most one block (so at most two chunk shapes)."""
    blocks = c // block_i
    target = max(1, int(max_prog_pairs // max(c, 1)) // block_i)
    n_chunks = max(1, -(-blocks // target))
    base, extra = divmod(blocks, n_chunks)
    sizes = [(base + 1) * block_i] * extra + [base * block_i] * (
        n_chunks - extra)
    out, off = [], 0
    for s in sizes:
        out.append((off, s))
        off += s
    return out


def energy_plan(p: int) -> "list[tuple[bool, float]]":
    """The halved sweep over a ring of ``p`` shards, as (rotate first?,
    weight) a rotation: the self shard, the cross rotations k = 1 ..
    (p-1)//2 twice, and for even p the antipodal rotation once."""
    plan = [(False, 1.0)]
    plan += [(True, 2.0)] * ((p - 1) // 2)
    if p % 2 == 0 and p > 1:
        plan += [(True, 1.0)]
    return plan


def total_energy_sharded(state, eps2: float, mesh: Mesh,
                         max_prog_pairs: float = 3e11,
                         progress=None) -> float:
    """Total (kinetic + softened potential) energy of ``state`` computed
    on ``mesh`` shard by shard, with no shard sweeping the whole N^2 and
    no program of more than ``max_prog_pairs`` pairs a shard.  Returns a
    host float.  ``progress``: optional ``f(done, total, None)`` after
    each (rotation, row chunk) program."""
    p = mesh.size
    state = pad_state_to(state, round_up(state.n, p * PE_TILE))
    shards = shard_state(state, mesh)
    c = shards[0].n
    chunks = _row_chunks(c, PE_TILE, max_prog_pairs)
    plan = energy_plan(p)
    comm = LocalComm(mesh)
    fwd = [(i, (i + 1) % p) for i in range(p)]

    pos = [s.pos.float().contiguous() for s in shards]
    mass = [s.mass.float().contiguous() for s in shards]
    m64 = [m.double() for m in mass]
    ke = [0.5 * torch.sum(m * torch.sum(s.vel.double() ** 2, dim=-1))
          for m, s in zip(m64, shards)]
    # K8's self term, rsqrt(eps2) as the card rounds it: one host read for
    # the mesh, before any shard's launches are queued.
    rs = float(torch.rsqrt(torch.tensor(eps2, dtype=torch.float32,
                                        device=m64[0].device)))
    self_rows = [m * m * rs for m in m64]
    pe = [torch.zeros((), dtype=torch.float64, device=x.device)
          for x in pos]
    vpos, vmass = pos, mass
    done, total = 0, len(plan) * len(chunks)
    for rotate, w in plan:
        if rotate:
            vpos, vmass = comm.ppermute(vpos, fwd), comm.ppermute(vmass, fwd)
        for off, rows in chunks:
            for i in range(p):
                part = pe_rows(pos[i][off:off + rows],
                               mass[i][off:off + rows], vpos[i], vmass[i],
                               eps2)
                if not rotate:
                    part = part - self_rows[i][off:off + rows]
                pe[i] += w * part.sum()
            done += 1
            if progress is not None:
                progress(done, total, None)
    return sum(float(k) - 0.5 * float(v) for k, v in zip(ke, pe))
