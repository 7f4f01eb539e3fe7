"""The resident kernels' plain path (K3 reference scheme, K4 kdk /
yoshida4) against the JAX package's resident kernels in interpret mode and
the float64 oracle, the port's padding and chaining contracts, and
``should_use_resident``'s force / raise / auto contracts.

On the CPU the wrappers run their plain twin (K2's plain version plus the
integrator, step by step); the kernels themselves are held against it on
the card by ``chip_smoke.py``.

Tolerances.  Port against JAX: per component, relative 1e-4 with an
absolute floor of 1e-6 of the array's largest magnitude; both are float32
exact tiers whose sums are taken in different orders (reassociation only,
two steps, before chaos amplifies it).  Port against the float64 oracle:
the 1% gate of ``nbody validate`` with absolute floors of 1.0 (positions),
1e-2 (velocities) and 1e-4 (accelerations).  Padding and chaining: exact.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.ops.resident import run_steps_resident as jax_resident
from nbody_tpu.oracle.numpy_oracle import oracle_forces, oracle_run
from nbody_tpu.oracle.numpy_oracle import relative_mismatch
from nbody_tpu_torch.models.state import pad_state_to
from nbody_tpu_torch.ops.forces_sym import SYM_TILE
from nbody_tpu_torch.ops import resident
from nbody_tpu_torch.ops.resident import (RESIDENT_AUTO_MAX_N,
                                          RESIDENT_AUTO_MIN_N,
                                          RESIDENT_MAX_N,
                                          run_steps_resident,
                                          run_steps_resident_plain,
                                          should_use_resident)

EPS2 = 0.002
INTEGRATORS = ["reference", "kdk", "yoshida4"]


def _inputs(n, seed):
    """Shared numpy inputs; acc is the seeded a(x_0) the KDK schemes
    consume (ignored by the reference scheme)."""
    pos, vel, mass = make_small_system(n, seed=seed)
    vel = vel + np.random.default_rng(seed).normal(
        scale=10.0, size=vel.shape).astype(np.float32)
    acc = oracle_forces(pos, mass, EPS2).astype(np.float32)
    return {"pos": pos, "vel": vel, "acc": acc, "mass": mass}


def _port_state(arrays):
    return nt.state_from_numpy(arrays, device="cpu")


def _close(got, want, what):
    scale = float(np.abs(want).max())
    bad = relative_mismatch(got, want, 1e-4, 1e-6 * scale)
    assert not bad.any(), f"{what}: {int(bad.sum())} components outside"


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_resident_matches_jax_interpret(integrator):
    n, steps = 600, 2
    arrays = _inputs(n, seed=71)
    jax_cfg = JaxSimConfig(n_bodies=n, integrator=integrator, eps2=EPS2)
    jax_out = jax_resident(
        JaxSimState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jax_cfg, steps, interpret=True, layout=(3, 256, 128))
    cfg = nt.SimConfig(n_bodies=n, integrator=integrator, eps2=EPS2,
                       impl="pallas_sym2", device="cpu")
    out = nt.state_to_numpy(run_steps_resident(_port_state(arrays), cfg,
                                               steps))
    for k in ("pos", "vel", "acc"):
        _close(out[k], np.asarray(getattr(jax_out, k)),
               f"{k} vs JAX resident ({integrator})")


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_resident_matches_f64_oracle(integrator):
    n, steps = 600, 2
    arrays = _inputs(n, seed=72)
    cfg = nt.SimConfig(n_bodies=n, integrator=integrator, eps2=EPS2,
                       impl="pallas_sym2", device="cpu")
    out = nt.state_to_numpy(run_steps_resident(_port_state(arrays), cfg,
                                               steps))
    ref = oracle_run(arrays["pos"], arrays["vel"], arrays["mass"], EPS2,
                     cfg.dt, steps, integrator=integrator)
    for k, want, floor in zip(("pos", "vel", "acc"), ref, (1.0, 1e-2, 1e-4)):
        bad = relative_mismatch(out[k], want, 0.01, floor)
        assert not bad.any(), f"{k} vs f64 oracle ({integrator})"


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_resident_zero_mass_padding_is_inert(integrator):
    """The kernels mask the ragged last tile as zero-mass bodies; padding
    the state with explicit zero-mass bodies must leave the real bodies'
    results bit-equal.  The padded bodies are real massless bodies to the
    port (its K2 sweeps their rows one-sided), so they feel the others."""
    n, steps = 600, 2
    arrays = _inputs(n, seed=73)
    cfg = nt.SimConfig(n_bodies=n, integrator=integrator, eps2=EPS2,
                       impl="pallas_sym2", device="cpu")
    state = _port_state(arrays)
    out = run_steps_resident(state, cfg, steps)
    padded = pad_state_to(state, 768)
    out_p = run_steps_resident(padded, cfg.replace(n_bodies=768), steps)
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(out_p, k)[:n], getattr(out, k)), k
    if integrator == "reference":
        want = oracle_forces(padded.pos.numpy(), padded.mass.numpy(),
                             EPS2)[n:]
        got = run_steps_resident(padded, cfg.replace(n_bodies=768),
                                 1).acc[n:].numpy()
        assert np.abs(got).max() > 0
        assert not relative_mismatch(got, want, 1e-4, 1e-6).any()


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_resident_chaining_2_plus_3_equals_5(integrator):
    arrays = _inputs(300, seed=74)
    cfg = nt.SimConfig(n_bodies=300, integrator=integrator, eps2=EPS2,
                       impl="pallas_sym2", device="cpu")
    state = _port_state(arrays)
    a = run_steps_resident(run_steps_resident(state, cfg, 2), cfg, 3)
    b = run_steps_resident(state, cfg, 5)
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_resident_equals_per_step_sym2_and_launches_nothing_on_cpu():
    """The plain path is the per-step K2 path, so bit-equality with
    ``run_steps(impl="pallas_sym2")`` holds exactly here (on the card
    ``chip_smoke.py`` checks it for the kernels); CPU tensors never launch
    a kernel."""
    arrays = _inputs(300, seed=75)
    cfg = nt.SimConfig(n_bodies=300, impl="pallas_sym2", device="cpu")
    before = (resident.resident_steps.launches,
              resident.resident_steps_kdk.launches)
    out = run_steps_resident(_port_state(arrays), cfg, 3)
    ref = nt.run_steps(_port_state(arrays), cfg, 3, impl="pallas_sym2")
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(out, k), getattr(ref, k)), k
    plain = run_steps_resident_plain(_port_state(arrays), cfg, 3)
    assert torch.equal(plain.pos, out.pos)
    assert before == (resident.resident_steps.launches,
                      resident.resident_steps_kdk.launches)
    same = run_steps_resident(_port_state(arrays), cfg, 0)
    assert torch.equal(same.pos, _port_state(arrays).pos)


def test_should_use_resident_contracts():
    def cfg(**kw):
        return nt.SimConfig(**{"n_bodies": 8192, "device": "cpu", **kw})

    # False disables, True forces in scope, None is the measured window.
    assert not should_use_resident(cfg(resident=False), "pallas_sym2")
    assert should_use_resident(cfg(n_bodies=512, resident=True),
                               "pallas_sym2")
    assert should_use_resident(cfg(integrator="yoshida4", resident=True),
                               "pallas_sym2")
    for n in (RESIDENT_AUTO_MIN_N, RESIDENT_AUTO_MAX_N):
        assert should_use_resident(cfg(n_bodies=n), "pallas_sym2")
    assert not should_use_resident(cfg(n_bodies=RESIDENT_AUTO_MAX_N + 1),
                                   "pallas_sym2")
    assert not should_use_resident(cfg(), "pallas")
    # Out of scope: auto quietly declines, True raises naming each reason.
    for kw, impl, reason in (({"dtype": "float64"}, "xla", "dtype"),
                             ({}, "pallas", "impl='pallas'"),
                             ({"n_bodies": RESIDENT_MAX_N + 1},
                              "pallas_sym2", "budget")):
        assert not should_use_resident(cfg(**kw), impl)
        with pytest.raises(ValueError, match=reason):
            should_use_resident(cfg(resident=True, **kw), impl)
    with pytest.raises(ValueError, match="dtype.*impl"):
        should_use_resident(cfg(resident=True, dtype="float64"), "xla")
    assert should_use_resident(cfg(n_bodies=RESIDENT_MAX_N, resident=True),
                               "pallas_sym2")
    # Auto routing on the card resolves impl=auto to K2 at N=8192.
    card = nt.SimConfig(n_bodies=8192)
    assert should_use_resident(card, nt.resolve_impl(card)) == (
        RESIDENT_AUTO_MIN_N <= 8192 <= RESIDENT_AUTO_MAX_N)


def test_should_use_resident_on_a_mesh():
    """A sharded run never takes the resident kernels: auto declines even
    inside the window, and forcing them raises, out-of-scope reasons
    first (the one refusal ``Simulation`` and ``run_benchmark`` share)."""
    def cfg(**kw):
        return nt.SimConfig(**{"n_bodies": 8192, "device": "cpu", **kw})

    assert should_use_resident(cfg(), "pallas_sym2")
    assert not should_use_resident(cfg(), "pallas_sym2", sharded=True)
    assert not should_use_resident(cfg(resident=False), "pallas_sym2",
                                   sharded=True)
    with pytest.raises(ValueError, match="mesh routing"):
        should_use_resident(cfg(resident=True), "pallas_sym2", sharded=True)
    with pytest.raises(ValueError, match="dtype"):
        should_use_resident(cfg(resident=True, dtype="float64"), "xla",
                            sharded=True)
    from nbody_tpu_torch.bench_lib import run_benchmark
    with pytest.raises(ValueError, match="mesh routing"):
        run_benchmark(n=512, steps=1, impl="pallas_sym2", resident=True,
                      device="cpu", shards=2)


@pytest.mark.parametrize("nb, grids", [
    (1, (1, 264)), (2, (1, 2, 3)), (3, (2, 264)), (4, (1, 3, 7, 264)),
    (5, (4, 15)), (31, (7, 132, 264)), (32, (1, 132, 264, 528, 1000)),
    (33, (132, 264)), (128, (264, 528)),
    (RESIDENT_MAX_N // SYM_TILE, (264, 1000))])
def test_resident_work_assignment_mirror(nb, grids):
    """The kernels' work assignment, as ``ops/resident.py`` mirrors it:
    over the grids, every diagonal item and every (row tile, offset) item
    runs exactly once a step, the skipped half offset never; every pair of
    distinct row tiles meets in exactly one item; each tile gets the nb
    contributions at which it is finished."""
    items = resident.work_items(nb)
    assert len(items) == nb * (nb + 1) // 2
    for grid in grids:
        g = resident.resident_grid(nb, grid)
        assert 1 <= g <= min(grid, len(items))
        seen = Counter(it for blk in range(g)
                       for it in resident.block_items(nb, g, blk))
        assert set(seen.values()) == {1} and sum(seen.values()) == len(items)
    assert sorted(i for i, d in items if d == 0) == list(range(nb))
    pairs = Counter()
    for i, d in items:
        if d:
            assert 1 <= d <= nb // 2
            assert not (2 * d == nb and 2 * i >= nb), (i, d)
            pairs[frozenset((i, (i + d) % nb))] += 1
    assert len(pairs) == nb * (nb - 1) // 2 and set(pairs.values()) <= {1}
    expected = {(i, d) for d in range(1, nb // 2 + 1) for i in range(nb)
                if not (2 * d == nb and 2 * i >= nb)}
    assert {it for it in items if it[1]} == expected
    # Each tile gets nb contributions, at which the kernels finish it.
    count = Counter()
    for i, d in items:
        count[i] += 1
        if d:
            count[(i + d) % nb] += 1
    assert [count[i] for i in range(nb)] == [nb] * nb


@pytest.mark.parametrize("n, grids", [
    (1, (1, 264)), (255, (1, 264)), (1000, (10, 264)), (8192, (132, 264)),
    (12288, (264,)), (65536, (264, 1000)), (RESIDENT_MAX_N, (264,))])
def test_resident_finish_owns_each_body_once(n, grids):
    """Every body of a tile's finish (phase (b)) is owned by exactly one
    thread: over the grids, each group of 32 bodies runs on exactly one
    (block, warp) inside the grid and the warps that take groups, and lane
    l of it takes body 32 q + l."""
    nb = -(-n // SYM_TILE)
    for grid in grids:
        groups = resident.finish_groups(nb, grid)
        wa = resident.group_warps(nb, grid)
        assert 1 <= wa <= resident.GROUPS_PER_TILE
        assert all(0 <= blk < grid and 0 <= w < wa for blk, w in groups)
        owners = Counter(q for qs in groups.values() for q in qs)
        assert set(owners.values()) == {1}
        assert sorted(owners) == list(range(resident.GROUPS_PER_TILE * nb))
        bodies = Counter(32 * q + lane for q in owners for lane in range(32))
        assert set(bodies.values()) == {1}
        assert all(b in bodies for b in range(n))
        # One round: no warp holds two groups where the grid has room.
        if resident.GROUPS_PER_TILE * nb <= grid * resident.GROUPS_PER_TILE:
            assert max(len(qs) for qs in groups.values()) == 1
