"""The mesh's energy (``nbody_tpu_torch/parallel/energy.py``) against the
JAX package's ``nbody_tpu/parallel/energy.py`` and the host float64
energy, on the same seeded numpy states (``_mesh_state``, as in
``tests/test_energy.py``), on a mesh of CPU shards, where each shard's K8
launch is its plain twin ``pe_rows_plain``.

Tolerances.  The port's sweep is K8's mask-free class: each row's self
term ``m^2 rsqrt(eps2)`` rides in a float32 tile partial and is taken
out in float64 afterwards, at the value the kernel adds.  At N = 300 in
the reference's ranges the self term is ~7,000 times a row's pair sum, so
the partials' rounding leaves ~1e-5 to 1e-3 of the energy: the port's
sweep is 2.2e-5 from host float64 on every P, JAX's mask-free kernel
flavor (Pallas in interpret mode, the closed-form self total) 1.9e-4 to
1.1e-3.  The port is held to 5e-5 against host float64 and JAX's masked
XLA flavor, and to the JAX package's own class tolerance, 2e-3, against
JAX's kernel flavor.  Re-chunking the rows changes only the float64
order in which row sums meet: rel 1e-12.
"""

import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
import nbody_tpu_torch.parallel.energy as penergy
from conftest import make_small_system
from nbody_tpu.models.state import SimState as JState
from nbody_tpu.parallel.energy import total_energy_sharded as jax_sharded
from nbody_tpu.parallel.mesh import make_mesh as jax_mesh
from nbody_tpu_torch.models.energy import energy_f64
from nbody_tpu_torch.models.state import SimState
from nbody_tpu_torch.ops import pe
from nbody_tpu_torch.parallel.mesh import make_mesh

EPS2 = 0.002
PORT_CLASS = 5e-5     # the port's sweep at N = 300 (module docstring)
CLASS = 2e-3          # the JAX package's mask-free class tolerance


def _mesh_state(n, seed=70, moving=False):
    """The JAX test's state: ``make_small_system`` positions and masses,
    zero velocities (seeded ones with ``moving``).  Returns (the port's
    SimState, JAX's)."""
    import jax.numpy as jnp
    pos, vel, mass = make_small_system(n, seed=seed)
    if moving:
        vel = np.random.default_rng(seed + 1000).uniform(
            -50, 50, (n, 3)).astype(np.float32)
    port = SimState(*(torch.as_tensor(a) for a in
                      (pos, vel, np.zeros((n, 3), np.float32), mass)))
    jax = JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                 acc=jnp.zeros((n, 3), jnp.float32), mass=jnp.asarray(mass))
    return port, jax


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every case runs small sweeps on the CPU: torch's intra-op threads
    only contend with the other test workers' there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def state300():
    return _mesh_state(300)


@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_sharded_energy_matches_host_and_jax(state300, p):
    port, jstate = state300
    e = penergy.total_energy_sharded(port, EPS2, make_mesh(p, "cpu"))
    e_host = energy_f64(port, EPS2)
    np.testing.assert_allclose(e, e_host, rtol=PORT_CLASS)
    mesh = jax_mesh(p)
    e_xla = jax_sharded(jstate, EPS2, mesh, block_i=8, block_u=64,
                        use_pallas=False)
    np.testing.assert_allclose(e, e_xla, rtol=PORT_CLASS)
    e_kernel = jax_sharded(jstate, EPS2, mesh, block_i=8, block_u=64,
                           use_pallas=True)
    np.testing.assert_allclose(e, e_kernel, rtol=CLASS)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
def test_sharded_energy_is_pe_rows_of_the_whole_set(p):
    """The halved ring adds up every ordered pair once: its potential is
    the row sums of the whole set (the same tiles at P = 1), so the
    energy agrees with ``total_energy_bounded``'s (K8's ``pe_total``) to
    the float32 partials' rounding, far inside the class."""
    port, _ = _mesh_state(700, seed=74, moving=True)
    e = penergy.total_energy_sharded(port, EPS2, make_mesh(p, "cpu"))
    pos, mass = port.pos, port.mass
    ke = float(0.5 * (mass.double() * (port.vel.double() ** 2).sum(1))
               .sum())
    pot = float(pe.pe_rows_plain(pos, mass, pos, mass, EPS2).sum())
    pot -= float((mass.double() ** 2).sum()) / EPS2 ** 0.5
    np.testing.assert_allclose(e, ke - 0.5 * pot, rtol=5e-5)
    np.testing.assert_allclose(
        e, nt.models.energy.total_energy_bounded(port, EPS2), rtol=5e-5)


def test_energy_plan_halves_the_ring():
    """Weights add up to P rotations: every ordered shard pair once."""
    for p in range(1, 10):
        plan = penergy.energy_plan(p)
        assert len(plan) == p // 2 + 1
        assert sum(w for _, w in plan) == p
        assert not plan[0][0] and all(r for r, _ in plan[1:])


def test_bounded_split_calls_progress_per_program():
    """A small max_prog_pairs cuts each shard's rows into tile-aligned
    chunks: a progress call a (rotation, chunk), the same energy."""
    port, _ = _mesh_state(3000, seed=71)
    mesh = make_mesh(4, "cpu")
    e1 = penergy.total_energy_sharded(port, EPS2, mesh)
    calls = []
    e2 = penergy.total_energy_sharded(
        port, EPS2, mesh, max_prog_pairs=1024 * 256,
        progress=lambda d, t, a: calls.append((d, t, a)))
    c = 768                                  # 3000 padded to 4 x 768
    chunks = penergy._row_chunks(c, pe.PE_TILE, 1024 * 256)
    assert chunks == [(0, 256), (256, 256), (512, 256)]
    total = len(penergy.energy_plan(4)) * len(chunks)
    assert calls == [(d, total, None) for d in range(1, total + 1)]
    np.testing.assert_allclose(e2, e1, rtol=1e-12)


def test_row_chunks_match_jax():
    from nbody_tpu.parallel.energy import _row_chunks as jax_chunks
    for c, b, cap in ((1 << 20, 256, 3e11), (256, 8, 2000), (3072, 256, 1e6),
                      (1 << 18, 256, 1e12), (4096, 512, 5e5)):
        assert penergy._row_chunks(c, b, cap) == jax_chunks(c, b, cap)
    # 4M on 4 shards: 4 chunks of 262,144 rows, 12 programs an energy.
    chunks = penergy._row_chunks(1 << 20, 256, 3e11)
    assert chunks == [(k << 18, 1 << 18) for k in range(4)]
    assert len(penergy.energy_plan(4)) * len(chunks) == 12


def test_shard_size_not_a_multiple_of_2048():
    """JAX's review-r4 case: c = 3072 on 2 shards, a shard size that is a
    multiple of the tile and not of 2048."""
    port, jstate = _mesh_state(6144, seed=73)
    e = penergy.total_energy_sharded(port, EPS2, make_mesh(2, "cpu"))
    e_jax = jax_sharded(jstate, EPS2, jax_mesh(2), block_i=256,
                        block_u=1024, use_pallas=False)
    # At N = 6144 the self term is ~350 times a row's pair sum: 1.9e-6.
    np.testing.assert_allclose(e, e_jax, rtol=1e-5)
    np.testing.assert_allclose(e, energy_f64(port, EPS2), rtol=1e-5)


def test_zero_mass_padding_adds_nothing():
    """N = 100 on 3 shards pads to 768 with zero-mass ghosts; the ghosts
    add nothing, so the energy equals that of the state padded by hand to
    768 bodies bit for bit, and the host float64 energy within the class
    (the self terms are ~20,000 times the pair sums at N = 100)."""
    from nbody_tpu_torch.models.state import pad_state_to
    port, _ = _mesh_state(100, seed=75)
    mesh = make_mesh(3, "cpu")
    e = penergy.total_energy_sharded(port, EPS2, mesh)
    assert e == penergy.total_energy_sharded(pad_state_to(port, 768), EPS2,
                                             mesh)
    np.testing.assert_allclose(e, energy_f64(port, EPS2), rtol=CLASS)


def test_reexports_the_host_wall():
    from nbody_tpu.parallel import energy as jpenergy
    assert penergy.MAX_HOST_ENERGY_N == jpenergy.MAX_HOST_ENERGY_N == 262144


def test_simulation_mesh_track_energy_routes_sharded(monkeypatch):
    """Past the host wall, track_energy on a mesh run computes on the mesh
    (parallel/energy.py), never through the host energy_f64."""
    import nbody_tpu_torch.models.simulation as simmod

    def _boom(*a, **k):
        raise AssertionError("host energy_f64 used past the wall on a mesh")

    monkeypatch.setattr(simmod, "energy_f64", _boom)
    monkeypatch.setattr(penergy, "MAX_HOST_ENERGY_N", 64)
    sharded_calls = []
    real = penergy.total_energy_sharded

    def spy(state, eps2, mesh, **kw):
        sharded_calls.append(state.n)
        return real(state, eps2, mesh, **kw)

    monkeypatch.setattr(penergy, "total_energy_sharded", spy)
    n = 256
    state, _ = _mesh_state(n, seed=72)
    cfg = nt.SimConfig(n_bodies=n, impl="xla", chunk=64, device="cpu")
    sim = nt.Simulation(cfg, state=state, mesh=make_mesh(4, "cpu"))
    res = sim.run(n_steps=2, log_every=0, track_energy=True)
    assert sharded_calls == [n, n]
    assert res.energy_drift is not None and res.energy_drift < 1e-3


def test_single_device_run_keeps_energy_f64(monkeypatch):
    """Without a mesh the threshold does not matter: energy_f64 (which
    delegates to K8's pe_total past its own wall)."""
    monkeypatch.setattr(penergy, "MAX_HOST_ENERGY_N", 64)

    def _boom(*a, **k):
        raise AssertionError("the mesh energy on a single-device run")

    monkeypatch.setattr(penergy, "total_energy_sharded", _boom)
    n = 256
    state, _ = _mesh_state(n, seed=72)
    sim = nt.Simulation(nt.SimConfig(n_bodies=n, impl="xla", device="cpu"),
                        state=state)
    res = sim.run(n_steps=2, log_every=0, track_energy=True)
    assert res.energy_drift is not None and res.energy_drift < 1e-3


def test_cli_run_shards_energy_takes_the_mesh(monkeypatch, capsys):
    """``run --shards P --energy`` reaches the mesh energy with no new
    flag; with a bound that cuts it into programs the heartbeat prints
    each one (3 rotations x 2 row chunks = 6 programs at N = 2048)."""
    from nbody_tpu_torch import cli
    monkeypatch.setattr(penergy, "MAX_HOST_ENERGY_N", 64)
    calls = []
    real = penergy.total_energy_sharded

    def spy(state, eps2, mesh, **kw):
        calls.append(mesh.size)
        return real(state, eps2, mesh, max_prog_pairs=512 * 256, **kw)

    monkeypatch.setattr(penergy, "total_energy_sharded", spy)
    assert cli.main(["run", "--n", "2048", "--steps", "1", "--shards", "4",
                     "--impl", "pallas_sym2", "--prog-cap", "5e4",
                     "--energy", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert calls == [4, 4]
    assert out.count("force eval: 6/6 programs") == 2
    assert "energy drift" in out.lower()
