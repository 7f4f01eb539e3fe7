"""The port's sharded path (``parallel/mesh.py``, ``parallel/ring.py``): P
shards in one process on a CPU mesh, against the JAX package's
``run_steps_sharded`` on P of the 8 virtual CPU devices, against the
port's own single-device run, and against the float64 oracle.

Both packages start from the same seeded numpy arrays.  The JAX config
uses ``block_i = block_j = block_u = 256``: its shards are then padded as
the port's (N to a multiple of 256 P) and its rect tiles are the port's
256 x 256 tiles, so the tensor-core tiers group their per-tile correction
alike; the one-sided tensor-core tiers and K12 sweep JAX's rect kernel at
``block_j = 128``, the port's j tile (``TC_TILE_J``, ``FAST_TILE_J``),
where they apply their per-tile correction and centre their expansion.
N = 128 P - 40 keeps at most 128 real bodies a device (the conftest's
envelope for interpret-mode Pallas) and puts ghosts in the last shards.
Tolerance, per component of pos, vel and acc after the steps (``TOLS``):
rel 1e-4 + 1e-6·max for the exact impls, rel 1e-3 + 1e-4·max for the
tensor-core tiers (their twins' tolerance against JAX), rel 5e-3 +
1e-4·max for K12 (both sides carry the centred expansion's cancellation
error, as in tests/test_torch_forces_fast.py).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.oracle.numpy_oracle import (oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu.parallel.mesh import SHARD_AXIS as JAX_SHARD_AXIS
from nbody_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nbody_tpu.parallel.ring import prime_kdk_sharded as jax_prime
from nbody_tpu.parallel.ring import run_steps_sharded as jax_run
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops import forces_sym
from nbody_tpu_torch.ops.forces_fast import FAST_TILE_J
from nbody_tpu_torch.ops.forces_tiled_tc import TC_TILE_J
from nbody_tpu_torch.parallel.mesh import (SHARD_AXIS, gather_state,
                                           make_mesh, shard_state)
from nbody_tpu_torch.parallel.ring import (LocalComm, _local_force_fn,
                                           prime_kdk_sharded,
                                           run_steps_sharded, shard_padding)

IMPLS = ("xla", "pallas", "pallas_sym", "pallas_sym2", "pallas_sym_turbo",
         "pallas_sym_turbo2")
# The rest of the sharded impls, held to JAX by the same test.
MORE_IMPLS = ("pallas_sym_mxu", "pallas_kahan", "pallas_turbo", "pallas_mxu",
              "pallas_fast")
# Per-component tolerance against JAX, (rel, floor of the largest |x|).
EXACT_TOL, TC_TOL, FAST_TOL = (1e-4, 1e-6), (1e-3, 1e-4), (5e-3, 1e-4)
TOLS = {"pallas_sym_turbo": TC_TOL, "pallas_sym_turbo2": TC_TOL,
        "pallas_sym_mxu": TC_TOL, "pallas_turbo": TC_TOL,
        "pallas_mxu": TC_TOL, "pallas_fast": FAST_TOL}
# The JAX rect kernel's j tile for the one-sided sweeps: the port's.
JAX_BLOCK_J = {"pallas_turbo": TC_TILE_J, "pallas_mxu": TC_TILE_J,
               "pallas_fast": FAST_TILE_J}


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


def arrays(n, seed):
    pos, vel, mass = make_small_system(n, seed=seed)
    return pos, vel, np.zeros((n, 3), np.float32), mass


def port_state(arrs):
    return nt.SimState(*(torch.from_numpy(np.array(a)) for a in arrs))


def jax_state(arrs):
    return JaxSimState(*(jnp.asarray(a) for a in arrs))


def jax_cfg(n, impl, integrator="reference"):
    return JaxSimConfig(n_bodies=n, impl=impl, integrator=integrator,
                        block_i=256, block_j=JAX_BLOCK_J.get(impl, 256),
                        block_u=256, chunk=64)


def port_cfg(n, impl, integrator="reference"):
    return nt.SimConfig(n_bodies=n, impl=impl, integrator=integrator,
                        chunk=64, device="cpu")


def assert_states_close(port_out, jax_out, impl, what):
    rel, floor = TOLS.get(impl, EXACT_TOL)
    for k in ("pos", "vel", "acc"):
        got = getattr(port_out, k).numpy()
        want = np.asarray(getattr(jax_out, k))
        bad = relative_mismatch(got, want, rel, floor * np.abs(want).max())
        assert bad.sum() == 0, (
            f"{what} {k}: {int(bad.sum())}/{bad.size} components differ; "
            f"max rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("impl", IMPLS + MORE_IMPLS)
@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_sharded_run_matches_jax(comm, impl, p):
    """Every sharded impl, each under the ring (the N3L ring for the
    pair-symmetric ladder, the one-sided ring for the rest) and the
    all-gather, 2 steps against JAX's ``run_steps_sharded`` in interpret
    mode at the tier's tolerance (``TOLS``)."""
    n = 128 * p - 40
    arrs = arrays(n, seed=70 + p)
    got = run_steps_sharded(port_state(arrs), port_cfg(n, impl),
                            make_mesh(p, "cpu"), 2, impl=impl, comm=comm)
    want = jax_run(jax_state(arrs), jax_cfg(n, impl), jax_make_mesh(p), 2,
                   impl=impl, comm=comm)
    assert got.n == n
    assert_states_close(got, want, impl, f"{impl}/{comm}/P={p}")


@pytest.mark.parametrize("p", [3, 4])
@pytest.mark.parametrize("integrator", ["kdk", "yoshida4"])
def test_sharded_kdk_schemes_match_jax(integrator, p):
    """The KDK-composed schemes on the N3L ring, primed on the mesh."""
    n, impl = 128 * p - 40, "pallas_sym2"
    arrs = arrays(n, seed=80 + p)
    mesh = make_mesh(p, "cpu")
    cfg = port_cfg(n, impl, integrator)
    state = prime_kdk_sharded(port_state(arrs), cfg, mesh, impl=impl)
    got = run_steps_sharded(state, cfg, mesh, 2, impl=impl)
    jcfg, jmesh = jax_cfg(n, impl, integrator), jax_make_mesh(p)
    jstate = jax_prime(jax_state(arrs), jcfg, jmesh, impl=impl)
    want = jax_run(jstate, jcfg, jmesh, 2, impl=impl)
    assert_states_close(got, want, impl, f"{integrator}/P={p}")
    rpos, rvel, _ = oracle_run(*(arrs[i] for i in (0, 1, 3)), cfg.eps2,
                               cfg.dt, 2, integrator=integrator)
    assert relative_mismatch(got.pos.numpy(), rpos, 0.01, 1.0).sum() == 0


@pytest.mark.parametrize("impl", IMPLS + MORE_IMPLS)
@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_sharded_run_matches_single_device(comm, impl):
    """Three and four shards against the port's own one-device run (the
    exact impls, rel 1e-4 + 1e-6·max).  A sharded tier is a different
    sum: the all-gather and the antipodal rotation sweep one-sided, so the
    pair-symmetric tiers meet their one-sided twins there, and the
    correction groups by shard tiles.  So the tiers are held, one step in,
    to turbo's float64 gate (p99 < 5e-2, bad fraction < 0.1), the loosest
    of their gates."""
    n = 600
    arrs = arrays(n, seed=90)
    cfg = port_cfg(n, impl)
    exact = impl in ("xla", "pallas", "pallas_sym", "pallas_sym2",
                     "pallas_kahan")
    steps = 2 if exact else 1
    single = nt.run_steps(port_state(arrs), cfg, steps, impl=impl)
    ref = oracle_forces(arrs[0], arrs[3], cfg.eps2)
    for p in (3, 4):
        got = run_steps_sharded(port_state(arrs), cfg, make_mesh(p, "cpu"),
                                steps, impl=impl, comm=comm).acc.numpy()
        if exact:
            bad = relative_mismatch(got, single.acc.numpy(), 1e-4,
                                    1e-6 * single.acc.abs().max().item())
            assert bad.sum() == 0, (impl, comm, p)
        else:
            err = np.abs(got - ref) / (np.abs(ref) + 1e-30)
            assert np.percentile(err, 99) < 5e-2, (impl, comm, p)
            assert relative_mismatch(got, ref, 0.01, 1e-4).mean() < 0.1


@pytest.mark.parametrize("p", [3, 4, 5])
def test_n3l_ring_massless_bodies_match_float64(p):
    """Real massless bodies in several shards get their whole force on
    every rotation: the self shard (K2), the cross rotations (K2-rect,
    whose mass-scaled sums recompute such a row one-sided) and, for even
    P, the one-sided antipodal rotation."""
    n = 256 * p
    pos, _, mass = make_small_system(n, seed=95 + p)
    massless = [3, 256 + 7, n - 1, n - 200]
    mass[massless] = 0.0
    mesh = make_mesh(p, "cpu")
    cfg = port_cfg(n, "pallas_sym2")
    pos_l = list(torch.from_numpy(pos).chunk(p))
    mass_l = list(torch.from_numpy(mass).chunk(p))
    acc = torch.cat(_local_force_fn("pallas_sym2", "ring")(
        pos_l, mass_l, cfg, "pallas_sym2", LocalComm(mesh))).numpy()
    ref = oracle_forces(pos, mass, cfg.eps2)
    err = (np.linalg.norm(acc[massless] - ref[massless], axis=1)
           / np.linalg.norm(ref[massless], axis=1))
    assert (err < 1e-4).all(), err
    assert relative_mismatch(acc, ref, 1e-4, 1e-6 * np.abs(ref).max()
                             ).sum() == 0


def test_ring_launch_schedule_per_step():
    """Per step, the N3L ring on P shards makes P self sweeps, P (P-1)//2
    rect sweeps and, for even P, P one-sided antipodal sweeps (counted
    here through the twins' entry points)."""
    calls = {}
    import nbody_tpu_torch.parallel.ring as ring
    orig = (ring.forces_pallas_sym, ring.rect_forces_sym,
            ring._local_rect_forces)

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped
    try:
        ring.forces_pallas_sym = count("self", orig[0])
        ring.rect_forces_sym = count("rect", orig[1])
        ring._local_rect_forces = count("one_sided", orig[2])
        for p in (2, 3, 4, 5):
            calls.clear()
            n = 256 * p
            run_steps_sharded(port_state(arrays(n, seed=1)),
                              port_cfg(n, "pallas_sym2"),
                              make_mesh(p, "cpu"), 1, impl="pallas_sym2")
            want = {"self": p, "rect": p * ((p - 1) // 2),
                    "one_sided": p if p % 2 == 0 else 0}
            assert {k: calls.get(k, 0) for k in want} == want, p
    finally:
        ring.forces_pallas_sym, ring.rect_forces_sym, \
            ring._local_rect_forces = orig


def test_mesh_placement_and_comm():
    mesh = make_mesh(3, "cpu")
    assert mesh.size == 3 and SHARD_AXIS == JAX_SHARD_AXIS
    assert "3 shards" in mesh.describe() and "cpu" in mesh.describe()
    comm = LocalComm(mesh)
    vals = [torch.full((2,), float(i)) for i in range(3)]
    moved = comm.ppermute(vals, [(i, (i + 1) % 3) for i in range(3)])
    assert [float(v[0]) for v in moved] == [2.0, 0.0, 1.0]
    gathered = comm.all_gather(vals)
    assert all(torch.equal(g, torch.tensor([0., 0., 1., 1., 2., 2.]))
               for g in gathered)
    assert comm.axis_index() == [0, 1, 2] and comm.axis_size == 3
    state = port_state(arrays(12, seed=3))
    shards = shard_state(state, mesh)
    assert [s.n for s in shards] == [4, 4, 4]
    back = gather_state(shards)
    assert all(torch.equal(getattr(back, k), getattr(state, k))
               for k in ("pos", "vel", "acc", "mass"))
    with pytest.raises(ValueError, match="divisible"):
        shard_state(port_state(arrays(10, seed=3)), mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(2)


def test_shard_padding_is_whole_tiles():
    cfg = port_cfg(1000, "pallas_sym2")
    assert shard_padding(cfg, 3) == 1536
    assert shard_padding(cfg, 3) % (3 * forces_sym.SYM_TILE) == 0
    assert shard_padding(port_cfg(1024, "xla"), 4) == 1024


def test_simulation_on_a_mesh_and_resume(tmp_path, capsys):
    """``Simulation(mesh=)``: chunks, checkpoint cadence and a resume onto
    the mesh give the uninterrupted sharded run bit for bit; forced
    resident on a mesh is refused."""
    n, p = 300, 3
    mesh = make_mesh(p, "cpu")
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2", device="cpu",
                       integrator="kdk", seed=4)
    state = nt.init_state(cfg)
    whole = nt.Simulation(cfg, state=state, mesh=mesh)
    whole.run(6, log_every=0)
    ck = str(tmp_path / "mesh.npz")
    first = nt.Simulation(cfg, state=state, mesh=mesh)
    first.run(4, log_every=0, checkpoint_path=ck, checkpoint_every=2)
    second = nt.Simulation.resume(ck, device="cpu", mesh=mesh)
    second.run(2, log_every=0)
    assert second.step_count == 6
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(second.state, k),
                           getattr(whole.state, k)), k
    with pytest.raises(ValueError, match="mesh"):
        nt.Simulation(nt.SimConfig(n_bodies=n, impl="pallas_sym2",
                                   resident=True, device="cpu"), mesh=mesh)


@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_cli_sharded_verbs(comm, tmp_path, capsys):
    base = ["--n", "300", "--shards", "3", "--comm", comm, "--impl",
            "pallas_sym2", "--device", "cpu"]
    rc = cli.main(["validate", "--long-steps", "4", *base])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "mesh: 3 shards" in out and "Verification PASSED" in out
    ck = str(tmp_path / "c.npz")
    assert cli.main(["run", "--steps", "3", "--energy", "--checkpoint", ck,
                     *base]) == 0
    out = capsys.readouterr().out
    assert out.index("mesh: 3 shards") < out.index("nbody_tpu_torch: N=300")
    assert "energy drift" in out
    traj = str(tmp_path / "t.npz")
    assert cli.main(["run", "--steps", "4", "--save-trajectory", traj,
                     "--snap-every", "2", *base]) == 0
    snaps = np.load(traj)
    assert int(np.ravel(snaps["n_snaps"])[0]) == 2
    assert snaps["snap_000001"].shape == (300, 3)
    capsys.readouterr()
    assert cli.main(["bench", "--steps", "2", *base]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["shards"] == 3 and res["comm"] == comm
    assert res["resident"] is False and res["finite"]


@pytest.mark.parametrize("comm", ["rdma", "rdma_overlap"])
def test_cli_runs_rdma_and_refuses_analytic_with_shards(comm, capsys):
    """Every verb runs the fused ring K13 (its twin on the CPU) under
    both rdma comms, auto resolving to pallas_sym2; ``--analytic`` with
    shards stays refused."""
    for verb in (["run", "--steps", "1"], ["validate", "--steps", "2",
                                           "--long-steps", "2"],
                 ["bench", "--steps", "1", "--trials", "1"]):
        assert cli.main([*verb, "--n", "64", "--shards", "2", "--comm", comm,
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "pallas_sym2" in out, out
    assert cli.main(["validate", "--n", "64", "--shards", "2", "--analytic",
                     "--device", "cpu"]) == 2
    assert "single-device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="rdma"):
        run_steps_sharded(port_state(arrays(64, seed=0)),
                          port_cfg(64, "xla"), make_mesh(2, "cpu"), 1,
                          impl="xla", comm=comm)
