"""The fused ring K13 (``parallel/rdma_ring.py``, ``comm="rdma"`` and
``"rdma_overlap"``) on a CPU mesh: its plain twin, which the CPU runs,
against the JAX package's ``run_steps_sharded(..., comm="rdma" |
"rdma_overlap")`` (its ring kernel in interpret mode on P of the 8
virtual CPU devices), against the float64 oracle, and its routing.

Both packages start from the same seeded numpy arrays.  The JAX config
uses ``block_i = block_j = block_u = 256``: its shards are then padded as
the port's (N to a multiple of 256 P) and its ring tiles are the port's
256 x 256 tiles.  N = 128 P - 40 keeps at most 128 real bodies a device
(the conftest's envelope for interpret-mode Pallas) and puts ghosts in the
last shards.  Tolerance, per component of pos, vel and acc after the
steps: rel 1e-4 + 1e-6·max for the exact impls, rel 1e-3 + 1e-4·max for
the tensor-core tiers (their twins' tolerance against JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu import cli as jax_cli
from nbody_tpu.oracle.numpy_oracle import oracle_forces, relative_mismatch
from nbody_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nbody_tpu.parallel.ring import prime_kdk_sharded as jax_prime
from nbody_tpu.parallel.ring import run_steps_sharded as jax_run
from nbody_tpu_torch import cli
from nbody_tpu_torch.parallel import rdma_ring
from nbody_tpu_torch.parallel.mesh import make_mesh
from nbody_tpu_torch.parallel.ring import (LocalComm, prime_kdk_sharded,
                                           run_steps_sharded)

TC_IMPLS = ("pallas_sym_turbo", "pallas_sym_turbo2", "pallas_sym_mxu",
            "pallas_turbo")
# The seven impls K13 takes, each at the shard counts it is held at.
MATRIX = [("pallas_sym2", p) for p in (1, 2, 3, 4, 5)] \
    + [("pallas_sym", p) for p in (2, 3, 4, 5)] \
    + [("pallas_sym_turbo", p) for p in (1, 3, 4)] \
    + [("pallas_sym_turbo2", p) for p in (2, 3, 5)] \
    + [("pallas_sym_mxu", p) for p in (3, 4)] \
    + [("pallas", p) for p in (1, 2, 3, 5)] \
    + [("pallas_turbo", p) for p in (2, 3, 4, 5)]


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
                        block_i=256, block_j=256, block_u=256, chunk=64)


def port_cfg(n, impl, integrator="reference", **kw):
    return nt.SimConfig(n_bodies=n, impl=impl, integrator=integrator,
                        chunk=64, device="cpu", **kw)


def assert_close(got, want, impl, what):
    rel, floor = (1e-3, 1e-4) if impl in TC_IMPLS else (1e-4, 1e-6)
    got, want = np.asarray(got), np.asarray(want)
    bad = relative_mismatch(got, want, rel, floor * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max rel "
        f"{np.abs(got - want).max() / np.abs(want).max():.3e}")


def assert_states_close(port_out, jax_out, impl, what):
    for k in ("pos", "vel", "acc"):
        assert_close(getattr(port_out, k).numpy(), getattr(jax_out, k),
                     impl, f"{what} {k}")


def run_both(impl, p, comm, n=None, steps=2, seed=None):
    n = n or 128 * p - 40
    arrs = arrays(n, seed=seed or 90 + p)
    got = run_steps_sharded(port_state(arrs), port_cfg(n, impl),
                            make_mesh(p, "cpu"), steps, impl=impl, comm=comm)
    want = jax_run(jax_state(arrs), jax_cfg(n, impl), jax_make_mesh(p),
                   steps, impl=impl, comm=comm)
    assert got.n == n
    return got, want


@pytest.mark.parametrize("impl,p", MATRIX)
def test_rdma_twin_matches_jax(impl, p):
    got, want = run_both(impl, p, "rdma")
    assert_states_close(got, want, impl, f"{impl}/rdma/P={p}")


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_rdma_overlap_matches_jax(p):
    impl = "pallas_sym_turbo2" if p == 5 else "pallas_sym2"
    got, want = run_both(impl, p, "rdma_overlap")
    assert_states_close(got, want, impl, f"{impl}/rdma_overlap/P={p}")


def test_rdma_overlap_repeats_bit_for_bit_near_sequential():
    """Shards of two tiles each, where the overlap protocol's travel sum,
    t + (0 + aj_0 + aj_1), associates otherwise than the sequential
    (t + aj_0) + aj_1: the same result at rounding, bit for bit from run
    to run."""
    p, n = 5, 5 * 512
    pos, _, mass = make_small_system(n, seed=95)
    pos, mass = torch.from_numpy(pos), torch.from_numpy(mass)
    for variant in ("vpu2", "turbo2"):
        seq = rdma_ring.rdma_ring(pos, mass, p, 0.002, variant)
        ovl = rdma_ring.rdma_ring(pos, mass, p, 0.002, variant,
                                  overlap=True)
        assert torch.equal(ovl, rdma_ring.rdma_ring(pos, mass, p, 0.002,
                                                    variant, overlap=True))
        assert not torch.equal(ovl, seq)
        assert_close(ovl.numpy(), seq.numpy(), "pallas_sym2",
                     f"{variant}: overlap vs sequential")


@pytest.mark.parametrize("comm", ["rdma", "rdma_overlap"])
def test_rdma_padded_two_tile_shards_match_jax(comm):
    """N = 1496 on 3 shards: two 256-body tiles a shard, ghosts in the
    last, so the row sums run over two column tiles and the travel rows
    over two row tiles."""
    got, want = run_both("pallas_sym2", 3, comm, n=3 * 512 - 40, steps=1)
    assert_states_close(got, want, "pallas_sym2", f"two-tile {comm}")


def test_rdma_kdk_matches_jax():
    """KDK primed on the mesh through K13, then two steps."""
    p, impl = 3, "pallas_sym2"
    n = 128 * p - 40
    arrs = arrays(n, seed=97)
    mesh = make_mesh(p, "cpu")
    cfg = port_cfg(n, impl, "kdk")
    state = prime_kdk_sharded(port_state(arrs), cfg, mesh, impl=impl,
                              comm="rdma")
    got = run_steps_sharded(state, cfg, mesh, 2, impl=impl, comm="rdma")
    jcfg, jmesh = jax_cfg(n, impl, "kdk"), jax_make_mesh(p)
    jstate = jax_prime(jax_state(arrs), jcfg, jmesh, impl=impl, comm="rdma")
    want = jax_run(jstate, jcfg, jmesh, 2, impl=impl, comm="rdma")
    assert_states_close(got, want, impl, "kdk/rdma")


def test_rdma_block_flags_do_not_change_tiles(capsys):
    """``--block-u 48`` (JAX clamps its blocks to a divisor of the shard
    there) is accepted and gives the default run's result bit for bit."""
    n, p = 472, 4
    arrs = arrays(n, seed=98)
    mesh = make_mesh(p, "cpu")
    base = run_steps_sharded(port_state(arrs), port_cfg(n, "pallas_sym"),
                             mesh, 1, impl="pallas_sym", comm="rdma")
    odd = run_steps_sharded(port_state(arrs),
                            port_cfg(n, "pallas_sym", block_u=48,
                                     block_i=40), mesh, 1,
                            impl="pallas_sym", comm="rdma")
    assert all(torch.equal(getattr(base, k), getattr(odd, k))
               for k in ("pos", "vel", "acc"))
    assert cli.main(["run", "--n", str(n), "--steps", "1", "--shards",
                     str(p), "--comm", "rdma", "--block-u", "48",
                     "--device", "cpu", "--quiet"]) == 0


@pytest.mark.parametrize("impl", ["xla", "pallas_kahan", "pallas_mxu",
                                  "pallas_fast"])
def test_rdma_rejects_unsupported_impls(impl):
    arrs = arrays(472, seed=99)
    for comm in ("rdma", "rdma_overlap"):
        with pytest.raises(ValueError, match="rdma"):
            run_steps_sharded(port_state(arrs), port_cfg(472, impl),
                              make_mesh(4, "cpu"), 1, impl=impl, comm=comm)


def test_validate_rdma_overlap_auto_exits_0(capsys):
    """auto resolves to pallas_sym2 under both rdma comms; JAX's
    ``cli.py:398`` asks for the sym tier under ``rdma`` only, so its
    validate refuses ``rdma_overlap`` with auto (ROADMAP Queue 3)."""
    argv = ["validate", "--n", "472", "--shards", "4", "--comm",
            "rdma_overlap", "--steps", "2", "--long-steps", "0"]
    assert cli.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "impl=pallas_sym2" in out and "Verification PASSED" in out
    with pytest.raises(ValueError, match="rdma"):
        jax_cli.main(argv)


@pytest.mark.parametrize("comm", ["rdma", "rdma_overlap"])
def test_rdma_real_massless_bodies_match_the_oracle(comm):
    """Real bodies of mass 0 under pallas_sym2 get their rows recomputed
    one-sided over every body: the float64 oracle's acceleration at the
    exact tolerance, where JAX's K13 descales them to exactly 0."""
    p, n = 3, 344
    pos, vel, acc, mass = arrays(n, seed=100)
    zero = [3, 130, 300]
    mass[zero] = 0.0
    arrs = (pos, vel, acc, mass)
    cfg = port_cfg(n, "pallas_sym2", "kdk")
    got = prime_kdk_sharded(port_state(arrs), cfg, make_mesh(p, "cpu"),
                            impl="pallas_sym2", comm=comm).acc.numpy()
    ref = oracle_forces(pos, mass, cfg.eps2)
    assert_close(got[zero], ref[zero], "pallas_sym2", "massless rows")
    assert_close(got, ref, "pallas_sym2", "every row")
    want = np.asarray(jax_prime(jax_state(arrs),
                                jax_cfg(n, "pallas_sym2", "kdk"),
                                jax_make_mesh(p), impl="pallas_sym2",
                                comm=comm).acc)
    assert np.all(want[zero] == 0.0)
    assert np.abs(ref[zero]).min() > 0.0


def test_rdma_twin_contract():
    """The wrapper's checks, the chunk arithmetic and the phase counts."""
    pos, _, mass = make_small_system(512, seed=101)
    pos, mass = torch.from_numpy(pos), torch.from_numpy(mass)
    with pytest.raises(ValueError, match="whole 256-body tiles"):
        rdma_ring.rdma_ring(pos[:500], mass[:500], 2, 0.002, "vpu2")
    with pytest.raises(ValueError, match="one-sided family"):
        rdma_ring.rdma_ring(pos, mass, 2, 0.002, "vpu2", one_sided=True)
    with pytest.raises(ValueError, match="variant"):
        rdma_ring.rdma_ring(pos, mass, 2, 0.002, "turbof")
    with pytest.raises(ValueError, match="float32"):
        rdma_ring.rdma_ring(pos.double(), mass.double(), 2, 0.002, "vpu")
    assert rdma_ring.ring_chunk(4, 1 << 18) == 85
    assert rdma_ring.ring_chunk(4, 2048) == 8
    assert rdma_ring.ring_chunk(4, 2048, budget=2 * 4 * 2048 * 12) == 1
    with pytest.raises(ValueError, match="budget"):
        rdma_ring.ring_chunk(4, 2048, budget=1024)
    assert [rdma_ring.ring_phases(p, False) for p in (1, 2, 3, 4, 5, 8)] \
        == [(0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (3, 4)]
    assert rdma_ring.ring_phases(5, True) == (0, 4)
    assert rdma_ring.rdma_variant("pallas_turbo") == ("turbo", True)
    assert rdma_ring.rdma_variant("pallas_sym_mxu") == ("mxu", False)
    # Shards that are not all on CUDA cards (nor all on the CPU) are
    # refused, never swept by another ring.
    meta = [torch.empty(256, 3, device="meta"), torch.empty(256, 3)]
    with pytest.raises(ValueError, match="all lie on CUDA cards"):
        rdma_ring.rdma_forces_local(meta, [torch.empty(256)] * 2,
                                    port_cfg(512, "pallas_sym2"),
                                    "pallas_sym2",
                                    LocalComm(make_mesh(2, "cpu")))
